"""Execution plans (port of `repro.core.mc.plan`).

HOW a sweep executes is one explicit record, an `ExecPlan`: the RNG
plan, the seed chunk, the seed and row placement, whether per-seed
curves come back, the OTA route and the chunk retry policy. `run_mc`
takes one (`plan=`), derives one (`plan="auto"`: `auto_plan` sizes the
seed chunk with the memory model `exec.estimate_peak_bytes` against a
per-device budget), or builds the equivalent one from its legacy knobs
(`rng_plan`, `seed_chunk`, `keep_seed_curves`, `ota_impl`,
`shard_seeds`).

Placement: a plan with `n_shards` or `row_shards` >= 2 lays the live
seeds and the sweep rows over a `(rows × mc)` mesh of devices
(`_device.mesh_devices`; `exec.run_core` runs one block per device, as
the reference's `shard_map` runs one shard). The devices are the call's
`device` list, or the visible cards; a list may name one device more
than once, so one card or the CPU runs a placed sweep block by block. A
plan over more devices than the call has raises the reference's
`ValueError`. `auto_plan(cost_model="measured")` re-prices the seed
chunk with the calibrated cost model (`costmodel`), as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import torch

from repro_torch._device import (MeshLike, primary_device,
                                 visible_device_count)

# The CI-class memory budget the scheduler is sized against: the
# fallback where the device reports no memory size (the CPU).
DEFAULT_MEMORY_BUDGET_BYTES = 2 * 2**30
# Per-device working-set target for chunk sizing: the reference's
# cache-resident regime (its `large_chunked` benchmark entry, ~100 MiB at
# the hand-tuned chunk of 32), big enough to amortize per-chunk dispatch.
DEFAULT_CHUNK_TARGET_BYTES = 128 * 2**20


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped-exponential-backoff retry budget for one seed chunk. A chunk
    that raises (an injected fault, an out-of-memory error, a failed
    launch) runs again up to `max_attempts` times in all, waiting
    `delay_s(attempt)` between attempts. Counter-based RNG makes the
    retried chunk replay its exact streams, so a sweep that survives k
    faults within budget equals the fault-free run bit for bit.

    max_attempts: total attempts per chunk (1 = no retry).
    base_delay_s: backoff before the 2nd attempt; doubles per attempt.
    cap_delay_s:  backoff ceiling.
    sleep:        injectable sleep callable (None = `time.sleep`).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    cap_delay_s: float = 2.0
    sleep: Optional[Callable] = None

    def delay_s(self, attempt: int) -> float:
        """Backoff after failed attempt number `attempt` (1-based)."""
        return min(self.cap_delay_s,
                   self.base_delay_s * 2 ** max(attempt - 1, 0))

    def wait(self, attempt: int) -> None:
        (self.sleep if self.sleep is not None else time.sleep)(
            self.delay_s(attempt))


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """One sweep's execution strategy.

    rng_plan:   'hoisted' (every random stream drawn for all steps before
                the step loop) or 'inscan' (drawn step by step); the
                streams are identical (`exec` module docstring).
    seed_chunk: run the seed axis in blocks of this size; None = all seeds
                live in one call. Must divide the seed count.
    n_shards:   seed placement over devices: None = auto (every visible
                device when the live seed count divides), 0 or 1 = one
                device, k >= 2 = k contiguous seed blocks on k devices.
    row_shards: sweep-row placement: k >= 2 = k contiguous row blocks,
                each over its own `max(n_shards, 1)` devices.
    keep_seed_curves: False reduces per-seed curves to (mean, ci95) on
                the device; Chan-merged moments under chunking.
    ota_impl:   'auto' | 'kernel' | 'ref', the route of the OTA slot
                (`repro_torch.kernels.ota.ota_edge_aggregate`).
    retry:      a `RetryPolicy` for each chunk of `exec.run_chunked`
                (None = fail fast).
    """

    rng_plan: str = "hoisted"
    seed_chunk: Optional[int] = None
    n_shards: Optional[int] = None
    row_shards: int = 1
    keep_seed_curves: bool = True
    ota_impl: str = "auto"
    retry: Optional[RetryPolicy] = None

    def replace(self, **kw) -> "ExecPlan":
        """A copy with the given fields swapped (frozen dataclass)."""
        return dataclasses.replace(self, **kw)

    def asdict(self) -> dict:
        """Plain-dict view; the retry policy's sleep callable is recorded
        by its qualname (or None)."""
        d = dataclasses.asdict(self)
        if d.get("retry") is not None and d["retry"].get("sleep") is not None:
            sleep = d["retry"]["sleep"]
            d["retry"]["sleep"] = getattr(sleep, "__qualname__", repr(sleep))
        return d


def validate_plan(plan: ExecPlan, *, seeds: int, n_rows: int) -> None:
    """Shape-level validation of a plan against one call's (seeds, rows)."""
    if plan.rng_plan not in ("hoisted", "inscan"):
        raise ValueError(
            f"rng_plan must be 'hoisted' or 'inscan', got {plan.rng_plan!r}")
    if plan.seed_chunk is not None:
        if plan.seed_chunk <= 0:
            raise ValueError(
                f"seed_chunk must be positive, got {plan.seed_chunk}")
        if seeds % plan.seed_chunk != 0:
            raise ValueError(
                f"seeds ({seeds}) must divide into seed_chunk "
                f"({plan.seed_chunk}) blocks — pad the seed count or pick "
                "a chunk that divides it")
    s_live = plan.seed_chunk if plan.seed_chunk is not None else seeds
    if plan.n_shards is not None and plan.n_shards > 1 \
            and s_live % plan.n_shards != 0:
        raise ValueError(
            f"n_shards={plan.n_shards} must divide the live seed count "
            f"({s_live} = seed_chunk or seeds)")
    if plan.row_shards < 1 or n_rows % plan.row_shards != 0:
        raise ValueError(
            f"row_shards={plan.row_shards} must be >= 1 and divide the "
            f"row count ({n_rows})")
    if plan.retry is not None:
        if plan.retry.max_attempts < 1:
            raise ValueError(
                f"retry.max_attempts must be >= 1, "
                f"got {plan.retry.max_attempts}")
        if plan.retry.base_delay_s < 0 or plan.retry.cap_delay_s < 0:
            raise ValueError(
                "retry delays must be nonnegative, got "
                f"base_delay_s={plan.retry.base_delay_s}, "
                f"cap_delay_s={plan.retry.cap_delay_s}")


def resolve_seed_shards(plan: ExecPlan, seeds: int,
                        device_count: Optional[int] = None) -> int:
    """The concrete 'mc' mesh size of this call: 0 = no seed placement.

    `n_shards=None` keeps the legacy auto rule (`shard_seeds=None`): every
    visible device when the live seed count divides evenly, else off.
    `device_count` is the call's (`_device.visible_device_count`; None:
    one device). A mesh of more seed × row shards than that raises the
    reference's error; the reference's own check passes a row mesh
    without seed shards (or under the auto rule) that its `make_mesh`
    then refuses, and this raises there too."""
    s_live = plan.seed_chunk if plan.seed_chunk is not None else seeds
    ndev = 1 if device_count is None else int(device_count)
    if plan.n_shards is None:
        n_sh = ndev if (ndev > 1 and s_live % ndev == 0) else 0
    else:
        n_sh = 0 if int(plan.n_shards) <= 1 else int(plan.n_shards)
    if max(n_sh, 1) * plan.row_shards > max(ndev, 1):
        raise ValueError(
            f"plan places {n_sh or 1} x {plan.row_shards} shards but only "
            f"{ndev} device(s) are visible — pass a device list (it may "
            "name one CUDA device or the CPU more than once), or shrink "
            "the plan")
    return n_sh


def device_memory_budget_bytes(device: MeshLike = None) -> int:
    """Per-device memory budget: 80 % of a CUDA device's total memory (the
    reference takes 80 % of the backend's `bytes_limit`); on the CPU the
    CI-class default. `device=None` is the CUDA card; of a device list,
    the first entry counts."""
    dev = primary_device(device)
    if dev.type == "cuda":
        return int(0.8 * torch.cuda.mem_get_info(dev)[1])
    return DEFAULT_MEMORY_BUDGET_BYTES


def _divisors_desc(n: int) -> list:
    ds = set()
    for i in range(1, int(math.isqrt(n)) + 1):
        if n % i == 0:
            ds.add(i)
            ds.add(n // i)
    return sorted(ds, reverse=True)


def auto_plan(*, n_rows: int, seeds: int, steps: int, n_max: int, dim: int,
              algo_set=("gbma",), n_antennas=None, m_sizes=(),
              b_max: int = 0, invert_channel: bool = False,
              participation_on: bool = False,
              keep_seed_curves: Optional[bool] = None,
              rng_plan: str = "hoisted", ota_impl: str = "auto",
              memory_budget_bytes: Optional[int] = None,
              target_chunk_bytes: Optional[int] = None,
              device_count: Optional[int] = None,
              cost_model: str = "analytic",
              calibration_path: Optional[str] = None,
              _model=None,
              device: MeshLike = None) -> ExecPlan:
    """Derive an `ExecPlan` from the workload, the memory model and the
    device count (`device_count`, else `visible_device_count(device)`),
    as the reference's analytic rule does; every returned field is
    concrete.

    Placement: `gcd(seeds, device_count)` seed shards, the row axis the
    largest divisor of `n_rows` fitting the remaining devices: the whole
    mesh is used whenever the axes divide.

    Chunking: the sweep chunks when the all-live per-device estimate
    (`exec.estimate_peak_bytes`) exceeds `target_chunk_bytes` (default
    128 MiB); the chunk is the largest divisor of `seeds` (a multiple of
    the seed shards) whose estimate fits the target, else the smallest
    that fits `memory_budget_bytes` (default `device_memory_budget_bytes
    (device)`), else the smallest outright.

    `keep_seed_curves=None` resolves to False exactly when the plan
    chunks.

    `cost_model="measured"` re-prices the chunk with the calibrated cost
    model (`costmodel.load_cost_model` for this device's platform and
    the device count): every shardable chunk that fits the memory budget
    is a candidate, ranked by `CostModel.predict_run_us`, and the choice
    leaves the analytic chunk only for a predicted win above 5 %. With
    no matching calibration entry the analytic path runs exactly.
    `_model` injects a `CostModel` (tests); `calibration_path` overrides
    the artifact's location.
    """
    from repro_torch.core.mc.exec import estimate_peak_bytes

    if cost_model not in ("analytic", "measured"):
        raise ValueError(
            f"cost_model must be 'analytic' or 'measured', "
            f"got {cost_model!r}")

    ndev = visible_device_count(device) if device_count is None \
        else int(device_count)
    budget = device_memory_budget_bytes(device) \
        if memory_budget_bytes is None else int(memory_budget_bytes)
    target = DEFAULT_CHUNK_TARGET_BYTES if target_chunk_bytes is None \
        else int(target_chunk_bytes)
    target = min(target, budget)

    n_sh = math.gcd(seeds, max(ndev, 1))
    row_sh = math.gcd(n_rows, max(ndev // max(n_sh, 1), 1))

    def per_device(chunk: Optional[int]) -> int:
        est = estimate_peak_bytes(
            n_rows=n_rows, seeds=seeds, steps=steps, n_max=n_max, dim=dim,
            algo_set=tuple(algo_set), seed_chunk=chunk,
            n_antennas=n_antennas, m_sizes=tuple(m_sizes), b_max=b_max,
            keep_seed_curves=False, rng_plan=rng_plan,
            invert_channel=invert_channel,
            participation_on=participation_on,
            n_shards=max(n_sh, 1), row_shards=max(row_sh, 1))
        return est["per_device_peak_bytes"]

    seed_chunk: Optional[int] = None
    if per_device(None) > target:
        fits_target = [c for c in _divisors_desc(seeds)
                       if c % max(n_sh, 1) == 0 and per_device(c) <= target]
        if fits_target:
            seed_chunk = fits_target[0]
        else:
            # nothing meets the cache target: the smallest shardable chunk
            # that fits the hard budget, or the smallest chunk outright
            candidates = [c for c in reversed(_divisors_desc(seeds))
                          if c % max(n_sh, 1) == 0]
            fits_budget = [c for c in candidates if per_device(c) <= budget]
            seed_chunk = (max(fits_budget) if fits_budget
                          else candidates[0])
        if seed_chunk >= seeds:
            seed_chunk = None  # chunking the full axis is the all-live call

    if cost_model == "measured":
        model = _model
        if model is None:
            from repro_torch.core.mc import costmodel

            model = costmodel.load_cost_model(
                calibration_path, device_count=ndev,
                device=primary_device(device))
        if model is not None:
            from repro_torch.core.mc.costmodel import Workload

            wl = Workload(n_rows=n_rows, seeds=seeds, steps=steps,
                          n_max=n_max, dim=dim, algo_set=tuple(algo_set),
                          m_sizes=tuple(m_sizes), b_max=b_max)

            def candidate(chunk: Optional[int]) -> ExecPlan:
                return ExecPlan(
                    rng_plan=rng_plan, seed_chunk=chunk,
                    n_shards=0 if n_sh <= 1 else n_sh,
                    row_shards=max(row_sh, 1),
                    keep_seed_curves=False, ota_impl=ota_impl)

            chunks = [None if c >= seeds else c
                      for c in _divisors_desc(seeds)
                      if c % max(n_sh, 1) == 0]
            fits = [c for c in chunks if per_device(c) <= budget]
            if fits:
                pred = {c: model.predict_run_us(candidate(c), wl,
                                                device_count=ndev)
                        for c in fits}
                best = min(fits, key=lambda c: (pred[c], -(c or seeds)))
                # conservative: keep the analytic chunk inside a 5 %
                # prediction band; deviate only for a clear win
                if seed_chunk in pred \
                        and pred[seed_chunk] <= 1.05 * pred[best]:
                    best = seed_chunk
                seed_chunk = best

    if keep_seed_curves is None:
        keep_seed_curves = seed_chunk is None
    return ExecPlan(
        rng_plan=rng_plan, seed_chunk=seed_chunk,
        n_shards=0 if n_sh <= 1 else n_sh, row_shards=max(row_sh, 1),
        keep_seed_curves=bool(keep_seed_curves), ota_impl=ota_impl)
