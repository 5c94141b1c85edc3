"""Execution plans (port of `repro.core.mc.plan`).

HOW a sweep executes is one explicit record, an `ExecPlan`: the RNG
plan, the seed chunk, the seed and row placement, whether per-seed
curves come back, the OTA route and the chunk retry policy. `run_mc`
takes one (`plan=`), derives one (`plan="auto"`: `auto_plan` sizes the
seed chunk with the memory model `exec.estimate_peak_bytes` against a
per-device budget), or builds the equivalent one from its legacy knobs
(`rng_plan`, `seed_chunk`, `keep_seed_curves`, `ota_impl`,
`shard_seeds`).

A port call runs on the one device it is given, so the device count is
1: a plan that places seeds or rows over two or more devices raises
`NotImplementedError` naming ROADMAP M8 (multi-GPU placement), as does
`auto_plan(cost_model="measured")`, whose calibrated cost model M8 also
brings.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device

# The CI-class memory budget the scheduler is sized against: the
# fallback where the device reports no memory size (the CPU).
DEFAULT_MEMORY_BUDGET_BYTES = 2 * 2**30
# Per-device working-set target for chunk sizing: the reference's
# cache-resident regime (its `large_chunked` benchmark entry, ~100 MiB at
# the hand-tuned chunk of 32), big enough to amortize per-chunk dispatch.
DEFAULT_CHUNK_TARGET_BYTES = 128 * 2**20

_PLACEMENT = "ROADMAP M8: multi-GPU placement"


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
                device, k >= 2 = k devices (not ported: M8).
    row_shards: sweep-row placement (1; k >= 2 is not ported: M8).
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
    """The seed mesh size of this call: 0 = no seed placement, the only
    value a port call runs with. `n_shards=None` keeps the reference's
    auto rule (every device when the live seed count divides, which on
    one device is none); a plan that places seeds or rows over two or
    more devices raises `NotImplementedError`."""
    s_live = plan.seed_chunk if plan.seed_chunk is not None else seeds
    ndev = 1 if device_count is None else int(device_count)
    if plan.n_shards is None:
        n_sh = ndev if (ndev > 1 and s_live % ndev == 0) else 0
    else:
        n_sh = 0 if int(plan.n_shards) <= 1 else int(plan.n_shards)
    if n_sh > 1 or plan.row_shards > 1:
        raise NotImplementedError(
            f"placing seeds over {n_sh or 1} x rows over {plan.row_shards} "
            f"devices is not ported yet ({_PLACEMENT})")
    return 0


def device_memory_budget_bytes(device: DeviceLike = None) -> int:
    """Per-device memory budget: 80 % of a CUDA device's total memory (the
    reference takes 80 % of the backend's `bytes_limit`); on the CPU the
    CI-class default. `device=None` is the CUDA card."""
    dev = resolve_device(device)
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
              device: DeviceLike = None) -> ExecPlan:
    """Derive an `ExecPlan` from the workload, the memory model and the
    device count (1 unless given), as the reference's analytic rule
    does; every returned field is concrete.

    Placement: `gcd(seeds, device_count)` seed shards, the row axis the
    largest divisor of `n_rows` fitting the remaining devices (a plan
    with two or more shards does not run in the port: M8).

    Chunking: the sweep chunks when the all-live per-device estimate
    (`exec.estimate_peak_bytes`) exceeds `target_chunk_bytes` (default
    128 MiB); the chunk is the largest divisor of `seeds` (a multiple of
    the seed shards) whose estimate fits the target, else the smallest
    that fits `memory_budget_bytes` (default `device_memory_budget_bytes
    (device)`), else the smallest outright.

    `keep_seed_curves=None` resolves to False exactly when the plan
    chunks. `cost_model="measured"` (the reference's calibrated
    re-pricing of the chunk) is not ported yet.
    """
    from repro_torch.core.mc.exec import estimate_peak_bytes

    if cost_model not in ("analytic", "measured"):
        raise ValueError(
            f"cost_model must be 'analytic' or 'measured', "
            f"got {cost_model!r}")
    if cost_model == "measured":
        raise NotImplementedError(
            "cost_model='measured' is not ported yet (ROADMAP M8: the cost "
            "model and its cuda/1 calibration)")

    ndev = 1 if device_count is None else int(device_count)
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

    if keep_seed_curves is None:
        keep_seed_curves = seed_chunk is None
    return ExecPlan(
        rng_plan=rng_plan, seed_chunk=seed_chunk,
        n_shards=0 if n_sh <= 1 else n_sh, row_shards=max(row_sh, 1),
        keep_seed_curves=bool(keep_seed_curves), ota_impl=ota_impl)
