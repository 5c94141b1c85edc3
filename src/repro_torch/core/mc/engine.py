"""Monte Carlo engine: row assembly + the public entry point `run_mc`
(port of `repro.core.mc.engine`).

The paper's figures reproduce the expectation in Eq. (14) by averaging
excess-risk curves over seeds. A batch row is a (problem, channel, algo,
stepsize) tuple; `run_mc` stacks the rows and hands the sweep to
`exec.run_core`, which runs every (row, seed) trajectory as one batch on
the device. Arguments keep the reference's names.

The port covers `gbma`, `centralized`, `fdm`, `power_control`,
`momentum`, `nesterov`, `blind` and `blind_ec` on the `quadratic`,
`localization` and `logistic` problems: rows may differ in node count
(padded to N_max, one call), in algorithm, in node participation, in
antenna count, power budget and minibatch fraction. HOW a sweep runs is
one `plan.ExecPlan` (RNG plan, seed chunks with Chan-merged moments,
retry and resume), given, derived (`plan="auto"`) or built from the
legacy knobs, as in the reference. A call runs on one device: placement
over several (`n_shards` or `row_shards` >= 2) raises
`NotImplementedError` naming ROADMAP M8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.mc import exec as exec_mod
from repro_torch.core.mc.plan import (ExecPlan, auto_plan,
                                      resolve_seed_shards, validate_plan)
from repro_torch.core.mc.problems import MCProblem, MCProblemBatch
from repro_torch.core.mc.slots import ALGO_REGISTRY
from repro_torch.core.theory import ProblemConstants, theorem1_bound

_OTA_IMPLS = ("auto", "kernel", "ref")


@dataclasses.dataclass(frozen=True)
class ChannelBatch:
    """Stack of C `ChannelConfig`s sharing one fading family; every other
    field becomes a `(C,)` float32 tensor (on the CPU until `run_mc` moves
    it to its device)."""

    fading: str
    params: dict  # {'scale','noise_std','energy','phase_error_max','rician_k'}
    configs: tuple

    @classmethod
    def stack(cls, cfgs: Sequence[ChannelConfig]) -> "ChannelBatch":
        fams = {c.fading for c in cfgs}
        if len(fams) != 1:
            raise ValueError(
                f"one ChannelBatch = one fading family, got {sorted(fams)}; "
                "issue one run_mc call per family")
        arr = lambda name: torch.tensor(
            [getattr(c, name) for c in cfgs], dtype=torch.float32)
        return cls(fading=cfgs[0].fading,
                   params={name: arr(name) for name in (
                       "scale", "noise_std", "energy", "phase_error_max",
                       "rician_k")},
                   configs=tuple(cfgs))

    def __len__(self) -> int:
        return len(self.configs)


@dataclasses.dataclass
class MCResult:
    """Host-side result of one engine call (numpy arrays).

    risks:      (C, S, steps+1) per-seed excess-risk curves, or None under
                `keep_seed_curves=False`.
    mean:       (C, steps+1) seed average (the Eq. 14 estimate).
    ci95:       (C, steps+1) 1.96 · standard error over seeds (0 if S == 1).
    cum_energy: (C, S, steps) cumulative transmitted energy Σ E_N ‖x_k‖²,
                or None under `keep_seed_curves=False`.
    bounds:     (C, steps+1) Theorem-1 bound per row, at the row's own N
                (None unless problem constants were given, every row is
                gbma and no antenna setting was given).
    device:     the device the sweep ran on.
    plan:       the resolved `ExecPlan` the sweep ran under.
    """

    risks: Optional[np.ndarray]
    mean: np.ndarray
    ci95: np.ndarray
    cum_energy: Optional[np.ndarray]
    bounds: Optional[np.ndarray]
    device: Optional[str] = None
    plan: Optional[ExecPlan] = None


def _is_scalar(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating))


def _per_row(value, n_rows: int, name: str, cast=float) -> tuple:
    """A scalar broadcast to every row, or one value per row."""
    if _is_scalar(value):
        return (cast(value),) * n_rows
    values = tuple(cast(v) for v in value)
    if len(values) != n_rows:
        raise ValueError(f"need one {name} per row: {len(values)} vs "
                         f"C={n_rows}")
    return values


def _resolve_antennas(n_antennas, n_rows: int) -> tuple:
    """-> (static count or None, per-row counts or None)."""
    if n_antennas is None:
        return None, None
    static = isinstance(n_antennas, (int, np.integer))
    counts = _per_row(n_antennas, n_rows, "antenna count", int)
    if any(m < 1 for m in counts):
        raise ValueError(f"antenna counts must be >= 1: {n_antennas}")
    return (counts[0], None) if static else (None, counts)


def _resolve_batch_frac(batch_frac, n_rows: int,
                        batch_prob: MCProblemBatch):
    """-> `(sample_indices_row, stochastic_grad_from_idx, b_max)` and the
    per-row lane counts b = max(1, round(f·k)) for minibatches, or
    (None, None) for exact full-batch gradients (every fraction 1)."""
    fracs = _per_row(batch_frac, n_rows, "batch_frac")
    if any(not 0.0 < f <= 1.0 for f in fracs):
        raise ValueError(f"batch_frac must be in (0, 1], got {fracs}")
    if all(f == 1.0 for f in fracs):
        return None, None
    spec = batch_prob.spec
    if not batch_prob.stochastic or spec.sample_indices_row is None:
        raise ValueError(
            f"batch_frac={fracs} needs a stochastic problem kind (a "
            f"registered minibatch gradient); got kind={batch_prob.kind!r}")
    k = batch_prob.data[spec.sample_axis_field].shape[-2]
    b_counts = tuple(max(1, int(round(f * k))) for f in fracs)
    return ((spec.sample_indices_row, spec.stochastic_grad_from_idx,
             max(b_counts)), b_counts)


def run_mc(
    problem: Union[MCProblem, MCProblemBatch, Sequence[MCProblem]],
    channels: Union[Sequence[ChannelConfig], ChannelBatch],
    algo: Union[str, Sequence[str]],
    betas: Union[Sequence[float], np.ndarray],
    steps: int,
    seeds: int,
    *,
    theta0: Optional[np.ndarray] = None,
    seed0: int = 0,
    n_antennas=None,
    invert_channel: bool = False,
    h_min: float = 0.3,
    pc: Optional[Union[ProblemConstants, Sequence[ProblemConstants]]] = None,
    momentum: float = 0.9,
    power_budget=None,
    shard_seeds: Optional[bool] = None,
    batch_frac: Union[float, Sequence[float]] = 1.0,
    ota_impl: Optional[str] = None,
    rng_plan: Optional[str] = None,
    seed_chunk: Optional[int] = None,
    keep_seed_curves: Optional[bool] = None,
    plan: Union[ExecPlan, str, None] = None,
    resume_dir: Optional[str] = None,
    memory_budget_bytes: Optional[int] = None,
    participation: Union[float, Sequence[float]] = 1.0,
    device: DeviceLike = None,
) -> MCResult:
    """Run `seeds` Monte Carlo trajectories for each batch row.

    A row is a (problem, channel, algo, stepsize) tuple; `problem` and
    `algo` broadcast when a single one is given. A sequence of problems
    may differ in node count (they pad to N_max and each row keeps its
    own N) and a sequence of algos may mix them: either way one call.
    Seed s uses `key(seed0 + s)` — the reference's stream. With `pc` (one
    `ProblemConstants` or one per row) the Theorem-1 bound rides along
    when every row is 'gbma'.

    `invert_channel`: fdm rows equalize their gains. `h_min`:
    power_control's truncation threshold (the reference's default 0.3).
    `participation` (scalar or one per row, in (0, 1]): each step each
    node transmits with that probability and stays silent otherwise (no
    energy); the edge still divides by the full N.

    `n_antennas`: the edge antenna count M. An int is one M for every row
    (the OTA rows take the MRC path, 1 included, and average over M); a
    sequence gives one M per row, each row replaying `split(key, m)` for
    its own m. Required for `blind` / `blind_ec`. `power_budget` (scalar
    or one per row; default unbounded): the per-slot, per-node budget on
    the squared norm that `blind_ec` rows enforce, carrying the truncated
    rest in their residual. `batch_frac` (scalar or one per row, in
    (0, 1]): the fraction of each node's local samples drawn per slot
    for a stochastic problem (`logistic`), b = max(1, round(f·k)) lanes
    with replacement; 1.0 everywhere computes the exact full-batch
    gradient and draws nothing.

    `device`: None runs on the CUDA card and raises without one; pass
    `device="cpu"` for the CPU. The problem data moves to this device.

    `ota_impl` (None: 'auto'): the route of
    `kernels.ota.ota_edge_aggregate` — 'auto' (the CUDA kernel on the
    card, the plain version on the CPU), 'kernel' or 'ref' (the plain
    version on either device).

    Execution strategy: HOW the sweep runs is one `plan.ExecPlan`, as in
    the reference. `plan=` an `ExecPlan` pins every field; `plan="auto"`
    derives one with `plan.auto_plan` from the memory model and
    `memory_budget_bytes` (default 80 % of the card's memory, 2 GiB on
    the CPU); or leave `plan=None` and set the legacy knobs below, which
    build the equivalent plan. Mixing them with `plan=` raises. The
    resolved plan is `MCResult.plan`.

    `rng_plan` (None: 'hoisted'): 'hoisted' draws every random stream of
    a single-algorithm call for all steps before the step loop; 'inscan'
    draws them step by step. The streams are identical; hoisting needs
    O(B·steps·N) device memory for the draws (`exec` module docstring).

    `seed_chunk`: run the seeds in blocks of this size (it must divide
    `seeds`), so device memory scales with the chunk; None runs all seeds
    at once. `keep_seed_curves` (None: True): False reduces the per-seed
    curves to (mean, ci95) on the device (Chan-merged moments under
    chunking), and `risks` / `cum_energy` are None.

    `resume_dir`: a chunked reduced sweep (`seed_chunk` set,
    `keep_seed_curves=False`) checkpoints its chunk cursor and moments
    there after every chunk and resumes from them on the next call, bit
    for bit (`exec.run_chunked`). `shard_seeds`: seed placement; on the
    one device of a port call True and None place nothing.
    """
    if rng_plan is not None and rng_plan not in ("hoisted", "inscan"):
        raise ValueError(
            f"rng_plan must be 'hoisted' or 'inscan', got {rng_plan!r}")
    if plan is not None:
        clash = [name for name, v in (
            ("rng_plan", rng_plan), ("seed_chunk", seed_chunk),
            ("keep_seed_curves", keep_seed_curves),
            ("ota_impl", ota_impl), ("shard_seeds", shard_seeds))
            if v is not None]
        if clash:
            raise ValueError(
                f"plan= already pins the execution strategy; drop the "
                f"conflicting legacy knob(s) {clash} or encode them in "
                "the ExecPlan")
        if isinstance(plan, str) and plan != "auto":
            raise ValueError(
                f"plan must be an ExecPlan or the string 'auto', "
                f"got {plan!r}")
    if memory_budget_bytes is not None and plan != "auto":
        raise ValueError(
            "memory_budget_bytes only parameterizes plan='auto' — an "
            "explicit ExecPlan or the legacy knobs already fix the chunk "
            "size")
    if seeds < 1:
        raise ValueError(f"need seeds >= 1, got {seeds}")
    dev = resolve_device(device)

    ch_batch = channels if isinstance(channels, ChannelBatch) \
        else ChannelBatch.stack(list(channels))
    n_rows = len(ch_batch)
    betas_t = torch.as_tensor(np.asarray(betas, np.float32), device=dev)
    if tuple(betas_t.shape) != (n_rows,):
        raise ValueError(f"need one stepsize per row: "
                         f"{tuple(betas_t.shape)} vs C={n_rows}")
    algos = (algo,) * n_rows if isinstance(algo, str) else tuple(algo)
    if len(algos) != n_rows:
        raise ValueError(f"need one algo per row: {len(algos)} vs C={n_rows}")
    for a in algos:
        if a not in ALGO_REGISTRY:
            raise ValueError(f"unknown algo {a!r}; expected one of "
                             f"{tuple(ALGO_REGISTRY)}")
    specs = [ALGO_REGISTRY[a] for a in algos]
    m_static, m_per_row = _resolve_antennas(n_antennas, n_rows)
    antennas = m_static is not None or m_per_row is not None
    if any(s.blind for s in specs) and not antennas:
        raise ValueError(
            "blind/blind_ec need n_antennas (the edge antenna count M)")
    parts = _per_row(participation, n_rows, "participation")
    if any(not 0.0 < q <= 1.0 for q in parts):
        raise ValueError(f"participation must be in (0, 1], got {parts}")

    # ---- the problem axis: always the row formulation -------------------
    if isinstance(problem, MCProblemBatch):
        batch_prob = problem
    elif isinstance(problem, MCProblem):
        batch_prob = MCProblemBatch.stack([problem] * n_rows)
    else:
        probs = list(problem)
        if len(probs) == 1:
            probs = probs * n_rows
        if len(probs) != n_rows:
            raise ValueError(
                f"need one problem per row: {len(probs)} vs C={n_rows}")
        batch_prob = MCProblemBatch.stack(probs)
    if len(batch_prob) != n_rows:
        raise ValueError(f"need one problem per row: {len(batch_prob)} vs "
                         f"C={n_rows}")
    batch_prob = batch_prob.to(dev)
    n_nodes = batch_prob.n_nodes
    n_sizes = tuple(sorted(set(n_nodes)))
    # the gain draw skips its phase stream when every row's phase error
    # is 0: value-identical (cos(0) == 1, and the stream has its own key)
    phase_zero = all(float(c.phase_error_max) == 0.0
                     for c in ch_batch.configs)
    params = {k: v.to(dev) for k, v in ch_batch.params.items()}
    params["n_nodes"] = torch.tensor(n_nodes, dtype=torch.float32,
                                     device=dev)
    params["gamma"] = torch.tensor(
        [momentum if s.uses_gamma else 0.0 for s in specs],
        dtype=torch.float32, device=dev)
    params["nest"] = torch.tensor([1.0 if s.nesterov else 0.0 for s in specs],
                                  dtype=torch.float32, device=dev)
    if any(q < 1.0 for q in parts):  # p = 1 everywhere draws no mask
        params["participation"] = torch.tensor(parts, dtype=torch.float32,
                                               device=dev)
    if any(s.error_feedback for s in specs):
        budgets = _per_row(float("inf") if power_budget is None
                           else power_budget, n_rows, "power budget")
        params["ec"] = torch.tensor(
            [1.0 if s.error_feedback else 0.0 for s in specs],
            dtype=torch.float32, device=dev)
        params["tx_budget"] = torch.tensor(budgets, dtype=torch.float32,
                                           device=dev)
    if m_per_row is not None:
        params["n_antennas"] = torch.tensor(m_per_row, dtype=torch.float32,
                                            device=dev)
    stochastic, b_counts = _resolve_batch_frac(batch_frac, n_rows,
                                               batch_prob)
    if b_counts is not None:
        params["b_count"] = torch.tensor(b_counts, dtype=torch.int64,
                                         device=dev)

    dim = batch_prob.dim

    # ---- the execution plan: given, derived, or from the legacy knobs --
    if isinstance(plan, ExecPlan):
        eff_plan = plan
    elif plan == "auto":
        eff_plan = auto_plan(
            n_rows=n_rows, seeds=seeds, steps=steps, n_max=batch_prob.n_max,
            dim=dim, algo_set=tuple(dict.fromkeys(algos)),
            n_antennas=m_static,
            m_sizes=() if m_per_row is None else tuple(sorted(set(
                m_per_row))),
            b_max=0 if stochastic is None else stochastic[2],
            invert_channel=invert_channel,
            participation_on=any(q < 1.0 for q in parts),
            memory_budget_bytes=memory_budget_bytes, device=dev)
    else:
        # the reference's legacy rule: shard_seeds=True takes every
        # device, one on a port call, which places nothing
        eff_plan = ExecPlan(
            rng_plan="hoisted" if rng_plan is None else rng_plan,
            seed_chunk=seed_chunk,
            n_shards={None: None, False: 0, True: 1}[shard_seeds],
            keep_seed_curves=(True if keep_seed_curves is None
                              else keep_seed_curves),
            ota_impl="auto" if ota_impl is None else ota_impl)
    validate_plan(eff_plan, seeds=seeds, n_rows=n_rows)
    resolve_seed_shards(eff_plan, seeds)
    if resume_dir is not None and (eff_plan.seed_chunk is None
                                   or eff_plan.keep_seed_curves):
        raise ValueError(
            "resume_dir requires a chunked reduced sweep — a plan with "
            "seed_chunk set and keep_seed_curves=False (only the chunk "
            "cursor and moment accumulators are checkpointed)")
    if eff_plan.ota_impl not in _OTA_IMPLS:
        raise ValueError(f"ota_impl must be one of {_OTA_IMPLS}, got "
                         f"{eff_plan.ota_impl!r}")

    t0 = torch.zeros(dim, dtype=torch.float32, device=dev) if theta0 is None \
        else torch.as_tensor(np.asarray(theta0, np.float32), device=dev)
    seed_ints = np.arange(seed0, seed0 + seeds, dtype=np.int64)
    core_kwargs = dict(
        grad_fn=batch_prob.grad_fn, risk_fn=batch_prob.risk_fn,
        algos=algos, fading=ch_batch.fading, steps=steps, n_sizes=n_sizes,
        invert_channel=invert_channel, h_min=float(h_min),
        ota_impl=eff_plan.ota_impl, phase_zero=phase_zero,
        n_antennas=m_static, m_per_row=m_per_row, stochastic=stochastic,
        rng_plan=eff_plan.rng_plan)
    if eff_plan.seed_chunk is not None:
        risks, cum_e, mean, ci95 = exec_mod.run_chunked(
            params, betas_t, t0, seed_ints, batch_prob.data,
            seed_chunk=eff_plan.seed_chunk,
            keep_seed_curves=eff_plan.keep_seed_curves,
            core_kwargs=core_kwargs, resume_dir=resume_dir,
            retry=eff_plan.retry)
    elif eff_plan.keep_seed_curves:
        risks, cum_e = (x.cpu().numpy() for x in exec_mod.run_core(
            params, betas_t, t0, seed_ints, batch_prob.data, **core_kwargs))
        mean, ci95 = exec_mod.host_seed_stats(risks)
    else:
        mean, ci95 = (x.cpu().numpy() for x in exec_mod.device_seed_stats(
            *exec_mod.run_core(params, betas_t, t0, seed_ints,
                               batch_prob.data, reduce_moments=True,
                               **core_kwargs), seeds))
        risks = cum_e = None

    bounds = None
    if pc is not None:
        pcs = [pc] * n_rows if isinstance(pc, ProblemConstants) else list(pc)
        if len(pcs) != n_rows:
            raise ValueError(f"need one ProblemConstants per row: "
                             f"{len(pcs)} vs C={n_rows}")
        if all(s.theorem1 for s in specs) and not antennas:
            ks = np.arange(1, steps + 2)
            bounds = np.stack([
                theorem1_bound(ks, float(b), row_pc, cfg, n)
                for b, cfg, row_pc, n in zip(
                    betas_t.cpu().numpy(), ch_batch.configs, pcs, n_nodes)])
    return MCResult(risks=risks, mean=mean.astype(np.float32),
                    ci95=ci95.astype(np.float32), cum_energy=cum_e,
                    bounds=bounds, device=str(dev), plan=eff_plan)


def slice_result(res: MCResult, rows: Union[slice, Sequence[int]]
                 ) -> MCResult:
    """A per-row view of an `MCResult`: the given row slice (or index
    sequence) of every (C, ...) array, `None` leaves passed through; the
    device and plan (whole-call properties) ride along."""
    idx = rows if isinstance(rows, slice) else list(rows)
    pick = lambda a: None if a is None else a[idx]
    return MCResult(risks=pick(res.risks), mean=pick(res.mean),
                    ci95=pick(res.ci95), cum_energy=pick(res.cum_energy),
                    bounds=pick(res.bounds), device=res.device,
                    plan=res.plan)


def energy_to_target(res: MCResult, target: float) -> np.ndarray:
    """Per-row mean (over seeds) total transmitted energy until the risk
    curve first hits `target` (paper Fig. 6).

    risks[k] is the risk of θ_k, reached after k transmission slots, and
    cum_energy[j] is the energy of slots 1..j+1 — so a first hit at index
    k costs cum_energy[k-1], and a target already met at initialization
    (k == 0) costs nothing. Seeds that never hit spend the full-horizon
    energy.
    """
    if res.risks is None or res.cum_energy is None:
        raise ValueError(
            "energy_to_target needs per-seed curves — run with the default "
            "keep_seed_curves=True")
    c, s, kp1 = res.risks.shape
    hit_mask = res.risks <= target
    hit = np.argmax(hit_mask, axis=2)  # first True, 0 when none
    hit = np.where(hit_mask.any(axis=2), hit, kp1 - 1)
    ce = np.concatenate(
        [np.zeros((c, s, 1), res.cum_energy.dtype), res.cum_energy], axis=2)
    per_seed = np.take_along_axis(ce, hit[:, :, None], axis=2)[..., 0]
    return per_seed.mean(axis=1)
