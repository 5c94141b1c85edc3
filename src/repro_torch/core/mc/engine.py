"""Monte Carlo engine: row assembly + the public entry point `run_mc`
(port of `repro.core.mc.engine`).

The paper's figures reproduce the expectation in Eq. (14) by averaging
excess-risk curves over seeds. A batch row is a (problem, channel, algo,
stepsize) tuple; `run_mc` stacks the rows and hands the sweep to
`exec.run_core`, which runs every (row, seed) trajectory as one batch on
the device. Arguments keep the reference's names.

The port covers single-antenna calls of `gbma`, `centralized`, `fdm`,
`power_control`, `momentum` and `nesterov` on quadratic problems, all
seeds live: rows may differ in node count (padded to N_max, one call),
in algorithm, and in node participation. Every argument or value outside
that raises `NotImplementedError` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.mc import exec as exec_mod
from repro_torch.core.mc.problems import MCProblem, MCProblemBatch
from repro_torch.core.mc.slots import ALGO_REGISTRY
from repro_torch.core.theory import ProblemConstants, theorem1_bound

# reference algorithms that are registered in `repro` but not ported yet
_P3 = "P3: antennas and MRC, with blind and blind_ec"
_LATER_ALGOS = {"blind": _P3, "blind_ec": _P3}
_OTA_IMPLS = ("auto", "kernel", "ref")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


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
                (None unless problem constants were given and every row
                is single-antenna gbma).
    device:     the device the sweep ran on.
    """

    risks: Optional[np.ndarray]
    mean: np.ndarray
    ci95: np.ndarray
    cum_energy: Optional[np.ndarray]
    bounds: Optional[np.ndarray]
    device: Optional[str] = None


def _is_scalar(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating))


def _reject_out_of_slice(*, n_antennas, power_budget, shard_seeds,
                         batch_frac, seed_chunk, rng_plan, plan, resume_dir,
                         memory_budget_bytes) -> None:
    if n_antennas is not None:
        raise _not_ported("n_antennas (multi-antenna edge, MRC)", _P3)
    if power_budget is not None:
        raise _not_ported("power_budget (blind_ec)", _P3)
    if shard_seeds:
        raise _not_ported("shard_seeds=True (seed placement)",
                          "M8: multi-GPU placement")
    fracs = (batch_frac,) if _is_scalar(batch_frac) else tuple(batch_frac)
    if any(float(f) != 1.0 for f in fracs):
        raise _not_ported(f"batch_frac={batch_frac} (stochastic minibatches)",
                          "P6: stochastic minibatches")
    if seed_chunk is not None:
        raise _not_ported("seed_chunk", "P8: seed_chunk, Chan merge and "
                          "resume")
    if resume_dir is not None:
        raise _not_ported("resume_dir", "P8: seed_chunk, Chan merge and "
                          "resume")
    if rng_plan is not None:
        raise _not_ported(f"rng_plan={rng_plan!r} (the port draws per step)",
                          "P9: execution plans")
    if plan is not None:
        raise _not_ported(f"plan={plan!r}", "P9: execution plans")
    if memory_budget_bytes is not None:
        raise _not_ported("memory_budget_bytes (plan='auto')",
                          "P9: execution plans")


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
    ota_impl: str = "auto",
    rng_plan: Optional[str] = None,
    seed_chunk: Optional[int] = None,
    keep_seed_curves: bool = True,
    plan: Optional[str] = None,
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

    `device`: None runs on the CUDA card and raises without one; pass
    `device="cpu"` for the CPU. The problem data moves to this device.

    `ota_impl`: the route of `kernels.ota.ota_edge_aggregate` — 'auto'
    (the CUDA kernel on the card, the plain version on the CPU), 'kernel'
    or 'ref' (the plain version on either device).
    `keep_seed_curves=False` reduces curves to (mean, ci95) on the device.
    The other arguments keep the reference's names; any value but their
    defaults is outside the port so far and raises `NotImplementedError`.
    """
    _reject_out_of_slice(
        n_antennas=n_antennas, power_budget=power_budget,
        shard_seeds=shard_seeds, batch_frac=batch_frac,
        seed_chunk=seed_chunk, rng_plan=rng_plan, plan=plan,
        resume_dir=resume_dir, memory_budget_bytes=memory_budget_bytes)
    if ota_impl not in _OTA_IMPLS:
        raise ValueError(f"ota_impl must be one of {_OTA_IMPLS}, got "
                         f"{ota_impl!r}")
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
        if a in _LATER_ALGOS:
            raise _not_ported(f"algo {a!r}", _LATER_ALGOS[a])
        if a not in ALGO_REGISTRY:
            raise ValueError(f"unknown algo {a!r}; expected one of "
                             f"{tuple(ALGO_REGISTRY)}")
    specs = [ALGO_REGISTRY[a] for a in algos]
    parts = (float(participation),) * n_rows if _is_scalar(participation) \
        else tuple(float(q) for q in participation)
    if len(parts) != n_rows:
        raise ValueError(f"need one participation per row: {len(parts)} "
                         f"vs C={n_rows}")
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

    dim = batch_prob.dim
    t0 = torch.zeros(dim, dtype=torch.float32, device=dev) if theta0 is None \
        else torch.as_tensor(np.asarray(theta0, np.float32), device=dev)
    seed_ints = np.arange(seed0, seed0 + seeds, dtype=np.int64)
    out = exec_mod.run_core(
        params, betas_t, t0, seed_ints, batch_prob.data,
        grad_fn=batch_prob.grad_fn, risk_fn=batch_prob.risk_fn,
        algos=algos, fading=ch_batch.fading, steps=steps, n_sizes=n_sizes,
        invert_channel=invert_channel, h_min=float(h_min),
        ota_impl=ota_impl, phase_zero=phase_zero,
        reduce_moments=not keep_seed_curves)
    if keep_seed_curves:
        risks, cum_e = (x.cpu().numpy() for x in out)
        mean, ci95 = exec_mod.host_seed_stats(risks)
    else:
        mean, ci95 = (x.cpu().numpy() for x in out)
        risks = cum_e = None

    bounds = None
    if pc is not None:
        pcs = [pc] * n_rows if isinstance(pc, ProblemConstants) else list(pc)
        if len(pcs) != n_rows:
            raise ValueError(f"need one ProblemConstants per row: "
                             f"{len(pcs)} vs C={n_rows}")
        if all(s.theorem1 for s in specs):
            ks = np.arange(1, steps + 2)
            bounds = np.stack([
                theorem1_bound(ks, float(b), row_pc, cfg, n)
                for b, cfg, row_pc, n in zip(
                    betas_t.cpu().numpy(), ch_batch.configs, pcs, n_nodes)])
    return MCResult(risks=risks, mean=mean.astype(np.float32),
                    ci95=ci95.astype(np.float32), cum_energy=cum_e,
                    bounds=bounds, device=str(dev))


def slice_result(res: MCResult, rows: Union[slice, Sequence[int]]
                 ) -> MCResult:
    """A per-row view of an `MCResult`: the given row slice (or index
    sequence) of every (C, ...) array, `None` leaves passed through."""
    idx = rows if isinstance(rows, slice) else list(rows)
    pick = lambda a: None if a is None else a[idx]
    return MCResult(risks=pick(res.risks), mean=pick(res.mean),
                    ci95=pick(res.ci95), cum_energy=pick(res.cum_energy),
                    bounds=pick(res.bounds), device=res.device)


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
