"""Execution core of the Monte Carlo engine (port of `repro.core.mc.exec`).

`run_core` is the counterpart of the reference's `_mc_core_impl`: C sweep
rows × S seeds × `steps` slots. Where the reference nests
`vmap(rows) ∘ vmap(seeds) ∘ lax.scan(steps)`, the port lays all
trajectories on one flat batch axis B = C·S (trajectory b = c·S + s), keeps
every tensor `(B, …)` on the device, and steps a Python loop — one OTA
kernel launch per step covers all B trajectories of an OTA slot.

Mixed rows: where the reference switches per row on the algorithm
(`lax.switch`), the port groups rows by slot function. gbma, momentum and
nesterov share `_gbma_slot` and differ only in the per-row (gamma, nest)
carry, so they stay one group. The rows are put in group order once,
before the loop, so each group's trajectories are one contiguous slice
of every `(B, …)` tensor; each step runs every group's slot on its slice
with its trajectories' own keys and concatenates the updates. The order
is undone once, after the loop. Keys depend on the seed only, so no
stream shifts.

Randomness: trajectory b starts from `key(seed0 + s)`, its step keys are
`split(key, steps)`, and step t splits its key into (k_h, k_w) for the
gains and the edge noise — exactly the reference's streams. The
reference's 'hoisted' plan materializes the `(steps, …)` draws of those
same keys before its scan and its 'inscan' plan draws them inside; the
streams are identical by design (`repro/core/mc/exec.py`, module
docstring). The port draws per step, which keeps device memory at
O(B·N) instead of O(B·steps·N). Participation draws a `(N_max,)` uniform
per step from `split(fold_in(key, 0x70617274), steps)`, the reference's
disjoint stream.

Seed reduction: `keep_seed_curves=False` reduces the `(C, S, steps+1)`
curves to (mean, ci95) on the device with exact two-pass moments
(`_mc_stats`); only `(C, steps+1)` statistics leave the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.core.mc.slots import ALGO_REGISTRY, SlotCtx

# fold_in constant of the per-step node-participation stream (b"part"),
# disjoint from the slot keys
_PART_STREAM = 0x70617274


def _slot_groups(algos: tuple) -> tuple:
    """Rows grouped by slot function, groups in order of first appearance:
    -> (row order (C,), [(slot_fn, first row, end row) in that order])."""
    fns = [ALGO_REGISTRY[a].slot_fn for a in algos]
    distinct = list(dict.fromkeys(fns))
    order = sorted(range(len(algos)), key=lambda c: distinct.index(fns[c]))
    groups, lo = [], 0
    for fn in distinct:
        hi = lo + fns.count(fn)
        groups.append((fn, lo, hi))
        lo = hi
    return np.asarray(order), groups


def run_core(params: dict, betas: torch.Tensor, theta0: torch.Tensor,
             seed_ints: np.ndarray, data: dict, *, grad_fn, risk_fn,
             algos: tuple, fading: str, steps: int, n_sizes: tuple,
             invert_channel: bool = False, h_min: float = 0.3,
             ota_impl: str = "auto", phase_zero: bool = False,
             reduce_moments: bool = False):
    """Run C rows × S seeds × `steps` slots, row c under `algos[c]`.

    params: per-row `(C,)` tensors (channel scalars, n_nodes, gamma,
    nest, and `participation` when some row drops nodes); betas `(C,)`;
    theta0 `(d,)`; data: the stacked problem data (`(C, …)` leaves, mask
    `(C, N_max)`), all on one device. `n_sizes` are the call's distinct
    node counts.

    Step order, as in the reference's scan body: the gradient at the
    Nesterov lookahead θ − nest·β·γ·m, the risk of θ BEFORE the update,
    the participation mask on the transmission x, the cumulative energy
    E_N·Σ‖x‖², the slot on x, then m ← γm + v and θ ← θ − βm; the final
    θ's risk is appended.

    Returns per-seed `(risks (C, S, steps+1), cum_energy (C, S, steps))`,
    or `(mean, ci95)` of shape `(C, steps+1)` when `reduce_moments`.
    """
    n_rows, n_seeds = betas.shape[0], len(seed_ints)
    batch = n_rows * n_seeds
    device = betas.device
    dim = theta0.shape[0]
    n_max = data["mask"].shape[1]

    order, groups = _slot_groups(algos)
    permuted = bool(np.any(order != np.arange(n_rows)))
    if permuted:  # group order, once: each group is one contiguous slice
        idx = torch.as_tensor(order, device=device)
        params = {k: v[idx] for k, v in params.items()}
        betas = betas[idx]
        data = {k: v[idx] for k, v in data.items()}

    # per-trajectory (B,) views of the per-row params: b = c·S + s
    p = {k: v.repeat_interleave(n_seeds) for k, v in params.items()}
    beta = betas.repeat_interleave(n_seeds)
    ctx = SlotCtx(fading=fading, p=p,
                  mask=data["mask"].repeat_interleave(n_seeds, dim=0),
                  counts=p["n_nodes"].to(torch.int64), n_sizes=n_sizes,
                  invert_channel=invert_channel, h_min=h_min,
                  ota_impl=ota_impl, phase_zero=phase_zero)
    spans = [(fn, lo * n_seeds, hi * n_seeds) for fn, lo, hi in groups]
    group_ctx = [dataclasses.replace(
        ctx, p={k: v[lo:hi] for k, v in p.items()}, mask=ctx.mask[lo:hi],
        counts=ctx.counts[lo:hi]) for _, lo, hi in spans]
    seeds = torch.as_tensor(np.asarray(seed_ints, np.int64), device=device)
    keys = rng.key(seeds.repeat(n_rows))
    step_keys = rng.split(keys, steps)  # (B, T, 2)
    part = p.get("participation")
    part_keys: Optional[torch.Tensor] = None
    if part is not None:
        part_keys = rng.split(rng.fold_in(keys, _PART_STREAM), steps)

    theta = theta0.to(torch.float32).expand(batch, dim).clone()
    m = torch.zeros_like(theta)
    cum_e = torch.zeros(batch, dtype=torch.float32, device=device)
    risks = torch.empty((batch, steps + 1), dtype=torch.float32,
                        device=device)
    cum_curve = torch.empty((batch, steps), dtype=torch.float32,
                            device=device)
    lookahead = (p["nest"] * beta * p["gamma"])[:, None]

    def grid(t: torch.Tensor) -> torch.Tensor:
        return t.view(n_rows, n_seeds, dim)

    for t in range(steps):
        theta_eval = theta - lookahead * m
        x = grad_fn(data, grid(theta_eval)).reshape(batch, n_max, dim)
        risks[:, t] = risk_fn(data, grid(theta)).reshape(batch)
        if part_keys is not None:
            # a dropped node transmits nothing this slot and spends no
            # energy; the edge still divides by the full N
            u = rng.uniform(part_keys[:, t], (n_max,))
            x = (u < part[:, None]).to(torch.float32)[:, :, None] * x
        cum_e = cum_e + p["energy"] * (x * x).sum(dim=(1, 2))
        cum_curve[:, t] = cum_e
        k_t = step_keys[:, t]
        if len(spans) == 1:
            v = spans[0][0](x, k_t, ctx)
        else:
            v = torch.cat([fn(x[lo:hi], k_t[lo:hi], gctx)
                           for (fn, lo, hi), gctx in zip(spans, group_ctx)])
        m = p["gamma"][:, None] * m + v
        theta = theta - beta[:, None] * m
    risks[:, steps] = risk_fn(data, grid(theta)).reshape(batch)

    risks = risks.view(n_rows, n_seeds, steps + 1)
    cum_curve = cum_curve.view(n_rows, n_seeds, steps)
    if permuted:  # back to the caller's row order
        inv = torch.as_tensor(np.argsort(order), device=device)
        risks, cum_curve = risks[inv], cum_curve[inv]
    if reduce_moments:
        return _mc_stats(risks)
    return risks, cum_curve


def _mc_stats(risks: torch.Tensor) -> tuple:
    """On-device seed reduction of `(C, S, steps+1)` curves: exact
    two-pass mean and 1.96·std(ddof=1)/√S — the formula of
    `host_seed_stats`, so both paths agree."""
    n = risks.shape[1]
    mean = risks.mean(dim=1)
    if n > 1:
        m2 = (risks - mean[:, None, :]).square().sum(dim=1)
        ci95 = 1.96 * torch.sqrt(m2 / (n - 1)) / math.sqrt(n)
    else:
        ci95 = torch.zeros_like(mean)
    return mean, ci95


def host_seed_stats(risks: np.ndarray) -> tuple:
    """(C, S, steps+1) curves -> (mean, ci95), the host-side seed
    reduction (the reference's definition)."""
    seeds = risks.shape[1]
    mean = np.mean(risks, axis=1)
    if seeds > 1:
        ci95 = 1.96 * np.std(risks, axis=1, ddof=1) / np.sqrt(seeds)
    else:
        ci95 = np.zeros_like(mean)
    return mean, ci95
