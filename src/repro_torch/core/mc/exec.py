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
per step from `split(fold_in(key, 0x70617274), steps)`, and a stochastic
problem its minibatch indices from `split(fold_in(key, 0x64617461),
steps)`: the reference's disjoint streams.

Antennas: each slot group gets its own antenna axis, as long as the
largest count of its own rows (`slots.with_antennas`); in fig7 the gbma
group has M = 1 while the blind rows of the same call have 32 or 64.

Error feedback: when a row runs `blind_ec`, the loop carries a per-node
residual e `(B, N_max, d)`: rows with the flag transmit x = α(g + e),
α = min(1, √(budget / ‖g + e‖²)) per node, and keep e ← (g + e) − x
after participation masks x; every other row selects α = 1.

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
from repro_torch.core.mc.slots import ALGO_REGISTRY, SlotCtx, with_antennas

# fold_in constants of the per-step minibatch-index stream (b"data") and
# node-participation stream (b"part"), disjoint from the slot keys and
# from each other
_DATA_STREAM = 0x64617461
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


def _group_ctx(ctx: SlotCtx, lo: int, hi: int, n_antennas,
               m_per_row: Optional[tuple], n_seeds: int) -> SlotCtx:
    """The slot context of trajectories [lo, hi) (one slot group), with
    the group's own antenna setting: a static count, or the distinct
    per-row counts of the group's rows."""
    gctx = dataclasses.replace(
        ctx, p={k: v[lo:hi] for k, v in ctx.p.items()}, mask=ctx.mask[lo:hi],
        counts=ctx.counts[lo:hi])
    m_sizes = () if m_per_row is None else tuple(sorted(set(
        m_per_row[lo // n_seeds:hi // n_seeds])))
    return with_antennas(gctx, n_antennas, m_sizes)


def run_core(params: dict, betas: torch.Tensor, theta0: torch.Tensor,
             seed_ints: np.ndarray, data: dict, *, grad_fn, risk_fn,
             algos: tuple, fading: str, steps: int, n_sizes: tuple,
             invert_channel: bool = False, h_min: float = 0.3,
             ota_impl: str = "auto", phase_zero: bool = False,
             n_antennas: Optional[int] = None,
             m_per_row: Optional[tuple] = None, stochastic=None,
             reduce_moments: bool = False):
    """Run C rows × S seeds × `steps` slots, row c under `algos[c]`.

    params: per-row `(C,)` tensors (channel scalars, n_nodes, gamma,
    nest; `participation` when some row drops nodes; `ec` and
    `tx_budget` when some row runs error feedback; `n_antennas` with
    per-row counts; `b_count` (int) for minibatches); betas `(C,)`;
    theta0 `(d,)`; data: the stacked problem data (`(C, …)` leaves, mask
    `(C, N_max)`), all on one device. `n_sizes` are the call's distinct
    node counts. `n_antennas` is a static antenna count, `m_per_row` one
    count per row (or neither). `stochastic` is `(sample_indices_row,
    stochastic_grad_from_idx, b_max)` for a minibatch run, or None.

    Step order, as in the reference's scan body: the gradient at the
    Nesterov lookahead θ − nest·β·γ·m (over this step's minibatch), the
    risk of θ BEFORE the update, the error-feedback truncation, the
    participation mask on the transmission x, the residual, the
    cumulative energy E_N·Σ‖x‖², the slot on x, then m ← γm + v and
    θ ← θ − βm; the final θ's risk is appended.

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
        if m_per_row is not None:
            m_per_row = tuple(m_per_row[c] for c in order)
    use_ec = any(ALGO_REGISTRY[a].error_feedback for a in algos)

    # per-trajectory (B,) views of the per-row params: b = c·S + s
    p = {k: v.repeat_interleave(n_seeds) for k, v in params.items()}
    beta = betas.repeat_interleave(n_seeds)
    ctx = SlotCtx(fading=fading, p=p,
                  mask=data["mask"].repeat_interleave(n_seeds, dim=0),
                  counts=p["n_nodes"].to(torch.int64), n_sizes=n_sizes,
                  invert_channel=invert_channel, h_min=h_min,
                  ota_impl=ota_impl, phase_zero=phase_zero)
    spans = [(fn, lo * n_seeds, hi * n_seeds) for fn, lo, hi in groups]
    group_ctx = [_group_ctx(ctx, lo, hi, n_antennas, m_per_row, n_seeds)
                 for _, lo, hi in spans]
    seeds = torch.as_tensor(np.asarray(seed_ints, np.int64), device=device)
    keys = rng.key(seeds.repeat(n_rows))
    step_keys = rng.split(keys, steps)  # (B, T, 2)
    part = p.get("participation")
    part_keys: Optional[torch.Tensor] = None
    if part is not None:
        part_keys = rng.split(rng.fold_in(keys, _PART_STREAM), steps)
    data_keys: Optional[torch.Tensor] = None
    if stochastic is not None:
        sample_idx, sgrad_from_idx, b_max = stochastic
        data_keys = rng.split(rng.fold_in(keys, _DATA_STREAM), steps)

    theta = theta0.to(torch.float32).expand(batch, dim).clone()
    m = torch.zeros_like(theta)
    e_res = torch.zeros((batch, n_max, dim), dtype=torch.float32,
                        device=device) if use_ec else None
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
        if data_keys is None:
            g = grad_fn(data, grid(theta_eval))
        else:
            idx = sample_idx(data, data_keys[:, t], b_max)
            g = sgrad_from_idx(data, grid(theta_eval),
                               idx.view(n_rows, n_seeds, n_max, b_max),
                               params["b_count"])
        x = g.reshape(batch, n_max, dim)
        risks[:, t] = risk_fn(data, grid(theta)).reshape(batch)
        if use_ec:
            u = x + p["ec"][:, None, None] * e_res
            sq = (u * u).sum(dim=2)
            alpha = torch.minimum(torch.ones_like(sq), torch.sqrt(
                p["tx_budget"][:, None] / sq.clamp_min(1e-30)))
            # select, don't blend: inf/inf is NaN (an overflowing row under
            # the unbounded default budget), and 0·NaN would leak into
            # rows without the flag
            alpha = torch.where(p["ec"][:, None] > 0, alpha, 1.0)
            x = alpha[:, :, None] * u
        if part_keys is not None:
            # a dropped node transmits nothing this slot and spends no
            # energy; the edge still divides by the full N
            r = rng.uniform(part_keys[:, t], (n_max,))
            x = (r < part[:, None]).to(torch.float32)[:, :, None] * x
        if use_ec:
            # the residual sees the MASKED transmission: a dropped node
            # carries its whole update forward
            e_res = p["ec"][:, None, None] * (u - x)
        cum_e = cum_e + p["energy"] * (x * x).sum(dim=(1, 2))
        cum_curve[:, t] = cum_e
        k_t = step_keys[:, t]
        if len(spans) == 1:
            v = spans[0][0](x, k_t, group_ctx[0])
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
