"""Execution core of the Monte Carlo engine (port of `repro.core.mc.exec`,
single-algorithm calls).

`run_core` is the counterpart of the reference's `_mc_core_impl`: C sweep
rows × S seeds × `steps` GBMA slots. Where the reference nests
`vmap(rows) ∘ vmap(seeds) ∘ lax.scan(steps)`, the port lays all
trajectories on one flat batch axis B = C·S (trajectory b = c·S + s), keeps
every tensor `(B, …)` on the device, and steps a Python loop — one OTA
kernel launch per step covers all B trajectories.

Randomness: trajectory b starts from `key(seed0 + s)`, its step keys are
`split(key, steps)`, and step t splits its key into (k_h, k_w) for the
gains and the edge noise — exactly the reference's streams. The
reference's 'hoisted' plan materializes the `(steps, …)` draws of those
same keys before its scan and its 'inscan' plan draws them inside; the
streams are identical by design (`repro/core/mc/exec.py`, module
docstring). The port draws per step, which keeps device memory at
O(B·N) instead of O(B·steps·N).

Seed reduction: `keep_seed_curves=False` reduces the `(C, S, steps+1)`
curves to (mean, ci95) on the device with exact two-pass moments
(`_mc_stats`); only `(C, steps+1)` statistics leave the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.core.mc.slots import ALGO_REGISTRY, SlotCtx


def run_core(params: dict, betas: torch.Tensor, theta0: torch.Tensor,
             seed_ints: np.ndarray, data: dict, *, grad_fn, risk_fn,
             algo: str, fading: str, steps: int, ota_impl: str = "auto",
             phase_zero: bool = False, reduce_moments: bool = False):
    """Run C rows × S seeds × `steps` slots of one algorithm.

    params: per-row `(C,)` tensors (channel scalars, n_nodes, gamma,
    nest); betas `(C,)`; theta0 `(d,)`; data: the stacked problem data
    (`(C, …)` leaves, mask `(C, N)`), all on one device.

    Step order, as in the reference's scan body: the gradient at the
    Nesterov lookahead θ − nest·β·γ·m, the risk of θ BEFORE the update,
    the cumulative energy E_N·Σ‖x‖², the slot, then m ← γm + v and
    θ ← θ − βm; the final θ's risk is appended.

    Returns per-seed `(risks (C, S, steps+1), cum_energy (C, S, steps))`,
    or `(mean, ci95)` of shape `(C, steps+1)` when `reduce_moments`.
    """
    spec = ALGO_REGISTRY[algo]
    n_rows, n_seeds = betas.shape[0], len(seed_ints)
    batch = n_rows * n_seeds
    device = betas.device
    dim = theta0.shape[0]
    n_max = data["mask"].shape[1]

    # per-trajectory (B,) views of the per-row params: b = c·S + s
    p = {k: v.repeat_interleave(n_seeds) for k, v in params.items()}
    beta = betas.repeat_interleave(n_seeds)
    ctx = SlotCtx(fading=fading, p=p,
                  mask=data["mask"].repeat_interleave(n_seeds, dim=0),
                  ota_impl=ota_impl, phase_zero=phase_zero)
    seeds = torch.as_tensor(np.asarray(seed_ints, np.int64), device=device)
    step_keys = rng.split(rng.key(seeds.repeat(n_rows)), steps)  # (B, T, 2)

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
        g = grad_fn(data, grid(theta_eval)).reshape(batch, n_max, dim)
        risks[:, t] = risk_fn(data, grid(theta)).reshape(batch)
        cum_e = cum_e + p["energy"] * (g * g).sum(dim=(1, 2))
        cum_curve[:, t] = cum_e
        v = spec.slot_fn(g, step_keys[:, t], ctx)
        m = p["gamma"][:, None] * m + v
        theta = theta - beta[:, None] * m
    risks[:, steps] = risk_fn(data, grid(theta)).reshape(batch)

    risks = risks.view(n_rows, n_seeds, steps + 1)
    if reduce_moments:
        return _mc_stats(risks)
    return risks, cum_curve.view(n_rows, n_seeds, steps)


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
