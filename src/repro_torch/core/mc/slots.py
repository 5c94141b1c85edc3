"""Per-slot algorithm updates behind an open registry (port of
`repro.core.mc.slots`).

One MAC slot maps the transmitted per-node vectors to the received
update. In the port a slot is batched over trajectories: `g (B, N, d)`,
slot keys `(B, 2)`, per-trajectory channel scalars `ctx.p[...] (B,)`,
result `(B, d)`. Each algorithm registers `slot_fn(g, key, ctx)` with the
flags the engine reads (momentum / Nesterov carries, OTA membership,
Theorem-1 applicability). RNG split orders mirror the reference exactly.

On a node-count sweep the node axis is padded to N_max: padded rows carry
zero vectors (the problems' grad rows mask them) and zero gains, and each
slot normalizes by its trajectory's true count `p['n_nodes']`.

Ported: `gbma` (single antenna), `centralized`, `fdm`, `power_control`,
`momentum`, `nesterov`. Waiting: antennas and MRC, with `blind` and
`blind_ec` (ROADMAP P3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import rng
from repro_torch.core.mc.sampling import _normal_dynamic_n, _row_gains
from repro_torch.kernels.ota.ops import ota_edge_aggregate


@dataclasses.dataclass(frozen=True)
class SlotCtx:
    """Slot-call context: static engine choices + the trajectories' params.

    p:          per-trajectory params, each `(B,)` (channel scalars,
                n_nodes, gamma, nest).
    mask:       `(B, N_max)` validity mask of the padded node axis.
    counts:     `(B,)` int64 true node counts (the dynamic-N draws' sizes;
                `p['n_nodes']` holds the same counts in f32).
    n_sizes:    the call's distinct node counts (static): one count takes
                the plain shaped draws, several the dynamic-N draws.
    invert_channel: fdm equalizes the gains (k_h split off, not drawn).
    h_min:      power_control's truncation threshold.
    ota_impl:   the `repro_torch.kernels.ota.ota_edge_aggregate` route:
                'auto' (the kernel for CUDA tensors, the plain version for
                CPU tensors), 'kernel' or 'ref'.
    phase_zero: promise that every row's phase_error_max is 0 — the gain
                draw skips the precoded-phase stream (value-identical).
    """

    fading: str
    p: dict
    mask: torch.Tensor
    counts: torch.Tensor
    n_sizes: tuple
    invert_channel: bool = False
    h_min: float = 0.3
    ota_impl: str = "auto"
    phase_zero: bool = False


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    """One registered algorithm (flags as in the reference's AlgoSpec).

    ota:        receives the OTA superposition of Eq. (8).
    uses_gamma: the row takes the `run_mc(momentum=)` coefficient.
    nesterov:   gradient evaluated at the lookahead θ − βγm.
    theorem1:   the Theorem-1 bound applies.
    """

    name: str
    slot_fn: Callable
    ota: bool = False
    uses_gamma: bool = False
    nesterov: bool = False
    theorem1: bool = False


ALGO_REGISTRY: dict = {}  # name -> AlgoSpec, insertion-ordered


def register_algo(name: str, slot_fn: Callable, *, ota: bool = False,
                  uses_gamma: bool = False, nesterov: bool = False,
                  theorem1: bool = False,
                  overwrite: bool = False) -> AlgoSpec:
    """Register a per-slot algorithm under `name` (the `run_mc(algo=)`
    value). Returns the spec."""
    if name in ALGO_REGISTRY and not overwrite:
        raise ValueError(f"algo {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    spec = AlgoSpec(name=name, slot_fn=slot_fn, ota=ota,
                    uses_gamma=uses_gamma, nesterov=nesterov,
                    theorem1=theorem1)
    ALGO_REGISTRY[name] = spec
    return spec


# --------------------------------------------------------------------------
# slot implementations
# --------------------------------------------------------------------------
def _gains_deterministic(ctx: SlotCtx) -> bool:
    """Equal fading with the phase stream statically zero consumes no
    randomness: the slot recomputes the broadcast gain inline."""
    return ctx.fading == "equal" and ctx.phase_zero


def _deterministic_gains(ctx: SlotCtx, n: int) -> torch.Tensor:
    """`(B, N)` gains of a `_gains_deterministic` batch: the scale,
    masked (bit-exact: valid lanes hold exactly 1.0)."""
    h = ctx.p["scale"][:, None].expand(-1, n)
    return h * ctx.mask


def _gains(key: torch.Tensor, ctx: SlotCtx, n: int) -> torch.Tensor:
    """The slot's `(B, N)` zero-padded gains from k_h."""
    return _row_gains(key, ctx.fading, ctx.p, ctx.counts, ctx.n_sizes, n,
                      ctx.phase_zero)


def _ota_draw(key: torch.Tensor, ctx: SlotCtx, n: int, d: int) -> dict:
    """One OTA slot's draws — the key → (k_h, k_w) chain of the
    reference's `_ota_slot` (and `_pc_draw`): the `(B, N)` channel gains
    and the `(B, d)` edge noise."""
    k = rng.split(key)
    out = {"w": rng.normal(k[:, 1], (d,))}
    if not _gains_deterministic(ctx):
        out["h"] = _gains(k[:, 0], ctx, n)
    return out


def _draw_gains_noise(g: torch.Tensor, key: torch.Tensor,
                      ctx: SlotCtx) -> tuple:
    """(h, w) of an OTA-type slot: drawn gains, or the deterministic ones
    recomputed inline, and the raw edge noise."""
    n, d = g.shape[1], g.shape[2]
    draws = _ota_draw(key, ctx, n, d)
    h = draws.get("h")
    if h is None:  # deterministic gains were (rightly) not drawn
        h = _deterministic_gains(ctx, n)
    return h, draws["w"]


def _ota_slot(g: torch.Tensor, key: torch.Tensor,
              ctx: SlotCtx) -> torch.Tensor:
    """Single-antenna OTA superposition (Eq. 8): v = (1/N) Σ h_n g_n + w,
    with w ~ N(0, std²), std = σ_w / (N √E_N), N the trajectory's count.

    The superposition and noise add go through
    `repro_torch.kernels.ota.ota_edge_aggregate` — on the card one kernel
    launch for all B trajectories, each divided by its own N (the counts
    go to the kernel only when the rows' N differ: with one N the
    node-axis length is every count, and the kernel's count-free
    instantiation is the faster one); the per-trajectory noise std folds
    into the noise operand."""
    p = ctx.p
    h, w = _draw_gains_noise(g, key, ctx)
    std = p["noise_std"] / (p["n_nodes"] * torch.sqrt(p["energy"]))
    return ota_edge_aggregate(
        g, h, std[:, None] * w, noise_scale=1.0, impl=ctx.ota_impl,
        out_dtype=torch.promote_types(g.dtype, torch.float32),
        n_true=p["n_nodes"] if len(ctx.n_sizes) > 1 else None)


def _gbma_slot(g: torch.Tensor, key: torch.Tensor,
               ctx: SlotCtx) -> torch.Tensor:
    """Precoded OTA aggregation, shared by gbma/momentum/nesterov
    (single-antenna edge; the MRC paths wait for ROADMAP P3)."""
    return _ota_slot(g, key, ctx)


def _centralized_slot(g: torch.Tensor, key: torch.Tensor,
                      ctx: SlotCtx) -> torch.Tensor:
    """Noiseless benchmark GD: the slot key is unused."""
    return g.sum(dim=1) / ctx.p["n_nodes"][:, None]


def _fdm_draw(key: torch.Tensor, ctx: SlotCtx, n: int, d: int) -> dict:
    """`_fdm_slot`'s draws: the `(B, N, d)` per-node noise from k_w and —
    unless the channel is inverted (k_h split off but unconsumed, as in
    `baselines.FDMGD`) or the gains are deterministic — the `(B, N)`
    gains from k_h."""
    k = rng.split(key)
    if len(ctx.n_sizes) > 1:
        raw = _normal_dynamic_n(k[:, 1], ctx.counts, n, d)
    else:
        raw = rng.normal(k[:, 1], (n, d))
    out = {"noise_raw": raw}
    if not ctx.invert_channel and not _gains_deterministic(ctx):
        out["h"] = _gains(k[:, 0], ctx, n)
    return out


def _fdm_slot(g: torch.Tensor, key: torch.Tensor,
              ctx: SlotCtx) -> torch.Tensor:
    """Orthogonal-channel GD: independent per-node `(d,)` noise; with
    `invert_channel` the gain is equalized. The per-node receptions are
    masked, summed and divided by the trajectory's N — plain PyTorch, as
    the reference computes it outside any kernel."""
    p = ctx.p
    n, d = g.shape[1], g.shape[2]
    draws = _fdm_draw(key, ctx, n, d)
    noise = (p["noise_std"] / torch.sqrt(p["energy"]))[:, None, None] \
        * draws["noise_raw"]
    if ctx.invert_channel:
        rx = g + noise
    else:
        h = draws.get("h")
        if h is None:  # deterministic gains were (rightly) not drawn
            h = _deterministic_gains(ctx, n)
        rx = h[:, :, None] * g + noise
    return (rx * ctx.mask[:, :, None]).sum(dim=1) / p["n_nodes"][:, None]


def _power_control_slot(g: torch.Tensor, key: torch.Tensor,
                        ctx: SlotCtx) -> torch.Tensor:
    """CA-DSGD-style truncated channel inversion [11]: nodes below `h_min`
    stay silent, the active set inverts its gains. v = (1/A) Σ a_n g_n + w
    with a_n = [h_n >= h_min], A = max(Σ a_n, 1) and std = σ_w / (A √E_N):
    the OTA kernel with gains a and each trajectory's count A."""
    p = ctx.p
    h, w = _draw_gains_noise(g, key, ctx)
    active = (h >= ctx.h_min).to(g.dtype) * ctx.mask
    n_active = active.sum(dim=1).clamp_min(1.0)
    std = p["noise_std"] / (n_active * torch.sqrt(p["energy"]))
    return ota_edge_aggregate(
        g, active, std[:, None] * w, noise_scale=1.0, impl=ctx.ota_impl,
        out_dtype=torch.promote_types(g.dtype, torch.float32),
        n_true=n_active)


# --------------------------------------------------------------------------
# built-in registrations (the reference's flags)
# --------------------------------------------------------------------------
register_algo("gbma", _gbma_slot, ota=True, theorem1=True)
register_algo("centralized", _centralized_slot)
register_algo("fdm", _fdm_slot)
register_algo("power_control", _power_control_slot)
register_algo("momentum", _gbma_slot, ota=True, uses_gamma=True)
register_algo("nesterov", _gbma_slot, ota=True, uses_gamma=True,
              nesterov=True)
