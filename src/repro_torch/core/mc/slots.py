"""Per-slot algorithm updates behind an open registry (port of
`repro.core.mc.slots`).

One MAC slot maps the transmitted per-node vectors to the received
update. In the port a slot is batched over trajectories: `g (B, N, d)`,
slot keys `(B, 2)`, per-trajectory channel scalars `ctx.p[...] (B,)`,
result `(B, d)`. Each algorithm registers `slot_fn(g, key, ctx)` with the
flags the engine reads (momentum / Nesterov carries, OTA membership,
Theorem-1 applicability). RNG split orders mirror the reference exactly.

Ported: `gbma` (single antenna), `centralized`, `momentum`, `nesterov`.
Waiting: antennas and MRC (ROADMAP P3); `fdm`, `power_control`, `blind`
and `blind_ec` (P4).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import rng
from repro_torch.core.mc.sampling import _sample_gains
from repro_torch.kernels.ota.ops import ota_edge_aggregate


@dataclasses.dataclass(frozen=True)
class SlotCtx:
    """Slot-call context: static engine choices + the trajectories' params.

    p:          per-trajectory params, each `(B,)` (channel scalars,
                n_nodes, gamma, nest).
    mask:       `(B, N)` validity mask of the node axis (all ones here).
    ota_impl:   the `repro_torch.kernels.ota.ota_edge_aggregate` route:
                'auto' (the kernel for CUDA tensors, the plain version for
                CPU tensors), 'kernel' or 'ref'.
    phase_zero: promise that every row's phase_error_max is 0 — the gain
                draw skips the precoded-phase stream (value-identical).
    """

    fading: str
    p: dict
    mask: torch.Tensor
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


def _ota_draw(key: torch.Tensor, ctx: SlotCtx, n: int, d: int) -> dict:
    """One OTA slot's draws — the key → (k_h, k_w) chain of the
    reference's `_ota_slot`: the `(B, N)` channel gains and the `(B, d)`
    edge noise."""
    k = rng.split(key)
    out = {"w": rng.normal(k[:, 1], (d,))}
    if not _gains_deterministic(ctx):
        out["h"] = _sample_gains(k[:, 0], ctx.fading, ctx.p, (n,),
                                 ctx.phase_zero)
    return out


def _ota_slot(g: torch.Tensor, key: torch.Tensor,
              ctx: SlotCtx) -> torch.Tensor:
    """Single-antenna OTA superposition (Eq. 8): v = (1/N) Σ h_n g_n + w,
    with w ~ N(0, std²), std = σ_w / (N √E_N).

    The superposition and noise add go through
    `repro_torch.kernels.ota.ota_edge_aggregate` — on the card one kernel
    launch for all B trajectories; the per-trajectory noise std folds
    into the noise operand."""
    p = ctx.p
    n, d = g.shape[1], g.shape[2]
    draws = _ota_draw(key, ctx, n, d)
    w = draws["w"]
    h = draws.get("h")
    if h is None:  # deterministic gains were (rightly) not drawn
        h = _deterministic_gains(ctx, n)
    std = p["noise_std"] / (p["n_nodes"] * torch.sqrt(p["energy"]))
    return ota_edge_aggregate(
        g, h, std[:, None] * w, noise_scale=1.0, impl=ctx.ota_impl,
        out_dtype=torch.promote_types(g.dtype, torch.float32))


def _gbma_slot(g: torch.Tensor, key: torch.Tensor,
               ctx: SlotCtx) -> torch.Tensor:
    """Precoded OTA aggregation, shared by gbma/momentum/nesterov
    (single-antenna edge; the MRC paths wait for ROADMAP P3)."""
    return _ota_slot(g, key, ctx)


def _centralized_slot(g: torch.Tensor, key: torch.Tensor,
                      ctx: SlotCtx) -> torch.Tensor:
    """Noiseless benchmark GD: the slot key is unused."""
    return g.sum(dim=1) / ctx.p["n_nodes"][:, None]


# --------------------------------------------------------------------------
# built-in registrations (the reference's flags)
# --------------------------------------------------------------------------
register_algo("gbma", _gbma_slot, ota=True, theorem1=True)
register_algo("centralized", _centralized_slot)
register_algo("momentum", _gbma_slot, ota=True, uses_gamma=True)
register_algo("nesterov", _gbma_slot, ota=True, uses_gamma=True,
              nesterov=True)
