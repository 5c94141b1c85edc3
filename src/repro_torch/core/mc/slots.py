"""Per-slot algorithm updates behind an open registry (port of
`repro.core.mc.slots`).

One MAC slot maps the transmitted per-node vectors to the received
update. In the port a slot is batched over trajectories: `g (B, N, d)`,
slot keys `(B, 2)`, per-trajectory channel scalars `ctx.p[...] (B,)`,
result `(B, d)`. Each algorithm registers `slot_fn(g, key, ctx)` with the
flags the engine reads (momentum / Nesterov / error-feedback carries, OTA
membership, antenna requirement, Theorem-1 applicability). RNG split
orders mirror the reference exactly.

On a node-count sweep the node axis is padded to N_max: padded rows carry
zero vectors (the problems' grad rows mask them) and zero gains, and each
slot normalizes by its trajectory's true count `p['n_nodes']`.

A multi-antenna edge adds an antenna axis of length M after the
trajectory axis: the slot key splits into M antenna keys (`split(key, M)`
for a static M, the per-row replay of `split(key, m)` for per-row
counts), each drawing its own gains and edge noise as the single-antenna
slot does. The gbma family aggregates all B·M (trajectory, antenna) pairs
in one OTA kernel launch and averages over each row's antennas (MRC);
the blind family combines its complex receptions in plain PyTorch, as
the reference computes them outside any kernel.

Hoisted draws: each algorithm that draws registers a `hoist_draws`
twin of its per-step draw (`_gbma_draw`, `_fdm_draw`, `_ota_draw` for
power_control, `_blind_draw`). The twin applies that same function to
the `(T, B, 2)` step keys of all T steps at once, flattened step-major,
with every per-trajectory tensor it reads tiled T-fold (`_steps_ctx`):
threefry and the bits→float maps are elementwise, so step t's slice is
the per-step draw bit for bit, one leading axis over the same counters.
Under the 'hoisted' RNG plan the engine passes step t's slice of the
twin's output as `ctx.draws`, and the slot draws nothing. The
reference's `hoist_gains` and its inscan node-count-sweep gain hoist
exist only to keep `lax.switch` branches out of an XLA scan and draw the
same streams, so the port has neither.

Registered: `gbma` (single antenna and MRC), `centralized`, `fdm`,
`power_control`, `momentum`, `nesterov`, `blind` and `blind_ec`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import rng
from repro_torch.core.mc.sampling import (_antenna_keys, _magnitude_m2,
                                          _normal_dynamic_n,
                                          _row_complex_gains, _row_gains)
from repro_torch.kernels.ota.ops import ota_edge_aggregate


@dataclasses.dataclass(frozen=True)
class SlotCtx:
    """Slot-call context: static engine choices + the trajectories' params.

    p:          per-trajectory params, each `(B,)` (channel scalars,
                n_nodes, gamma, nest).
    mask:       `(B, N_max)` validity mask of the padded node axis (None
                in a hoisted draw's context, `_steps_ctx`).
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
    n_antennas: a static antenna count M for every row (None: a
                single-antenna edge, or per-row counts).
    m_sizes:    the distinct per-row antenna counts of these rows (static;
                empty unless the call gave one count per row, which then
                live in `p['n_antennas']` as f32).
    m_max:      the antenna axis' length: M, or the largest per-row count.
    ant:        the per-antenna context, every per-trajectory tensor
                repeated M-fold (trajectory b's antenna m at b·M + m), so
                the single-antenna draws serve the flattened antenna keys
                (`with_antennas`).
    draws:      this step's slice of the algorithm's hoisted draws (the
                'hoisted' RNG plan), or None: the slot draws from its
                key.
    """

    fading: str
    p: dict
    mask: Optional[torch.Tensor]
    counts: torch.Tensor
    n_sizes: tuple
    invert_channel: bool = False
    h_min: float = 0.3
    ota_impl: str = "auto"
    phase_zero: bool = False
    n_antennas: Optional[int] = None
    m_sizes: tuple = ()
    m_max: int = 1
    ant: Optional["SlotCtx"] = None
    draws: Optional[dict] = None

    @property
    def antennas(self) -> bool:
        """Whether the edge has an antenna axis (a static M, 1 included,
        or per-row counts)."""
        return self.n_antennas is not None or bool(self.m_sizes)


def with_antennas(ctx: SlotCtx, n_antennas: Optional[int],
                  m_sizes: tuple) -> SlotCtx:
    """`ctx` with its antenna setting: a static count `n_antennas`, or the
    distinct per-row counts `m_sizes` of its rows (`p['n_antennas']`), or
    neither (a single antenna). The antenna axis is as long as the largest
    count of these rows; lane j < m of the replayed keys never depends on
    that length, so the values do not either."""
    if n_antennas is None and not m_sizes:
        return dataclasses.replace(ctx, n_antennas=None, m_sizes=(),
                                   m_max=1, ant=None)
    m_max = n_antennas if n_antennas is not None else max(m_sizes)
    rep = lambda t: t.repeat_interleave(m_max, dim=0)
    ant = dataclasses.replace(ctx, p={k: rep(v) for k, v in ctx.p.items()},
                              mask=rep(ctx.mask), counts=rep(ctx.counts))
    return dataclasses.replace(ctx, n_antennas=n_antennas,
                               m_sizes=tuple(m_sizes), m_max=m_max, ant=ant)


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    """One registered algorithm (flags as in the reference's AlgoSpec).

    ota:        receives the OTA superposition of Eq. (8).
    blind:      no-CSI transmitter family (M-antenna MRC edge); requires
                `n_antennas`.
    uses_gamma: the row takes the `run_mc(momentum=)` coefficient.
    nesterov:   gradient evaluated at the lookahead θ − βγm.
    error_feedback: the row carries the per-node residual and the power
                budget's truncation (`blind_ec`).
    hoist_draws: `(step_keys (T, B, 2), ctx, n, d) -> dict` of every
                stream the slot draws, for all T steps: a dict of
                `(T, …)` tensors whose step-t slice the slot takes as
                `ctx.draws`. None: the algorithm draws nothing, or only
                per step.
    theorem1:   the Theorem-1 bound applies.
    """

    name: str
    slot_fn: Callable
    ota: bool = False
    blind: bool = False
    uses_gamma: bool = False
    nesterov: bool = False
    error_feedback: bool = False
    hoist_draws: Optional[Callable] = None
    theorem1: bool = False


ALGO_REGISTRY: dict = {}  # name -> AlgoSpec, insertion-ordered


def register_algo(name: str, slot_fn: Callable, *, ota: bool = False,
                  blind: bool = False, uses_gamma: bool = False,
                  nesterov: bool = False, error_feedback: bool = False,
                  hoist_draws: Optional[Callable] = None,
                  theorem1: bool = False,
                  overwrite: bool = False) -> AlgoSpec:
    """Register a per-slot algorithm under `name` (the `run_mc(algo=)`
    value). Returns the spec."""
    if name in ALGO_REGISTRY and not overwrite:
        raise ValueError(f"algo {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    spec = AlgoSpec(name=name, slot_fn=slot_fn, ota=ota, blind=blind,
                    uses_gamma=uses_gamma, nesterov=nesterov,
                    error_feedback=error_feedback, hoist_draws=hoist_draws,
                    theorem1=theorem1)
    ALGO_REGISTRY[name] = spec
    return spec


# --------------------------------------------------------------------------
# slot implementations
#
# Each slot takes `ctx.draws` when the hoisted RNG plan gives them and
# otherwise draws from its key with its per-step draw function; each
# family's `*_hoist_draws` twin runs that same function over all steps.
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
    reference's `_ota_slot` (and `_pc_draw`, so power_control's draw
    too): the `(B, N)` channel gains and the `(B, d)` edge noise."""
    k = rng.split(key)
    out = {"w": rng.normal(k[:, 1], (d,))}
    if not _gains_deterministic(ctx):
        out["h"] = _gains(k[:, 0], ctx, n)
    return out


def _gains_noise(draws: dict, ctx: SlotCtx, n: int) -> tuple:
    """(h, w) of an OTA-type slot from its draws: the drawn gains, or the
    deterministic ones recomputed inline, and the raw edge noise."""
    h = draws.get("h")
    if h is None:  # deterministic gains were (rightly) not drawn
        h = _deterministic_gains(ctx, n)
    return h, draws["w"]


def _step_antenna_keys(key: torch.Tensor, ctx: SlotCtx) -> torch.Tensor:
    """One slot's `(B·M, 2)` antenna keys, trajectory-major: the plain
    split for a static M, the per-row replay of `split(key, m)` for
    per-row counts."""
    if ctx.m_sizes:
        keys = _antenna_keys(key, ctx.m_sizes, ctx.p["n_antennas"],
                             ctx.m_max)
    else:
        keys = rng.split(key, ctx.m_max)
    return keys.reshape(-1, 2)


def _gbma_draw(key: torch.Tensor, ctx: SlotCtx, n: int, d: int) -> dict:
    """`_gbma_slot`'s draws: the single-antenna `_ota_draw`, or with an
    antenna axis the `_ota_draw` of each of the `(B·M)` antenna keys."""
    if ctx.antennas:
        return _ota_draw(_step_antenna_keys(key, ctx), ctx.ant, n, d)
    return _ota_draw(key, ctx, n, d)


def _antenna_mean(v: torch.Tensor, ctx: SlotCtx) -> torch.Tensor:
    """`(B, M, d)` per-antenna updates -> `(B, d)`: the mean over a static
    M, or over each row's first m antennas (the lanes past m masked)."""
    if not ctx.m_sizes:
        return v.mean(dim=1)
    m = ctx.p["n_antennas"]
    lanes = (torch.arange(v.shape[1], device=v.device) < m[:, None])
    return torch.einsum("bm,bmd->bd", lanes.to(v.dtype), v) / m[:, None]


def _ota_slot(g: torch.Tensor, key: torch.Tensor,
              ctx: SlotCtx) -> torch.Tensor:
    """OTA superposition (Eq. 8): v = (1/N) Σ h_n g_n + w, with
    w ~ N(0, std²), std = σ_w / (N √E_N), N the trajectory's count.

    The superposition and noise add go through
    `repro_torch.kernels.ota.ota_edge_aggregate` — on the card one kernel
    launch for all B trajectories, each divided by its own N (the counts
    go to the kernel only when the rows' N differ: with one N the
    node-axis length is every count, and the kernel's count-free
    instantiation is the faster one); the per-trajectory noise std folds
    into the noise operand. With an antenna axis each of the M antenna
    keys draws its own (h, w), the launch covers all B·M pairs, and the
    result is `(B, M, d)`."""
    p = ctx.p
    b, n, d = g.shape
    std = p["noise_std"] / (p["n_nodes"] * torch.sqrt(p["energy"]))
    n_true = p["n_nodes"] if len(ctx.n_sizes) > 1 else None
    out_dtype = torch.promote_types(g.dtype, torch.float32)
    draws = ctx.draws if ctx.draws is not None \
        else _gbma_draw(key, ctx, n, d)
    if not ctx.antennas:
        h, w = _gains_noise(draws, ctx, n)
        return ota_edge_aggregate(g, h, std[:, None] * w, noise_scale=1.0,
                                  impl=ctx.ota_impl, out_dtype=out_dtype,
                                  n_true=n_true)
    h, w = _gains_noise(draws, ctx.ant, n)
    m = ctx.m_max
    return ota_edge_aggregate(
        g, h.view(b, m, n), std[:, None, None] * w.view(b, m, d),
        noise_scale=1.0, impl=ctx.ota_impl, out_dtype=out_dtype,
        n_true=n_true)


def _gbma_slot(g: torch.Tensor, key: torch.Tensor,
               ctx: SlotCtx) -> torch.Tensor:
    """Precoded OTA aggregation, shared by gbma/momentum/nesterov.

    A single-antenna edge is the reference's `GBMASimulator` stream. A
    static M (1 included) takes the MRC path of
    `ota_aggregate_multiantenna`, whose extra key split changes the
    stream even for M = 1, and averages over the M antennas; per-row
    counts sum each row's first m antennas and divide by m."""
    v = _ota_slot(g, key, ctx)
    return _antenna_mean(v, ctx) if ctx.antennas else v


def _centralized_slot(g: torch.Tensor, key: torch.Tensor,
                      ctx: SlotCtx) -> torch.Tensor:
    """Noiseless benchmark GD: the slot key is unused (and nothing is
    hoisted: it draws nothing)."""
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
    draws = ctx.draws if ctx.draws is not None \
        else _fdm_draw(key, ctx, n, d)
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


def _blind_antenna_draw(key: torch.Tensor, ant: SlotCtx, n: int,
                        d: int) -> dict:
    """Each antenna's draw chain in `_blind_slot`, over `(B·M, 2)`
    antenna keys and the per-antenna context `ant`: key → (k_h, k_w),
    k_h the complex gain parts (a, b) `(B·M, N)`, k_w the stacked
    real/imag edge noise `(B·M, 2, d)`."""
    k = rng.split(key)
    a, b = _row_complex_gains(k[:, 0], ant.fading, ant.p, ant.counts,
                              ant.n_sizes, n)
    return {"a": a, "b": b, "z": rng.normal(k[:, 1], (2, d))}


def _blind_draw(key: torch.Tensor, ctx: SlotCtx, n: int, d: int) -> dict:
    """`_blind_slot`'s draws: `_blind_antenna_draw` of its antenna keys."""
    return _blind_antenna_draw(_step_antenna_keys(key, ctx), ctx.ant, n, d)


def _blind_slot(g: torch.Tensor, key: torch.Tensor,
                ctx: SlotCtx) -> torch.Tensor:
    """Blind transmitters (1907.03909): nodes send g uncoded; antenna m
    receives y_m = Σ_n h~_{n,m} g_n + z~_m (complex, full uniform phase);
    the edge MRC-combines with receiver CSI, normalized by M·N·E[h²] —
    `gbma.blind_ota_aggregate` split for split: each antenna key -> (k_h,
    k_w), k_h the complex gains, k_w the `(2, d)` real/imag noise. The
    combine is plain PyTorch, as the reference computes it outside any
    kernel."""
    p = ctx.p
    b, n, d = g.shape
    m = ctx.m_max
    draws = ctx.draws if ctx.draws is not None \
        else _blind_draw(key, ctx, n, d)
    re, im = draws["a"].view(b, m, n), draws["b"].view(b, m, n)
    z = draws["z"].view(b, m, 2, d)
    std = (p["noise_std"] / torch.sqrt(p["energy"]))[:, None, None]
    y_r = torch.einsum("bmn,bnd->bmd", re, g) + std * z[:, :, 0]
    y_i = torch.einsum("bmn,bnd->bmd", im, g) + std * z[:, :, 1]
    s = re.sum(dim=-1)[..., None] * y_r + im.sum(dim=-1)[..., None] * y_i
    m_true = p["n_antennas"] if ctx.m_sizes \
        else torch.full_like(p["n_nodes"], float(m))
    lanes = torch.arange(m, device=g.device) < m_true[:, None]
    m2 = _magnitude_m2(ctx.fading, p)
    return torch.einsum("bm,bmd->bd", lanes.to(g.dtype), s) \
        / (m_true * p["n_nodes"] * m2)[:, None]


def _power_control_slot(g: torch.Tensor, key: torch.Tensor,
                        ctx: SlotCtx) -> torch.Tensor:
    """CA-DSGD-style truncated channel inversion [11]: nodes below `h_min`
    stay silent, the active set inverts its gains. v = (1/A) Σ a_n g_n + w
    with a_n = [h_n >= h_min], A = max(Σ a_n, 1) and std = σ_w / (A √E_N):
    the OTA kernel with gains a and each trajectory's count A."""
    p = ctx.p
    n, d = g.shape[1], g.shape[2]
    draws = ctx.draws if ctx.draws is not None \
        else _ota_draw(key, ctx, n, d)
    h, w = _gains_noise(draws, ctx, n)
    active = (h >= ctx.h_min).to(g.dtype) * ctx.mask
    n_active = active.sum(dim=1).clamp_min(1.0)
    std = p["noise_std"] / (n_active * torch.sqrt(p["energy"]))
    return ota_edge_aggregate(
        g, active, std[:, None] * w, noise_scale=1.0, impl=ctx.ota_impl,
        out_dtype=torch.promote_types(g.dtype, torch.float32),
        n_true=n_active)


# --------------------------------------------------------------------------
# hoisted draws (the 'hoisted' RNG plan)
# --------------------------------------------------------------------------
def _steps_ctx(ctx: SlotCtx, steps: int) -> SlotCtx:
    """The draw context of `steps` × B step-major keys (key t·B + b is
    trajectory b's step t): `p` and `counts` tiled `steps`-fold, in the
    per-antenna context too (its key (t·B + b)·M + m is antenna m of that
    step). The mask is left out: no draw reads it."""
    def tile(c: SlotCtx) -> SlotCtx:
        return dataclasses.replace(
            c, p={k: v.repeat(steps) for k, v in c.p.items()},
            counts=c.counts.repeat(steps), mask=None, ant=None, draws=None)

    out = tile(ctx)
    return out if ctx.ant is None \
        else dataclasses.replace(out, ant=tile(ctx.ant))


def _all_steps(draw: Callable, step_keys: torch.Tensor, ctx: SlotCtx,
               n: int, d: int) -> dict:
    """`draw(keys, ctx, n, d)` — a per-step draw function — over the
    `(T, B, 2)` step keys of all T steps at once: a dict of `(T, …)`
    tensors whose step-t slice is `draw(step_keys[t], ctx, n, d)` bit for
    bit."""
    steps = step_keys.shape[0]
    out = draw(step_keys.reshape(-1, 2), _steps_ctx(ctx, steps), n, d)
    return {k: v.unflatten(0, (steps, -1)) for k, v in out.items()}


def _gbma_hoist_draws(step_keys: torch.Tensor, ctx: SlotCtx, n: int,
                      d: int) -> dict:
    """All-steps twin of `_gbma_slot`'s draws (momentum and nesterov share
    it): 'h' `(T, B, N)` (absent for deterministic gains) and 'w'
    `(T, B, d)`, or per antenna `(T, B·M, …)`."""
    return _all_steps(_gbma_draw, step_keys, ctx, n, d)


def _blind_hoist_draws(step_keys: torch.Tensor, ctx: SlotCtx, n: int,
                       d: int) -> dict:
    """All-steps twin of `_blind_slot`'s draws: 'a', 'b' `(T, B·M, N)`
    and 'z' `(T, B·M, 2, d)`."""
    return _all_steps(_blind_draw, step_keys, ctx, n, d)


def _fdm_hoist_draws(step_keys: torch.Tensor, ctx: SlotCtx, n: int,
                     d: int) -> dict:
    """All-steps twin of `_fdm_slot`'s draws: 'noise_raw' `(T, B, N, d)`
    and, unless inverted or deterministic, 'h' `(T, B, N)`."""
    return _all_steps(_fdm_draw, step_keys, ctx, n, d)


def _pc_hoist_draws(step_keys: torch.Tensor, ctx: SlotCtx, n: int,
                    d: int) -> dict:
    """All-steps twin of `_power_control_slot`'s draws: 'h' `(T, B, N)`
    (absent for deterministic gains) and 'w' `(T, B, d)`."""
    return _all_steps(_ota_draw, step_keys, ctx, n, d)


# --------------------------------------------------------------------------
# built-in registrations (the reference's flags)
# --------------------------------------------------------------------------
register_algo("gbma", _gbma_slot, ota=True, hoist_draws=_gbma_hoist_draws,
              theorem1=True)
register_algo("centralized", _centralized_slot)
register_algo("fdm", _fdm_slot, hoist_draws=_fdm_hoist_draws)
register_algo("power_control", _power_control_slot,
              hoist_draws=_pc_hoist_draws)
register_algo("momentum", _gbma_slot, ota=True, uses_gamma=True,
              hoist_draws=_gbma_hoist_draws)
register_algo("nesterov", _gbma_slot, ota=True, uses_gamma=True,
              nesterov=True, hoist_draws=_gbma_hoist_draws)
register_algo("blind", _blind_slot, blind=True,
              hoist_draws=_blind_hoist_draws)
register_algo("blind_ec", _blind_slot, blind=True, error_feedback=True,
              hoist_draws=_blind_hoist_draws)


def hoist_draw_elems(name: str, *, steps: int, n_max: int, dim: int,
                     m_live: int, invert_channel: bool) -> int:
    """f32-element count of one trajectory's hoisted draws for the named
    algorithm — the registry's side of the memory model
    (`exec.estimate_peak_bytes`), the reference's terms. Unregistered
    algorithms and those without a hoist twin hoist nothing."""
    spec = ALGO_REGISTRY.get(name)
    if spec is None or spec.hoist_draws is None:
        return 0
    if spec.blind:
        # complex gain pair (m, n_max) + edge noise (m, 2, dim)
        return steps * m_live * 2 * (n_max + dim)
    if name == "fdm":
        # per-node noise (n_max, dim) + gains unless inverted
        return steps * n_max * (dim + (0 if invert_channel else 1))
    # gbma family / power_control: gains + edge noise
    return steps * m_live * (n_max + dim)
