"""Random-draw machinery for the Monte Carlo engine (port of
`repro.core.mc.sampling`).

Each sampler is the twin of the reference's shaped draw — same key-split
order, same draw shapes, same bits->float transforms — on the port's
threefry (`repro_torch.core.rng`), so a fixed key gives the reference's
gains. Everything is batched over a leading trajectory axis: keys are
`(B, 2)`, per-row channel scalars in `p` are `(B,)`, draws `(B, *shape)`.

Two tiers: the plain shaped draws for one static node count, and the
dynamic-N draws (`*_dynamic_n`) for node-count sweeps, which build each
trajectory's counters from its own count as tensor data
(`rng.dynamic_bits`) and zero the lanes past it. The reference's third
tier, a per-N `lax.switch`, exists only for PRNGs other than threefry;
the port's RNG is threefry in the original layout, so one program serves
every N. `_row_gains` and `_row_complex_gains` pick the tier, and
`_antenna_keys` replays `split(key, m)` with each row's antenna count m
as data in the same way.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import rng


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) per-trajectory scalar -> broadcastable against (B, ...)."""
    return v.reshape(v.shape + (1,) * (ndim - 1))


def _sample_magnitude(k_mag: torch.Tensor, fading: str, p: dict,
                      shape: tuple) -> torch.Tensor:
    """The per-family |h~| draw over per-trajectory scalar params:
    `(B, 2)` keys -> `(B, *shape)` f32."""
    nd = 1 + len(shape)
    scale = _col(p["scale"], nd)
    if fading == "equal":
        return scale.expand(k_mag.shape[:-1] + tuple(shape))
    if fading == "rayleigh":
        u = rng.uniform(k_mag, shape, minval=1e-12, maxval=1.0)
        return scale * torch.sqrt(-2.0 * torch.log(u))
    if fading == "rician":
        nu = torch.sqrt(_col(p["rician_k"], nd) * 2.0) * scale
        xy = rng.normal(k_mag, tuple(shape) + (2,)) * scale[..., None]
        x, y = xy[..., 0] + nu, xy[..., 1]
        return torch.sqrt(x * x + y * y)
    if fading == "lognormal":
        return torch.exp(scale * rng.normal(k_mag, shape))
    raise ValueError(f"unknown fading model: {fading}")


def _magnitude_m2(fading: str, p: dict) -> torch.Tensor:
    """E[h²] of the raw magnitude gain per trajectory — the blind-MRC
    combiner's normalizer (twin of `ChannelConfig.magnitude_m2`)."""
    scale = p["scale"]
    if fading == "equal":
        return scale**2
    if fading == "rayleigh":
        return 2.0 * scale**2
    if fading == "rician":
        return 2.0 * scale**2 * (1.0 + p["rician_k"])
    if fading == "lognormal":
        return torch.exp(2.0 * scale**2)
    raise ValueError(f"unknown fading model: {fading}")


def _sample_gains(key: torch.Tensor, fading: str, p: dict, shape: tuple,
                  phase_zero: bool = False) -> torch.Tensor:
    """Twin of `repro.core.mc.sampling._sample_gains`: key -> (k_mag,
    k_ph); magnitude from k_mag, residual phase cos(U[-a, a]) from k_ph.

    `phase_zero` promises every row's phase_error_max is 0 and skips the
    phase draw: value-identical (h · cos(0) == h, and the phase stream
    hashes its own key half, so no other draw shifts)."""
    k = rng.split(key)
    h = _sample_magnitude(k[..., 0, :], fading, p, shape)
    if phase_zero:
        return h.to(torch.float32)
    a = _col(p["phase_error_max"], 1 + len(shape))
    phi = rng.uniform(k[..., 1, :], shape, minval=-a, maxval=a)
    return (h * torch.cos(phi)).to(torch.float32)


def _sample_complex_gains(key: torch.Tensor, fading: str, p: dict,
                          shape: tuple) -> tuple:
    """Twin of `repro.core.mc.sampling._sample_complex_gains`: the (real,
    imag) parts of h e^{jφ} with the FULL uniform phase φ ~ U[-π, π) (no
    precoding in the blind-transmitter setting). Same split order as
    `_sample_gains`: key -> (k_mag, k_ph)."""
    k = rng.split(key)
    h = _sample_magnitude(k[..., 0, :], fading, p, shape)
    phi = rng.uniform(k[..., 1, :], shape, minval=-math.pi, maxval=math.pi)
    return ((h * torch.cos(phi)).to(torch.float32),
            (h * torch.sin(phi)).to(torch.float32))


# --------------------------------------------------------------------------
# dynamic-length draws (node-count sweeps): counts as data
# --------------------------------------------------------------------------
def _lanes_below(n: torch.Tensor, width: int) -> torch.Tensor:
    """`(B, width)` bool: lane < n[b]."""
    return torch.arange(width, device=n.device) < n[:, None]


def _normal_dynamic_n(key: torch.Tensor, n: torch.Tensor, n_max: int,
                      d: int) -> torch.Tensor:
    """Zero-padded `(B, n_max, d)` twin of `normal(key[b], (n[b], d))`
    for per-trajectory counts n `(B,)` (the fdm per-node noise of a
    node-count sweep)."""
    z = rng.u01_to_normal(rng.bits_to_u01(
        rng.dynamic_bits(key, n * d, n_max * d)))
    z = torch.where(_lanes_below(n * d, n_max * d), z, 0.0)
    return z.reshape(-1, n_max, d)


def _sample_magnitude_dynamic_n(k_mag: torch.Tensor, fading: str, p: dict,
                                n: torch.Tensor, n_max: int) -> torch.Tensor:
    """Dynamic-count twin of `_sample_magnitude`: `(B, n_max)`; lanes past
    n[b] hold other draws until the caller masks them."""
    scale = p["scale"][:, None]
    if fading == "equal":
        return scale.expand(-1, n_max)
    if fading == "rayleigh":
        u = rng.u01_to_uniform(rng.bits_to_u01(
            rng.dynamic_bits(k_mag, n, n_max)), 1e-12, 1.0)
        return scale * torch.sqrt(-2.0 * torch.log(u))
    if fading == "rician":
        nu = torch.sqrt(p["rician_k"][:, None] * 2.0) * scale
        z = rng.u01_to_normal(rng.bits_to_u01(
            rng.dynamic_bits(k_mag, 2 * n, 2 * n_max)))
        xy = z.reshape(-1, n_max, 2) * scale[..., None]
        x, y = xy[..., 0] + nu, xy[..., 1]
        return torch.sqrt(x * x + y * y)
    if fading == "lognormal":
        z = rng.u01_to_normal(rng.bits_to_u01(
            rng.dynamic_bits(k_mag, n, n_max)))
        return torch.exp(scale * z)
    raise ValueError(f"unknown fading model: {fading}")


def _sample_gains_dynamic_n(key: torch.Tensor, fading: str, p: dict,
                            n: torch.Tensor, n_max: int,
                            phase_zero: bool = False) -> torch.Tensor:
    """Twin of `_sample_gains(key[b], fading, p, (n[b],))` zero-padded to
    `(B, n_max)`, n `(B,)` the trajectories' true node counts (integer
    tensor). `phase_zero` skips the phase stream, as in `_sample_gains`."""
    k = rng.split(key)
    h = _sample_magnitude_dynamic_n(k[:, 0], fading, p, n, n_max)
    if not phase_zero:
        a = p["phase_error_max"][:, None]
        phi = rng.u01_to_uniform(rng.bits_to_u01(
            rng.dynamic_bits(k[:, 1], n, n_max)), -a, a)
        h = h * torch.cos(phi)
    return torch.where(_lanes_below(n, n_max), h.to(torch.float32), 0.0)


def _row_gains(key: torch.Tensor, fading: str, p: dict, n: torch.Tensor,
               n_sizes: tuple, n_max: int,
               phase_zero: bool = False) -> torch.Tensor:
    """The trajectories' `(B, n_max)` zero-padded slot gains: the plain
    shaped draw when every row has the same N (`n_sizes`, the call's
    distinct counts), the dynamic-N draw otherwise."""
    if len(n_sizes) > 1:
        return _sample_gains_dynamic_n(key, fading, p, n, n_max, phase_zero)
    return _sample_gains(key, fading, p, (n_max,), phase_zero)


def _sample_complex_gains_dynamic_n(key: torch.Tensor, fading: str,
                                    p: dict, n: torch.Tensor,
                                    n_max: int) -> tuple:
    """Twin of `_sample_complex_gains(key[b], fading, p, (n[b],))`, both
    parts zero-padded to `(B, n_max)` (the blind family's gains on
    node-count sweeps)."""
    k = rng.split(key)
    h = _sample_magnitude_dynamic_n(k[:, 0], fading, p, n, n_max)
    phi = rng.u01_to_uniform(rng.bits_to_u01(
        rng.dynamic_bits(k[:, 1], n, n_max)), -math.pi, math.pi)
    lane = _lanes_below(n, n_max)
    return (torch.where(lane, (h * torch.cos(phi)).to(torch.float32), 0.0),
            torch.where(lane, (h * torch.sin(phi)).to(torch.float32), 0.0))


def _row_complex_gains(key: torch.Tensor, fading: str, p: dict,
                       n: torch.Tensor, n_sizes: tuple,
                       n_max: int) -> tuple:
    """Complex counterpart of `_row_gains`: the `(B, n_max)` (real, imag)
    gain parts, shaped for one N, dynamic-N for several."""
    if len(n_sizes) > 1:
        return _sample_complex_gains_dynamic_n(key, fading, p, n, n_max)
    return _sample_complex_gains(key, fading, p, (n_max,))


def _antenna_keys(key: torch.Tensor, m_sizes: tuple, m: torch.Tensor,
                  m_max: int) -> torch.Tensor:
    """`(B, m_max, 2)` antenna keys whose first m[b] lanes equal
    `split(key[b], m[b])` (twin of `repro.core.mc.sampling._antenna_keys`).

    `split` is itself a draw over 2m counters, so splitting at m_max and
    masking would change every row's stream. With one count (`m_sizes`,
    the distinct counts of these rows) this is the plain split; with
    several the split layout is replayed with each count as data
    (`rng.dynamic_bits` over 2m counters). Lanes past m[b] hold
    well-formed keys of other streams; callers mask the antenna axis."""
    if len(m_sizes) == 1:
        return rng.split(key, m_max)
    bits = rng.dynamic_bits(key, 2 * m.to(torch.int64), 2 * m_max)
    return bits.reshape(-1, m_max, 2)
