"""Random-draw machinery for the Monte Carlo engine (port of
`repro.core.mc.sampling`, single static node-count tier).

Each sampler is the twin of the reference's shaped draw — same key-split
order, same draw shapes, same bits->float transforms — on the port's
threefry (`repro_torch.core.rng`), so a fixed key gives the reference's
gains. Everything is batched over a leading trajectory axis: keys are
`(B, 2)`, per-row channel scalars in `p` are `(B,)`, draws `(B, *shape)`.

The padded (`lax.switch`) and counts-as-data (dynamic-N) tiers the
reference uses for node-count sweeps are not ported yet (ROADMAP P1):
every call here has one static node count.
"""
from __future__ import annotations

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
