"""Fading multiple-access channel models (paper §II–III).

Each node n experiences a block-fading channel ``h~_{n,k}`` at slot t_k with
magnitude gain ``h_{n,k} = |h~_{n,k}|`` and phase ``phi_{n,k}``. Gains are
i.i.d. across nodes and slots with mean ``mu_h`` and variance ``sigma_h2``.
Nodes apply phase correction ``e^{-j phi_{n,k}}``; with a residual phase error
``|phi_err| < pi/4`` the *effective real gain* at the matched-filter output is
``h_{n,k} * cos(phi_err_{n,k})`` which keeps a non-zero mean (paper §III).

Port of `repro.core.channel`: `ChannelConfig`, `edge_noise_std` and
`received_snr_db` are the reference's pure-Python code, copied as is;
`sample_gains` and `sample_complex_gains` draw from the port's threefry
through the engine's sampler, so a fixed key gives the reference's
gains.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Configuration of the fading MAC.

    Attributes:
      fading: one of 'equal' | 'rayleigh' | 'rician' | 'lognormal'.
      scale: distribution scale parameter. For 'rayleigh' this is the Rayleigh
        sigma; for 'equal' the constant gain; for 'rician' the scatter sigma;
        for 'lognormal' the log-std.
      rician_k: Rician K-factor (LOS power / scattered power), only for 'rician'.
      phase_error_max: residual phase-correction error bound (radians). 0 means
        perfect phase correction. Values < pi/4 preserve a positive-mean gain.
      noise_std: sigma_w — std of the additive channel noise per waveform at the
        matched-filter output (before the 1/(N sqrt(E_N)) normalization).
      energy: E_N — per-node transmission energy coefficient.
    """

    fading: str = "rayleigh"
    scale: float = 1.0
    rician_k: float = 4.0
    phase_error_max: float = 0.0
    noise_std: float = 1.0
    energy: float = 1.0

    # ---- first/second moments of the effective gain -----------------------
    @property
    def mu_h(self) -> float:
        """E[h] of the *magnitude* gain (before phase error)."""
        if self.fading == "equal":
            mu = self.scale
        elif self.fading == "rayleigh":
            mu = self.scale * math.sqrt(math.pi / 2.0)
        elif self.fading == "rician":
            # nu^2 = K * 2 sigma^2 ; E[h] = sigma*sqrt(pi/2)*L_{1/2}(-nu^2/(2sigma^2))
            nu2 = self.rician_k * 2.0 * self.scale**2
            x = nu2 / (2.0 * self.scale**2)
            # Laguerre L_{1/2}(-x) = e^{-x/2}[(1+x) I0(x/2) + x I1(x/2)]
            l_half = math.exp(-x / 2.0) * (
                (1.0 + x) * _bessel_i0(x / 2.0) + x * _bessel_i1(x / 2.0)
            )
            mu = self.scale * math.sqrt(math.pi / 2.0) * l_half
        elif self.fading == "lognormal":
            mu = math.exp(self.scale**2 / 2.0)
        else:
            raise ValueError(f"unknown fading model: {self.fading}")
        if self.phase_error_max > 0.0:
            # E[cos(U)] for U ~ Unif[-a, a] = sin(a)/a
            mu *= math.sin(self.phase_error_max) / self.phase_error_max
        return mu

    @property
    def sigma_h2(self) -> float:
        """Var[h_eff] of the effective gain (including phase error)."""
        if self.fading == "equal":
            second = self.scale**2
        elif self.fading == "rayleigh":
            second = 2.0 * self.scale**2
        elif self.fading == "rician":
            nu2 = self.rician_k * 2.0 * self.scale**2
            second = nu2 + 2.0 * self.scale**2
        elif self.fading == "lognormal":
            second = math.exp(2.0 * self.scale**2)
        else:
            raise ValueError(f"unknown fading model: {self.fading}")
        if self.phase_error_max > 0.0:
            a = self.phase_error_max
            # E[cos^2 U] = 1/2 + sin(2a)/(4a)
            second *= 0.5 + math.sin(2.0 * a) / (4.0 * a)
        return second - self.mu_h**2

    @property
    def dispersion(self) -> float:
        """Channel index of dispersion D = sigma_h^2 / mu_h (paper Eq. 24)."""
        return self.sigma_h2 / self.mu_h

    @property
    def magnitude_m2(self) -> float:
        """E[h²] of the raw *magnitude* gain — no phase-error factor.

        This is the normalizer of the blind-transmitter MRC combiner
        (Amiri-Duman-Gündüz): with h~ = h e^{jφ}, E[|h~|²] = E[h²]
        regardless of the phase distribution."""
        if self.fading == "equal":
            return self.scale**2
        if self.fading == "rayleigh":
            return 2.0 * self.scale**2
        if self.fading == "rician":
            return 2.0 * self.scale**2 * (1.0 + self.rician_k)
        if self.fading == "lognormal":
            return math.exp(2.0 * self.scale**2)
        raise ValueError(f"unknown fading model: {self.fading}")


def _bessel_i0(x: float) -> float:
    # series expansion, adequate for the moderate K factors used here
    s, term = 1.0, 1.0
    for k in range(1, 30):
        term *= (x / 2.0) ** 2 / k**2
        s += term
    return s


def _bessel_i1(x: float) -> float:
    s, term = 0.0, x / 2.0
    for k in range(0, 30):
        s += term
        term *= (x / 2.0) ** 2 / ((k + 1) * (k + 2))
    return s


def sample_gains(key: torch.Tensor, cfg: ChannelConfig,
                 shape: tuple) -> torch.Tensor:
    """Sample effective real channel gains h_eff for `shape` node slots.

    Includes the residual-phase-error factor cos(phi_err). `key` is
    `(..., 2)` key data (leading axes batch independent draws) and the
    draw comes out `(..., *shape)`. Same split order and transforms as
    `repro.core.channel.sample_gains`: this is the engine's sampler
    (`core.mc.sampling._sample_gains`) with the config's scalars.
    """
    from repro_torch.core.mc.sampling import _sample_gains

    lead = key.shape[:-1]
    keys = key.reshape(-1, key.shape[-1])
    p = _cfg_params(cfg, keys, ("scale", "rician_k", "phase_error_max"))
    h = _sample_gains(keys, cfg.fading, p, tuple(shape),
                      phase_zero=cfg.phase_error_max <= 0.0)
    return h.reshape(lead + tuple(shape))


def _cfg_params(cfg: ChannelConfig, keys: torch.Tensor, names) -> dict:
    """The config's scalars as the engine's per-trajectory `(B,)` f32
    params, one per key of `keys (B, 2)`."""
    return {name: torch.full((keys.shape[0],), float(getattr(cfg, name)),
                             dtype=torch.float32, device=keys.device)
            for name in names}


def sample_complex_gains(key: torch.Tensor, cfg: ChannelConfig,
                         shape: tuple) -> tuple:
    """Complex channel gains h~ = h e^{jφ} as (real, imag) f32 parts.

    The blind-transmitter setting: nodes apply NO phase correction, so the
    full uniform phase φ ~ Unif[-π, π) survives (vs `sample_gains`, whose
    residual phase error is bounded by `phase_error_max`). The magnitude
    takes the same key half as `sample_gains`, so the magnitudes coincide
    for a fixed key. `key` is `(..., 2)`; each part comes out
    `(..., *shape)`. Twin of `repro.core.channel.sample_complex_gains`
    through the engine's sampler (`_sample_complex_gains`)."""
    from repro_torch.core.mc.sampling import _sample_complex_gains

    lead = key.shape[:-1]
    keys = key.reshape(-1, key.shape[-1])
    a, b = _sample_complex_gains(
        keys, cfg.fading, _cfg_params(cfg, keys, ("scale", "rician_k")),
        tuple(shape))
    return (a.reshape(lead + tuple(shape)), b.reshape(lead + tuple(shape)))


def edge_noise_std(cfg: ChannelConfig, n_nodes: int) -> float:
    """Per-coordinate std of w_k = w~_k / (N sqrt(E_N)) (paper Eq. 8)."""
    return cfg.noise_std / (n_nodes * math.sqrt(cfg.energy))


def received_snr_db(cfg: ChannelConfig, n_nodes: int, grad_power: float = 1.0) -> float:
    """Approximate received SNR (dB) of the aggregated signal at the edge.

    Signal power ~ E_N * (N mu_h)^2 * grad_power per coordinate vs noise
    sigma_w^2; used to report the operating point as in paper Fig. 4.
    """
    sig = cfg.energy * (n_nodes * cfg.mu_h) ** 2 * grad_power
    return 10.0 * math.log10(sig / cfg.noise_std**2)
