"""Sample-level waveform simulation of the analog MAC (paper §III, Eq.
5-8; port of `repro.core.waveform`).

It validates the abstract channel model used everywhere else: nodes
modulate their gradient entries onto d orthonormal baseband waveforms
s_m(t), transmit at once, the edge receives the superposition through
per-node fading plus AWGN and matched-filters with each waveform. The
matched-filter output must equal Eq. (7):

    v~_k[m] = sum_n sqrt(E_N) h_{n,k} g_n[m] + w~_k[m]

The orthonormal family is the discrete cosines sampled at T_s. Plain
products; functions run where their tensors live, and
`shaping_waveforms` makes its tensor on `device` (None = the card).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import rng
from repro_torch.core.transport import weak_scalar


def shaping_waveforms(d: int, n_samples: int,
                      device: DeviceLike = None) -> torch.Tensor:
    """d orthonormal discrete waveforms, `(d, n_samples)` f32.

    s_m[t] = sqrt(2/T) cos(pi (m + 1/2)(t + 1/2) / T), the DCT-II rows, an
    orthonormal basis of R^T; the first d rows. Needs n_samples >= d."""
    if n_samples < d:
        raise ValueError("need at least d samples for d orthogonal waveforms")
    dev = resolve_device(device)
    t = torch.arange(n_samples, dtype=torch.float32, device=dev)[None] + 0.5
    m = torch.arange(d, dtype=torch.float32, device=dev)[:, None] + 0.5
    amp = float(np.sqrt(np.float32(2.0 / n_samples)))  # the f32 sqrt
    return amp * torch.cos(math.pi * m * t / n_samples)


def transmit(grads: torch.Tensor, gains: torch.Tensor,
             waveforms: torch.Tensor, energy: float, noise_std: float,
             key: torch.Tensor) -> torch.Tensor:
    """Eq. (6): the superposed received waveform r_k(t), `(T,)`, for
    local gradients `(N, d)`, real gains `(N,)` (after phase correction)
    and waveforms `(d, T)`: each node sends sqrt(E_N) g_n^T s(t), the
    channel scales it by h_n, and AWGN of std `noise_std` is drawn from
    `key`."""
    amp = float(torch.tensor(energy, dtype=grads.dtype).sqrt())
    per_node = amp * (grads @ waveforms)  # (N, T)
    rx = (gains[:, None] * per_node).sum(dim=0)
    w = weak_scalar(noise_std, rx.dtype) * rng.normal(
        key.to(rx.device), tuple(rx.shape), dtype=rx.dtype)
    return rx + w


def matched_filter(rx: torch.Tensor, waveforms: torch.Tensor) -> torch.Tensor:
    """Project r_k(t) on each s_m(t): v~_k, `(d,)` (Eq. 7)."""
    return waveforms @ rx


def edge_estimate(rx: torch.Tensor, waveforms: torch.Tensor, n_nodes: int,
                  energy: float) -> torch.Tensor:
    """The edge's processing: matched filter, then the 1 / (N sqrt(E_N))
    scaling of Eq. (8) (its f32 value, as the reference computes it)."""
    scale = float(np.float32(n_nodes) * np.sqrt(np.float32(energy)))
    return matched_filter(rx, waveforms) / scale
