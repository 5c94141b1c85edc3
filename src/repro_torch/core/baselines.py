"""Baselines the paper compares against (§VI): centralized GD and FDM-GD,
plus a CA-DSGD-style power-control OTA baseline from the related work
[11] (port of `repro.core.baselines`).

Each `run` is a Python loop returning the trajectory `(steps + 1, d)`
(the estimate before each step, then the last), with the reference's key
splits: `split(key, steps)` per step, each step key into (k_h, k_w).
Their sums are plain PyTorch, as the reference leaves them outside any
kernel. They run where `theta0` lives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.core import rng
from repro_torch.core.channel import ChannelConfig, sample_gains
from repro_torch.core.transport import weak_scalar


def _trajectory(theta0: torch.Tensor, steps: int, step_fn) -> torch.Tensor:
    """theta_{k+1} = step_fn(theta_k, k), stacked with theta0."""
    theta, traj = theta0, [theta0]
    for k in range(steps):
        theta = step_fn(theta, k)
        traj.append(theta)
    return torch.stack(traj)


@dataclasses.dataclass
class CentralizedGD:
    """Noiseless benchmark: theta_{k+1} = theta_k - beta (1/N) sum_n g_n."""

    grad_fn: Callable[[torch.Tensor], torch.Tensor]  # theta -> (N, d)
    stepsize: float

    def run(self, theta0: torch.Tensor, steps: int,
            key: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _trajectory(theta0, steps, lambda th, _: th - self.stepsize
                           * self.grad_fn(th).mean(dim=0))


@dataclasses.dataclass
class FDMGD:
    """Distributed GD over orthogonal (FDM/TDM) channels.

    Each node has its own channel: the edge receives h_{n,k} g_n + w_n
    with an INDEPENDENT noise vector per node (the noise cost grows with
    N, the paper's case against FDM, §I-A). With `invert_channel` the
    gains are equalized per link (k_h split off and not drawn), so the
    distortion is the per-node noise alone at energy E_N per node."""

    grad_fn: Callable[[torch.Tensor], torch.Tensor]
    channel: ChannelConfig
    stepsize: float
    invert_channel: bool = True

    def run(self, theta0: torch.Tensor, steps: int,
            key: torch.Tensor) -> torch.Tensor:
        keys = rng.split(key.to(theta0.device), steps)
        scale = self.channel.noise_std / math.sqrt(self.channel.energy)

        def step(theta, k):
            g = self.grad_fn(theta)  # (N, d)
            k_h, k_w = rng.split(keys[k])
            noise = weak_scalar(scale, g.dtype) * rng.normal(
                k_w, tuple(g.shape), dtype=g.dtype)
            if self.invert_channel:
                rx = g + noise  # per-link equalized
            else:
                h = sample_gains(k_h, self.channel, (g.shape[0],))
                rx = h[:, None] * g + noise
            return theta - self.stepsize * rx.mean(dim=0)

        return _trajectory(theta0, steps, step)

    def slot_energy(self, grads: torch.Tensor) -> torch.Tensor:
        """FDM per-slot energy: N separate transmissions at energy E_N."""
        return self.channel.energy * grads.to(torch.float32).square().sum()


@dataclasses.dataclass
class PowerControlOTA:
    """CA-DSGD-style truncated channel inversion (related work [11]).

    Nodes invert their channel gain so the edge sees the undistorted sum,
    but nodes in deep fade (h < h_min) stay silent to bound the inversion
    power: what GBMA gives up or gains by NOT using power control."""

    grad_fn: Callable[[torch.Tensor], torch.Tensor]
    channel: ChannelConfig
    stepsize: float
    h_min: float = 0.3

    def run(self, theta0: torch.Tensor, steps: int,
            key: torch.Tensor) -> torch.Tensor:
        keys = rng.split(key.to(theta0.device), steps)
        root_e = math.sqrt(self.channel.energy)

        def step(theta, k):
            g = self.grad_fn(theta)
            k_h, k_w = rng.split(keys[k])
            h = sample_gains(k_h, self.channel, (g.shape[0],))
            active = (h >= self.h_min).to(g.dtype)
            n_active = active.sum().clamp_min(1.0)
            # inverted channels superpose to the sum of active gradients
            sup = torch.einsum("n,nd->d", active, g)
            # the reference's f32 sigma_w / (A sqrt(E_N)), one division
            std = torch.full_like(n_active, self.channel.noise_std) \
                / (n_active * root_e)
            w = std * rng.normal(k_w, (g.shape[1],), dtype=g.dtype)
            return theta - self.stepsize * (sup / n_active + w)

        return _trajectory(theta0, steps, step)
