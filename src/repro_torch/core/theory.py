"""Theorem 1/2 error bounds, stepsize design rules, and energy scaling laws
(paper §V). These are used to (a) pick provably-convergent stepsizes in the
experiments and (b) overlay theoretical bounds on the empirical error curves
(Figs. 2–3), validating the reproduction against the paper's own claims.

A numpy copy of `repro.core.theory`: the port imports nothing of `repro`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.channel import ChannelConfig


@dataclasses.dataclass(frozen=True)
class ProblemConstants:
    """Constants of the objective F = (1/N) Σ f_n (paper §II, §V)."""

    mu: float  # strong convexity of F
    L: float  # Lipschitz gradient of F
    L_bar: float  # max_n L_n over local losses
    delta: float  # diameter of the parameter set Theta
    r0_sq: float  # ||theta_0 - theta*||^2
    dim: int  # d


def stepsize_theorem1(pc: ProblemConstants, ch: ChannelConfig, n_nodes: int,
                      safety: float = 0.5) -> float:
    """Largest provably-valid constant stepsize under Eq. (15), scaled by
    `safety` (<1) to sit strictly inside the open interval."""
    mu_h, sh2 = ch.mu_h, ch.sigma_h2
    b1 = 2.0 / (mu_h * (pc.mu + pc.L))
    if sh2 <= 0.0:
        return safety * b1
    b2 = (2.0 * mu_h * pc.mu * pc.L * n_nodes) / (
        sh2 * pc.L_bar**2 * (1.0 + 2.0 * pc.delta) * (pc.mu + pc.L)
    )
    return safety * min(b1, b2)


def stepsize_theorem2(pc: ProblemConstants, ch: ChannelConfig,
                      safety: float = 0.5) -> float:
    """Constant stepsize under Eq. (18) (equal gains) / Eq. (20) (fading)."""
    return safety / (pc.L * max(ch.mu_h, 1e-12))


def contraction_c(beta: float, pc: ProblemConstants, ch: ChannelConfig,
                  n_nodes: int) -> float:
    """c = 1 - 2 beta mu_h mu L/(mu+L) + beta^2 sigma_h^2 Lbar^2 (1+2 delta)/N
    (Theorem 1). The linear-convergence contraction factor."""
    return (
        1.0
        - 2.0 * beta * ch.mu_h * pc.mu * pc.L / (pc.mu + pc.L)
        + beta**2 * ch.sigma_h2 * pc.L_bar**2 * (1.0 + 2.0 * pc.delta) / n_nodes
    )


def theorem1_bound(k: np.ndarray, beta: float, pc: ProblemConstants,
                   ch: ChannelConfig, n_nodes: int) -> np.ndarray:
    """RHS of Eq. (16): E[F(theta_k)] - F* bound for each iteration in `k`."""
    c = contraction_c(beta, pc, ch, n_nodes)
    if not (0.0 < c < 1.0):
        raise ValueError(f"contraction factor c={c:.4f} outside (0,1); "
                         "stepsize violates condition (15)")
    distortion = ch.sigma_h2 * pc.delta * pc.L_bar**2 * (2.0 + pc.delta) / n_nodes
    noise = pc.dim * ch.noise_std**2 / (ch.energy * n_nodes**2)
    steady = pc.L * beta**2 / (2.0 * (1.0 - c)) * (distortion + noise)
    return (c ** np.asarray(k, dtype=np.float64)) * pc.r0_sq * pc.L / 2.0 + steady


def theorem2_bound(k: np.ndarray, beta: float, pc: ProblemConstants,
                   ch: ChannelConfig, n_nodes: int, b_of_n: float,
                   equal_gains: bool = False) -> np.ndarray:
    """RHS of Eq. (19) (equal gains) or Eq. (21) (fading)."""
    k = np.asarray(k, dtype=np.float64)
    noise = pc.dim * ch.noise_std**2 / (ch.energy * n_nodes**2)
    if equal_gains:
        return pc.r0_sq / (2.0 * beta * k) + beta * noise
    mu_h = ch.mu_h
    distortion = b_of_n * ch.sigma_h2 / n_nodes
    return pc.r0_sq / (2.0 * beta * mu_h * k) + (beta / mu_h) * (distortion + noise)


def centralized_bound(k: np.ndarray, beta: float, pc: ProblemConstants) -> np.ndarray:
    """Centralized GD bound, Eq. (22), the benchmark rate."""
    c = 1.0 - 2.0 * beta * pc.mu * pc.L / (pc.mu + pc.L)
    return (c ** np.asarray(k, dtype=np.float64)) * pc.r0_sq * pc.L / 2.0


def energy_for_scaling(n_nodes: int, epsilon: float) -> float:
    """E_N = N^{epsilon-2}: the paper's sufficient per-node energy (§V-C.2)."""
    return float(n_nodes) ** (epsilon - 2.0)


def total_network_energy(n_nodes: int, e_n: float, grad_power: float = 1.0) -> float:
    """Total per-slot energy N * E_N * E[||g||^2]; under E_N = N^{eps-2} with
    eps < 1 this vanishes as N grows (paper Fig. 6)."""
    return n_nodes * e_n * grad_power


def quadratic_constants(A: np.ndarray, lam: float, theta0: np.ndarray,
                        theta_star: np.ndarray, delta: float) -> ProblemConstants:
    """Problem constants for the regularized least-squares objective (27):
    f_n = 0.5 (x_n^T theta - y_n)^2 + lam/2 ||theta||^2, where A = (1/N) X^T X.
    F's Hessian is A + lam I; per-node Hessians are x_n x_n^T + lam I.
    """
    eig = np.linalg.eigvalsh(A)
    mu = float(eig[0] + lam)
    L = float(eig[-1] + lam)
    return ProblemConstants(
        mu=mu,
        L=L,
        L_bar=L,  # callers with per-node rows should override with max_n ||x_n||^2+lam
        delta=delta,
        r0_sq=float(np.sum((theta0 - theta_star) ** 2)),
        dim=int(theta0.shape[0]),
    )
