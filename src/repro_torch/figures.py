"""Paper Figs. 2 and 3 on the port: the twin of
`benchmarks/common.py::MSDProblem` / `run_msd_figure` and of
`benchmarks/fig2_equal_gains.py` / `fig3_rayleigh.py`, written out here
because the port imports nothing of the reference's `benchmarks`.

Federated MSD-like regression (paper §VI-A), one sample per node:
(a) error vs iterations for each N of a node-count grid at E_N = 1, and
(b) the energy sweep E_N = N^(ε−2) at the largest N; both overlay the
Theorem-1 bound. Part (a) runs one `run_mc` call per N where the
reference runs one padded sweep (not ported yet, ROADMAP P1); the
reference pins its padded sweep to per-N runs within 1e-5, so the rows
are the same. The CSV rows match the reference's format.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.mc.engine import run_mc
from repro_torch.core.mc.problems import MCProblem, quadratic_mc_problem
from repro_torch.core.theory import ProblemConstants, stepsize_theorem1
from repro_torch.data.synthetic import msd_like_regression

LAMBDA = 0.5  # paper §VI-A: regularizer of Eq. (27)

# the operating points of benchmarks/fig2_equal_gains.py and fig3_rayleigh.py
FIG2 = {"fading": "equal", "prefix": "fig2", "n_grid": (50, 160, 500),
        "eps_grid": (0.5, 1.0, 1.5), "steps": 300, "seeds": 4}
FIG3 = {"fading": "rayleigh", "prefix": "fig3", "n_grid": (50, 160, 500),
        "eps_grid": (0.5, 1.0, 1.5), "steps": 300, "seeds": 4}


@dataclasses.dataclass
class MSDProblem:
    """Regularized linear least squares on the MSD-like dataset; one sample
    per node (paper §VI-A). Same arrays as the reference's `MSDProblem`."""

    X: np.ndarray
    y: np.ndarray
    theta_star: np.ndarray
    pc: ProblemConstants

    @classmethod
    def make(cls, n_nodes: int, dim: int = 90, seed: int = 0,
             delta: float = 10.0) -> "MSDProblem":
        X, y, _ = msd_like_regression(n_nodes, dim=dim, seed=seed)
        A = X.T @ X / n_nodes
        theta_star = np.linalg.solve(A + LAMBDA * np.eye(dim),
                                     X.T @ y / n_nodes)
        eig = np.linalg.eigvalsh(A)
        pc = ProblemConstants(
            mu=float(eig[0] + LAMBDA), L=float(eig[-1] + LAMBDA),
            L_bar=float(np.max(np.sum(X**2, axis=1)) + LAMBDA),
            delta=delta, r0_sq=float(np.sum(theta_star**2)), dim=dim)
        return cls(X, y, theta_star, pc)

    def to_mc(self, device: DeviceLike = None) -> MCProblem:
        return quadratic_mc_problem(self.X, self.y, LAMBDA, self.theta_star,
                                    device=device)


def fmt_curve(name: str, ks: np.ndarray, values: np.ndarray,
              every: int = 50, ci95: np.ndarray | None = None) -> list:
    """CSV rows `name,k=K,value[,±ci95]`, subsampled every `every` points
    (the last point always included)."""
    idx = list(range(0, len(ks), every))
    if idx[-1] != len(ks) - 1:
        idx.append(len(ks) - 1)
    rows = []
    for i in idx:
        row = f"{name},k={int(ks[i])},{values[i]:.6e}"
        if ci95 is not None:
            row += f",±{ci95[i]:.2e}"
        rows.append(row)
    return rows


def run_msd_figure(fading: str, prefix: str, n_grid, eps_grid, steps: int,
                   seeds: int, *, device: DeviceLike = None,
                   ota_impl: str = "auto") -> list:
    """Shared body of Figs. 2 (equal gains) and 3 (Rayleigh): the CSV rows
    of (a) the node-count sweep and (b) the energy sweep."""
    dev = resolve_device(device)
    rows = []
    ks = np.arange(steps + 1)
    probs = {n: MSDProblem.make(n) for n in n_grid}
    for n in n_grid:
        prob = probs[n]
        ch = ChannelConfig(fading=fading, scale=1.0, noise_std=1.0,
                           energy=1.0)
        beta = stepsize_theorem1(prob.pc, ch, n, safety=0.9)
        res = run_mc(prob.to_mc(dev), [ch], "gbma", [beta], steps, seeds,
                     pc=prob.pc, ota_impl=ota_impl, device=dev)
        emp, bound = res.mean[0], res.bounds[0]
        rows.append(f"{prefix}a,N={n},final_emp,{emp[-1]:.6e}")
        rows.append(f"{prefix}a,N={n},final_bound,{bound[-1]:.6e}")
        rows.append(f"{prefix}a,N={n},bound_holds,"
                    f"{int(np.all(emp <= bound * 1.05))}")
        rows += fmt_curve(f"{prefix}a_curve,N={n}", ks, emp, every=100,
                          ci95=res.ci95[0])
    n = n_grid[-1]
    prob = probs[n]
    chs = [ChannelConfig(fading=fading, scale=1.0, noise_std=1.0,
                         energy=float(n) ** (eps - 2.0))
           for eps in eps_grid]
    betas = [stepsize_theorem1(prob.pc, ch, n, safety=0.9) for ch in chs]
    res = run_mc(prob.to_mc(dev), chs, "gbma", betas, steps, seeds,
                 pc=prob.pc, ota_impl=ota_impl, device=dev)
    for i, eps in enumerate(eps_grid):
        rows.append(f"{prefix}b,eps={eps},final_emp,{res.mean[i][-1]:.6e}")
        rows.append(f"{prefix}b,eps={eps},final_bound,"
                    f"{res.bounds[i][-1]:.6e}")
        rows += fmt_curve(f"{prefix}b_curve,eps={eps}", ks, res.mean[i],
                          every=100, ci95=res.ci95[i])
    return rows


def run_fig2(device: DeviceLike = None, **overrides) -> list:
    """Fig. 2 rows (equal gains) at the reference's operating point, or
    with `n_grid` / `eps_grid` / `steps` / `seeds` overridden."""
    return run_msd_figure(**{**FIG2, **overrides}, device=device)


def run_fig3(device: DeviceLike = None, **overrides) -> list:
    """Fig. 3 rows (Rayleigh fading), as `run_fig2`."""
    return run_msd_figure(**{**FIG3, **overrides}, device=device)
