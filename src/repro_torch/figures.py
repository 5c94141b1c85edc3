"""The paper's figures on the port: twins of
`benchmarks/common.py::MSDProblem` / `run_msd_figure` (Figs. 2 and 3),
`fig4_fdm_comparison.py`, `fig6_energy_scaling.py` and parts (a), (b),
(c), (e) and (g) of `ablations.py`, written out here because the port
imports nothing of the reference's `benchmarks`. Each issues the same
`run_mc` calls as its reference, row for row, and emits the same CSV
rows.

Federated MSD-like regression (paper §VI-A), one sample per node. Figs.
2/3: (a) error vs iterations for each N of a node-count grid at E_N = 1,
one padded call, and (b) the energy sweep E_N = N^(ε−2) at the largest
N; both overlay the Theorem-1 bound. Fig. 4: gbma vs fdm vs centralized
in one mixed call. Fig. 6: the energy to reach an error target, one
padded call over N. Ablations (d) and (f) need antennas (ROADMAP P3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.mc.engine import energy_to_target, run_mc
from repro_torch.core.mc.problems import (MCProblem, MCProblemBatch,
                                          quadratic_mc_problem)
from repro_torch.core.theory import ProblemConstants, stepsize_theorem1
from repro_torch.data.synthetic import msd_like_regression

LAMBDA = 0.5  # paper §VI-A: regularizer of Eq. (27)

# the operating points of benchmarks/fig2_equal_gains.py and fig3_rayleigh.py
FIG2 = {"fading": "equal", "prefix": "fig2", "n_grid": (50, 160, 500),
        "eps_grid": (0.5, 1.0, 1.5), "steps": 300, "seeds": 4}
FIG3 = {"fading": "rayleigh", "prefix": "fig3", "n_grid": (50, 160, 500),
        "eps_grid": (0.5, 1.0, 1.5), "steps": 300, "seeds": 4}
# benchmarks/fig4_fdm_comparison.py, fig6_energy_scaling.py, ablations.py
FIG4 = {"n": 800, "steps": 300, "seeds": 4}
FIG6 = {"n_grid": (100, 200, 400, 800), "steps": 400, "seeds": 3,
        "target": 1e-2}
ABLATIONS = {"n": 200, "steps": 300, "seeds": 3}
ABLATION_PARTS = ("a", "b", "c", "e", "g")


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
    probs = [MSDProblem.make(n) for n in n_grid]
    chs = [ChannelConfig(fading=fading, scale=1.0, noise_std=1.0,
                         energy=1.0) for _ in n_grid]
    betas = [stepsize_theorem1(p.pc, ch, n, safety=0.9)
             for p, ch, n in zip(probs, chs, n_grid)]
    res = run_mc([p.to_mc(dev) for p in probs], chs, "gbma", betas, steps,
                 seeds, pc=[p.pc for p in probs], ota_impl=ota_impl,
                 device=dev)
    for i, n in enumerate(n_grid):
        emp, bound = res.mean[i], res.bounds[i]
        rows.append(f"{prefix}a,N={n},final_emp,{emp[-1]:.6e}")
        rows.append(f"{prefix}a,N={n},final_bound,{bound[-1]:.6e}")
        rows.append(f"{prefix}a,N={n},bound_holds,"
                    f"{int(np.all(emp <= bound * 1.05))}")
        rows += fmt_curve(f"{prefix}a_curve,N={n}", ks, emp, every=100,
                          ci95=res.ci95[i])
    n = n_grid[-1]
    prob = probs[-1]
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


def _initial_energy_per_slot(mc: MCProblem, energy: float) -> float:
    """Σ_n E_N ‖g_n‖² at θ = 0 from the problem's own grad row (the
    reference evaluates its closure `grad_fn` there)."""
    batch = MCProblemBatch.stack([mc])
    theta = batch.data["mask"].new_zeros((1, 1, mc.dim))
    g0 = batch.grad_fn(batch.data, theta)
    return energy * float(torch.sum(g0.double() ** 2))


def fig4_call(device: DeviceLike = None, *, n: int, **_) -> tuple:
    """Fig. 4's one mixed call: (problem, channels, algos, betas) — gbma
    at E_N = N^-1.5, fdm over dedicated fading channels at E_N = 1, and
    centralized GD at β·μ_h."""
    prob = MSDProblem.make(n)
    ch_gbma = ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                            energy=float(n) ** (-1.5))
    ch_fdm = ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                           energy=1.0)
    beta = stepsize_theorem1(prob.pc, ch_gbma, n, safety=0.9)
    return (prob.to_mc(resolve_device(device)), [ch_gbma, ch_fdm, ch_gbma],
            ("gbma", "fdm", "centralized"),
            [beta, beta, beta * ch_gbma.mu_h])


def run_fig4(device: DeviceLike = None, *, ota_impl: str = "auto",
             **overrides) -> list:
    """Fig. 4 rows (GBMA vs FDM-GD vs centralized GD, Rayleigh): the twin
    of `benchmarks/fig4_fdm_comparison.py`, `n` / `steps` / `seeds`
    overridable."""
    cfg = {**FIG4, **overrides}
    dev = resolve_device(device)
    mc, chs, algos, betas = fig4_call(dev, **cfg)
    res = run_mc(mc, chs, algos, betas, cfg["steps"], cfg["seeds"],
                 invert_channel=False, ota_impl=ota_impl, device=dev)
    emp_g, emp_f, emp_c = res.mean
    e_gbma = _initial_energy_per_slot(mc, chs[0].energy)
    e_fdm = _initial_energy_per_slot(mc, chs[1].energy)
    return [
        f"fig4,energy_per_slot,gbma,{e_gbma:.4e}",
        f"fig4,energy_per_slot,fdm,{e_fdm:.4e}",
        f"fig4,energy_ratio_fdm_over_gbma,{e_fdm / e_gbma:.4e}",
        f"fig4,final_excess,gbma,{emp_g[-1]:.6e}",
        f"fig4,final_excess,fdm,{emp_f[-1]:.6e}",
        f"fig4,final_excess,centralized,{emp_c[-1]:.6e}",
        f"fig4,gbma_comparable_or_better,"
        f"{int(emp_g[-1] <= 1.5 * emp_f[-1])}",
        f"fig4,gbma_energy_saving_over_1e4,{int(e_fdm / e_gbma > 1e4)}",
    ]


def fig6_call(device: DeviceLike = None, *, n_grid, **_) -> tuple:
    """Fig. 6's one padded call: (problems, channels, betas), gbma at
    E_N = N^-1.5 for each N."""
    probs = [MSDProblem.make(n) for n in n_grid]
    chs = [ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                         energy=float(n) ** (-1.5)) for n in n_grid]
    betas = [stepsize_theorem1(p.pc, ch, n, safety=0.9)
             for p, ch, n in zip(probs, chs, n_grid)]
    dev = resolve_device(device)
    return [p.to_mc(dev) for p in probs], chs, betas


def run_fig6(device: DeviceLike = None, *, ota_impl: str = "auto",
             **overrides) -> list:
    """Fig. 6 rows (total energy to reach the error target falls with N):
    the twin of `benchmarks/fig6_energy_scaling.py`, `n_grid` / `steps` /
    `seeds` / `target` overridable."""
    cfg = {**FIG6, **overrides}
    dev = resolve_device(device)
    mcs, chs, betas = fig6_call(dev, **cfg)
    res = run_mc(mcs, chs, "gbma", betas, cfg["steps"], cfg["seeds"],
                 ota_impl=ota_impl, device=dev)
    target = cfg["target"]
    totals = [float(t) for t in energy_to_target(res, target)]
    rows = [f"fig6,N={n},total_energy_to_err_{target},{tot:.4e}"
            for n, tot in zip(cfg["n_grid"], totals)]
    rows.append(f"fig6,energy_decreases_with_N,"
                f"{int(all(a > b for a, b in zip(totals, totals[1:])))}")
    return rows


def ablation_calls(part: str, prob: MSDProblem, n: int) -> list:
    """The `run_mc` calls of one ablation part, as (label, channels,
    algos, betas, keyword arguments) — those of `benchmarks/ablations.py`,
    call for call. Parts (d) and (f) need antennas (ROADMAP P3)."""
    if part == "a":  # phase-error sweep: one call
        phis = [max(frac * np.pi, 1e-9)
                for frac in (0.0, 0.125, 0.25, 0.4, 0.49)]
        chs = [ChannelConfig(fading="rayleigh", noise_std=0.5,
                             phase_error_max=phi) for phi in phis]
        betas = [stepsize_theorem1(prob.pc, ch, n, safety=0.8) for ch in chs]
        return [(phis, chs, "gbma", betas, {})]
    if part == "b":  # fading families: one call per family
        calls = []
        for fading, kw in (("equal", {}), ("rayleigh", {}),
                           ("rician", {"rician_k": 4.0}),
                           ("lognormal", {"scale": 0.5})):
            ch = ChannelConfig(fading=fading, noise_std=0.5, **kw)
            beta = stepsize_theorem1(prob.pc, ch, n, safety=0.8)
            calls.append((fading, [ch], "gbma", [beta], {}))
        return calls
    if part == "c":  # power control vs gbma at equal energy
        ch = ChannelConfig(fading="rayleigh", noise_std=0.5,
                           energy=float(n) ** (-1.0))
        beta = stepsize_theorem1(prob.pc, ch, n, safety=0.8)
        return [("gbma", [ch], "gbma", [beta], {}),
                ("truncated_inversion", [ch], "power_control",
                 [beta * ch.mu_h], {"h_min": 0.3})]
    if part == "e":  # gbma / heavy-ball / Nesterov per row, one call per γ
        ch = ChannelConfig(fading="rayleigh", noise_std=0.5)
        beta = stepsize_theorem1(prob.pc, ch, n, safety=0.8)
        return [(gamma, [ch, ch, ch], ("gbma", "momentum", "nesterov"),
                 [beta, beta * (1 - gamma), beta * (1 - gamma)],
                 {"momentum": gamma}) for gamma in (0.5, 0.9)]
    if part == "g":  # participation per row: one call
        ch = ChannelConfig(fading="rayleigh", noise_std=0.5)
        beta = stepsize_theorem1(prob.pc, ch, n, safety=0.8)
        ps = (1.0, 0.9, 0.7, 0.5, 0.3)
        return [(ps, [ch] * len(ps), "gbma", [beta] * len(ps),
                 {"participation": list(ps)})]
    raise ValueError(f"unknown ablation part {part!r}")


def _ablation_rows(part: str, label, chs, algos, res) -> list:
    if part == "a":
        return [f"ablation_phase,phi_max={phi:.3f}rad,mu_h={ch.mu_h:.3f},"
                f"final={emp[-1]:.4e}"
                for ch, phi, emp in zip(chs, label, res.mean)]
    if part == "b":
        return [f"ablation_fading,{label},D={chs[0].dispersion:.3f},"
                f"final={res.mean[0][-1]:.4e}"]
    if part == "c":
        return [f"ablation_powerctl,{label},final={res.mean[0][-1]:.4e}"]
    if part == "e":
        return [f"ablation_accel,gamma={label},{a},final={emp[-1]:.4e}"
                for a, emp in zip(algos, res.mean)]
    return [f"ablation_participation,p={p:g},final={emp[-1]:.4e}"
            for p, emp in zip(label, res.mean)]


def run_ablations(device: DeviceLike = None, *,
                  parts: tuple = ABLATION_PARTS, ota_impl: str = "auto",
                  **overrides) -> list:
    """Rows of the given parts of `benchmarks/ablations.py` (its order),
    `n` / `steps` / `seeds` overridable: (a) phase error, (b) fading
    families, (c) power control, (e) momentum / Nesterov, (g)
    participation."""
    later = sorted(set(parts) & {"d", "f"})
    if later:
        raise NotImplementedError(
            f"ablation parts {later} need a multi-antenna edge; not ported "
            "yet (ROADMAP P3: antennas and MRC, with blind and blind_ec)")
    cfg = {**ABLATIONS, **overrides}
    dev = resolve_device(device)
    n = cfg["n"]
    prob = MSDProblem.make(n)
    mc = prob.to_mc(dev)
    rows = []
    for part in sorted(parts):
        for label, chs, algos, betas, kw in ablation_calls(part, prob, n):
            res = run_mc(mc, chs, algos, betas, cfg["steps"], cfg["seeds"],
                         ota_impl=ota_impl, device=dev, **kw)
            rows += _ablation_rows(part, label, chs, algos, res)
    return rows
