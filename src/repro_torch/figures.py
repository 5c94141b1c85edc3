"""The paper's figures on the port: twins of
`benchmarks/common.py::MSDProblem` / `run_msd_figure` (Figs. 2 and 3),
`fig4_fdm_comparison.py`, `fig5_localization.py`, `fig6_energy_scaling.py`,
`fig7_blind_transmitters.py`, `fig8_federated_logistic.py` and every part
of `ablations.py`, written out here because the port imports nothing of
the reference's `benchmarks`. Each issues the same `run_mc` calls as its
reference, row for row, and emits the same CSV rows.

Federated MSD-like regression (paper §VI-A), one sample per node. Figs.
2/3: (a) error vs iterations for each N of a node-count grid at E_N = 1,
one padded call, and (b) the energy sweep E_N = N^(ε−2) at the largest
N; both overlay the Theorem-1 bound. Fig. 4: gbma vs fdm vs centralized
in one mixed call. Fig. 5: source localization (paper §VI-B), gbma vs
fdm vs centralized in one call. Fig. 6: the energy to reach an error
target, one padded call over N. Fig. 7: blind transmitters at an
M-antenna edge, an N sweep and an M sweep, one call each. Fig. 8:
federated logistic regression with minibatches, an N sweep and a
batch-fraction sweep, one call each.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.mc.engine import energy_to_target, run_mc
from repro_torch.core.mc.problems import (MCProblem, MCProblemBatch,
                                          localization_mc_problem,
                                          logistic_mc_problem,
                                          quadratic_mc_problem)
from repro_torch.core.theory import ProblemConstants, stepsize_theorem1
from repro_torch.data.synthetic import (localization_field,
                                        logistic_classification,
                                        msd_like_regression)

LAMBDA = 0.5  # paper §VI-A: regularizer of Eq. (27)

# the operating points of benchmarks/fig2_equal_gains.py and fig3_rayleigh.py
FIG2 = {"fading": "equal", "prefix": "fig2", "n_grid": (50, 160, 500),
        "eps_grid": (0.5, 1.0, 1.5), "steps": 300, "seeds": 4}
FIG3 = {"fading": "rayleigh", "prefix": "fig3", "n_grid": (50, 160, 500),
        "eps_grid": (0.5, 1.0, 1.5), "steps": 300, "seeds": 4}
# benchmarks/fig4_fdm_comparison.py, fig5_localization.py,
# fig6_energy_scaling.py, fig7_blind_transmitters.py,
# fig8_federated_logistic.py, ablations.py
FIG4 = {"n": 800, "steps": 300, "seeds": 4}
FIG5 = {"n": 200, "steps": 3000, "seeds": 3}
FIG6 = {"n_grid": (100, 200, 400, 800), "steps": 400, "seeds": 3,
        "target": 1e-2}
FIG7 = {"n_grid": (50, 160, 500), "m": 32, "m_grid": (1, 4, 16, 64),
        "n": 160, "steps": 600, "seeds": 4}
FIG8 = {"n_grid": (20, 40, 80), "n": 40, "m": 16, "steps": 300, "seeds": 4}
ABLATIONS = {"n": 200, "steps": 300, "seeds": 3}
ABLATION_PARTS = ("a", "b", "c", "d", "e", "f", "g")


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
                   ota_impl: Optional[str] = None, plan=None) -> list:
    """Shared body of Figs. 2 (equal gains) and 3 (Rayleigh): the CSV rows
    of (a) the node-count sweep and (b) the energy sweep. `plan` passes
    through to `run_mc(plan=...)` (an `ExecPlan` or "auto"), as in
    `benchmarks/common.py`; None keeps `run_mc`'s defaults."""
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
                 plan=plan, device=dev)
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
                 pc=prob.pc, ota_impl=ota_impl, plan=plan, device=dev)
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


def _node_grad_sq(mc: MCProblem, theta0=None) -> np.ndarray:
    """`(N,)` f32 ‖g_n‖² of every node's gradient at θ₀ (default 0), from
    the problem's own grad row (the reference evaluates its closure
    `grad_fn` there)."""
    batch = MCProblemBatch.stack([mc])
    theta = batch.data["mask"].new_zeros((1, 1, mc.dim))
    if theta0 is not None:
        theta += torch.as_tensor(np.asarray(theta0, np.float32),
                                 device=theta.device)
    g0 = batch.grad_fn(batch.data, theta)[0, 0].cpu().numpy()
    return np.sum(g0**2, axis=1)


def _initial_energy_per_slot(mc: MCProblem, energy: float,
                             theta0=None) -> float:
    """Σ_n E_N ‖g_n‖² at θ₀ (default 0): the twin of `gbma.slot_energy`
    on the gradients at θ₀."""
    return energy * float(np.sum(_node_grad_sq(mc, theta0), dtype=np.float64))


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


FIG5_THETA0 = (45.0, 45.0)
FIG5_SIGNAL_A = 100.0


def fig5_call(device: DeviceLike = None, *, n: int, **_) -> tuple:
    """Fig. 5's one mixed call: (problem, channels, algos, betas) —
    localization with N sensors at -10 dB; gbma at E_N = N^-1.5, fdm at
    E_N = 1 and centralized GD, β = 1 (over μ_h for the channel rows)."""
    r, x, src, _ = localization_field(n, signal_a=FIG5_SIGNAL_A,
                                      snr_db=-10.0, seed=0)
    mc = localization_mc_problem(r, x, src, FIG5_SIGNAL_A,
                                 device=resolve_device(device))
    ch_gbma = ChannelConfig(fading="rayleigh", scale=1.0, noise_std=0.3,
                            energy=float(n) ** (-1.5))
    ch_fdm = ChannelConfig(fading="rayleigh", scale=1.0, noise_std=0.3,
                           energy=1.0)
    beta = 1.0
    return (mc, [ch_gbma, ch_fdm, ch_gbma], ("gbma", "fdm", "centralized"),
            [beta / ch_gbma.mu_h, beta / ch_gbma.mu_h, beta])


def run_fig5(device: DeviceLike = None, *, ota_impl: str = "auto",
             **overrides) -> list:
    """Fig. 5 rows (source localization, gbma vs fdm vs centralized from
    θ₀ = (45, 45), and (b) each channel's energy per slot at θ₀): the twin
    of `benchmarks/fig5_localization.py`, `n` / `steps` / `seeds`
    overridable."""
    cfg = {**FIG5, **overrides}
    dev = resolve_device(device)
    mc, chs, algos, betas = fig5_call(dev, **cfg)
    res = run_mc(mc, chs, algos, betas, cfg["steps"], cfg["seeds"],
                 theta0=np.array(FIG5_THETA0), invert_channel=False,
                 ota_impl=ota_impl, device=dev)
    e_g, e_f, e_c = res.mean
    rows = [f"fig5,final_sq_err,gbma,{e_g[-1]:.4e}",
            f"fig5,final_sq_err,fdm,{e_f[-1]:.4e}",
            f"fig5,final_sq_err,centralized,{e_c[-1]:.4e}",
            f"fig5,gbma_converges,{int(e_g[-1] < 0.1 * e_g[0])}"]
    for name, ch in (("gbma", chs[0]), ("fdm", chs[1])):
        energy = _initial_energy_per_slot(mc, ch.energy, FIG5_THETA0)
        rows.append(f"fig5,slot_energy,{name},{energy:.4e}")
    return rows


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


FIG7_BUDGET_FRAC = 0.25
FIG7_ALGOS = ("gbma", "blind", "blind_ec", "centralized")


def _fig7_channel(n: int) -> ChannelConfig:
    return ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                         energy=1.0 / float(n))


def _fig7_budget(mc: MCProblem) -> float:
    """blind_ec's per-node budget: a fraction of the mean ‖g_n‖² at 0."""
    return FIG7_BUDGET_FRAC * float(np.mean(_node_grad_sq(mc)))


def fig7_calls(device: DeviceLike = None, *, n_grid, m, m_grid, n,
               **_) -> list:
    """Fig. 7's two calls as (problems, channels, algos, betas, keyword
    arguments): (a) the N sweep at M antennas for the blind rows (gbma,
    blind, blind_ec, centralized per N; gbma and centralized at M = 1),
    and (b) the M sweep at N (blind and blind_ec per M). gbma steps at the
    Theorem-1 size, the rest at it times μ_h."""
    dev = resolve_device(device)
    probs = {k: MSDProblem.make(k) for k in n_grid}
    mcs, chs, algos, betas, ants, budgets = [], [], [], [], [], []
    for k in n_grid:
        mc = probs[k].to_mc(dev)
        ch = _fig7_channel(k)
        beta = stepsize_theorem1(probs[k].pc, ch, k, safety=0.9)
        for a in FIG7_ALGOS:
            mcs.append(mc)
            chs.append(ch)
            algos.append(a)
            betas.append(beta if a == "gbma" else beta * ch.mu_h)
            ants.append(m if a.startswith("blind") else 1)
            budgets.append(_fig7_budget(mc) if a == "blind_ec"
                           else float("inf"))
    calls = [(mcs, chs, tuple(algos), betas,
              {"n_antennas": tuple(ants), "power_budget": budgets})]
    prob = probs.get(n) or MSDProblem.make(n)
    mc = prob.to_mc(dev)
    ch = _fig7_channel(n)
    beta = stepsize_theorem1(prob.pc, ch, n, safety=0.9)
    bud = _fig7_budget(mc)
    algos, betas = ["gbma", "centralized"], [beta, beta * ch.mu_h]
    ants, budgets = [1, 1], [float("inf")] * 2
    for mm in m_grid:
        algos += ["blind", "blind_ec"]
        betas += [beta * ch.mu_h] * 2
        ants += [mm, mm]
        budgets += [float("inf"), bud]
    calls.append((mc, [ch] * len(algos), tuple(algos), betas,
                  {"n_antennas": tuple(ants), "power_budget": budgets}))
    return calls


def run_fig7(device: DeviceLike = None, *, ota_impl: str = "auto",
             **overrides) -> list:
    """Fig. 7 rows (blind transmitters: (a) the N sweep at a fixed M, (b)
    the M sweep at a fixed N): the twin of
    `benchmarks/fig7_blind_transmitters.py`, `n_grid` / `m` / `m_grid` /
    `n` / `steps` / `seeds` overridable."""
    cfg = {**FIG7, **overrides}
    dev = resolve_device(device)
    (mcs, chs, algos, betas, kw), call_b = fig7_calls(dev, **cfg)
    res = run_mc(mcs, chs, algos, betas, cfg["steps"], cfg["seeds"],
                 ota_impl=ota_impl, device=dev, **kw)
    rows = []
    na = len(FIG7_ALGOS)
    for i, k in enumerate(cfg["n_grid"]):
        fin = {a: res.mean[na * i + j][-1] for j, a in enumerate(FIG7_ALGOS)}
        for a in FIG7_ALGOS:
            rows.append(f"fig7a,N={k},M={cfg['m']},final_excess,{a},"
                        f"{fin[a]:.6e}")
        rows.append(f"fig7a,N={k},blind_within_10x_gbma,"
                    f"{int(fin['blind'] <= 10.0 * fin['gbma'])}")
    mc, chs, algos, betas, kw = call_b
    res = run_mc(mc, chs, algos, betas, cfg["steps"], cfg["seeds"],
                 ota_impl=ota_impl, device=dev, **kw)
    n = cfg["n"]
    fin_gbma, fin_cent = res.mean[0][-1], res.mean[1][-1]
    rows.append(f"fig7b,N={n},final_excess,gbma,{fin_gbma:.6e}")
    rows.append(f"fig7b,N={n},final_excess,centralized,{fin_cent:.6e}")
    fin_blind = []
    for i, mm in enumerate(cfg["m_grid"]):
        fb, fe = res.mean[2 + 2 * i][-1], res.mean[3 + 2 * i][-1]
        fin_blind.append(fb)
        rows.append(f"fig7b,N={n},M={mm},final_excess,blind,{fb:.6e}")
        rows.append(f"fig7b,N={n},M={mm},final_excess,blind_ec,{fe:.6e}")
    init = float(np.mean(res.risks[3::2, :, 0]))
    fin_ec = float(np.mean(res.risks[3::2, :, -1]))
    rows.append(f"fig7b,blind_improves_with_M,"
                f"{int(fin_blind[-1] < fin_blind[0])}")
    rows.append(f"fig7b,blind_maxM_within_2x_gbma,"
                f"{int(fin_blind[-1] <= 2.0 * fin_gbma)}")
    rows.append(f"fig7b,blind_ec_converges,{int(fin_ec < 0.5 * init)}")
    return rows


FIG8_SAMPLES_PER_NODE = 6
FIG8_DIM = 16
FIG8_LAMBDA = 0.1
FIG8_BATCH_FRAC = 0.5
FIG8_FRAC_GRID = (1.0, 0.5, 0.25)
FIG8_ALGOS = ("gbma", "blind", "centralized")


def _fig8_problem(n: int, device) -> tuple:
    """(logistic problem over n nodes of 6 samples each, 1/L) with L the
    logistic smoothness bound 0.25 λ_max(XᵀX/n) + λ."""
    X, y, _ = logistic_classification(n * FIG8_SAMPLES_PER_NODE,
                                      dim=FIG8_DIM, seed=0)
    prob = logistic_mc_problem(X, y, n, lam=FIG8_LAMBDA, device=device)
    L = 0.25 * float(np.linalg.eigvalsh(X.T @ X / X.shape[0])[-1]) \
        + FIG8_LAMBDA
    return prob, 1.0 / L


def _fig8_channel(n: int) -> ChannelConfig:
    return ChannelConfig(fading="rayleigh", scale=1.0, noise_std=0.5,
                         energy=1.0 / float(n))


def fig8_calls(device: DeviceLike = None, *, n_grid, n, m, **_) -> list:
    """Fig. 8's two calls as (problems, channels, algos, betas, keyword
    arguments): (a) the N sweep at minibatch fraction 1/2 (gbma, blind at
    M antennas, centralized per N) and (b) the batch-fraction sweep of
    gbma at N."""
    dev = resolve_device(device)
    probs, chs, algos, betas, ants = [], [], [], [], []
    for k in n_grid:
        prob, beta = _fig8_problem(k, dev)
        ch = _fig8_channel(k)
        for a in FIG8_ALGOS:
            probs.append(prob)
            chs.append(ch)
            algos.append(a)
            # gbma's superposition carries the mean gain μ_h; blind (MRC-
            # normalized) and centralized see a gain of about 1
            betas.append(beta / ch.mu_h if a == "gbma" else beta)
            ants.append(m if a == "blind" else 1)
    calls = [(probs, chs, tuple(algos), betas,
              {"n_antennas": tuple(ants), "batch_frac": FIG8_BATCH_FRAC})]
    prob, beta = _fig8_problem(n, dev)
    ch = _fig8_channel(n)
    k = len(FIG8_FRAC_GRID)
    calls.append((prob, [ch] * k, "gbma", [beta / ch.mu_h] * k,
                  {"batch_frac": FIG8_FRAC_GRID}))
    return calls


def run_fig8(device: DeviceLike = None, *, ota_impl: str = "auto",
             **overrides) -> list:
    """Fig. 8 rows (federated logistic regression: (a) the N sweep at
    minibatch fraction 1/2, (b) the batch-fraction sweep at a fixed N):
    the twin of `benchmarks/fig8_federated_logistic.py`, `n_grid` / `n` /
    `m` / `steps` / `seeds` overridable."""
    cfg = {**FIG8, **overrides}
    dev = resolve_device(device)
    (probs, chs, algos, betas, kw), call_b = fig8_calls(dev, **cfg)
    res = run_mc(probs, chs, algos, betas, cfg["steps"], cfg["seeds"],
                 ota_impl=ota_impl, device=dev, **kw)
    rows = []
    na = len(FIG8_ALGOS)
    for i, k in enumerate(cfg["n_grid"]):
        init = res.mean[na * i][0]
        fin = {a: res.mean[na * i + j][-1] for j, a in enumerate(FIG8_ALGOS)}
        for a in FIG8_ALGOS:
            rows.append(f"fig8a,N={k},frac={FIG8_BATCH_FRAC},final_excess,"
                        f"{a},{fin[a]:.6e}")
        rows.append(f"fig8a,N={k},gbma_converges,"
                    f"{int(fin['gbma'] < 0.5 * init)}")
        rows.append(f"fig8a,N={k},blind_within_10x_gbma,"
                    f"{int(fin['blind'] <= 10.0 * max(fin['gbma'], 1e-12))}")
    prob, chs, algos, betas, kw = call_b
    res = run_mc(prob, chs, algos, betas, cfg["steps"], cfg["seeds"],
                 ota_impl=ota_impl, device=dev, **kw)
    n = cfg["n"]
    init = res.mean[0][0]
    for i, f in enumerate(FIG8_FRAC_GRID):
        fin = res.mean[i][-1]
        rows.append(f"fig8b,N={n},frac={f},final_excess,{fin:.6e}")
        rows.append(f"fig8b,N={n},frac={f},converges,"
                    f"{int(fin < 0.5 * init)}")
    for i, f in enumerate(FIG8_FRAC_GRID):
        tot = float(np.mean(res.cum_energy[i, :, -1]))
        rows.append(f"fig8b,N={n},frac={f},total_energy,{tot:.6e}")
    return rows


def ablation_calls(part: str, prob: MSDProblem, n: int) -> list:
    """The `run_mc` calls of one ablation part, as (label, channels,
    algos, betas, keyword arguments, steps factor) — those of
    `benchmarks/ablations.py`, call for call; part (d) runs twice the
    steps."""
    if part == "a":  # phase-error sweep: one call
        phis = [max(frac * np.pi, 1e-9)
                for frac in (0.0, 0.125, 0.25, 0.4, 0.49)]
        chs = [ChannelConfig(fading="rayleigh", noise_std=0.5,
                             phase_error_max=phi) for phi in phis]
        betas = [stepsize_theorem1(prob.pc, ch, n, safety=0.8) for ch in chs]
        return [(phis, chs, "gbma", betas, {}, 1)]
    if part == "b":  # fading families: one call per family
        calls = []
        for fading, kw in (("equal", {}), ("rayleigh", {}),
                           ("rician", {"rician_k": 4.0}),
                           ("lognormal", {"scale": 0.5})):
            ch = ChannelConfig(fading=fading, noise_std=0.5, **kw)
            beta = stepsize_theorem1(prob.pc, ch, n, safety=0.8)
            calls.append((fading, [ch], "gbma", [beta], {}, 1))
        return calls
    if part == "c":  # power control vs gbma at equal energy
        ch = ChannelConfig(fading="rayleigh", noise_std=0.5,
                           energy=float(n) ** (-1.0))
        beta = stepsize_theorem1(prob.pc, ch, n, safety=0.8)
        return [("gbma", [ch], "gbma", [beta], {}, 1),
                ("truncated_inversion", [ch], "power_control",
                 [beta * ch.mu_h], {"h_min": 0.3}, 1)]
    if part == "d":  # multi-antenna edge: one call per M, twice the steps
        ch = ChannelConfig(fading="rayleigh", noise_std=0.5)
        pc = prob.pc
        calls = []
        for m_ant in (1, 4, 16):
            # each M at the Theorem-1 stepsize designed for its effective
            # distortion σ_h² / M
            sh2 = ch.sigma_h2 / m_ant
            b1 = 2.0 / (ch.mu_h * (pc.mu + pc.L))
            b2 = (2.0 * ch.mu_h * pc.mu * pc.L * n
                  / (sh2 * pc.L_bar**2 * (1.0 + 2.0 * pc.delta)
                     * (pc.mu + pc.L)))
            calls.append((m_ant, [ch], "gbma", [0.8 * min(b1, b2)],
                          {"n_antennas": m_ant}, 2))
        return calls
    if part == "e":  # gbma / heavy-ball / Nesterov per row, one call per γ
        ch = ChannelConfig(fading="rayleigh", noise_std=0.5)
        beta = stepsize_theorem1(prob.pc, ch, n, safety=0.8)
        return [(gamma, [ch, ch, ch], ("gbma", "momentum", "nesterov"),
                 [beta, beta * (1 - gamma), beta * (1 - gamma)],
                 {"momentum": gamma}, 1) for gamma in (0.5, 0.9)]
    if part == "f":  # blind transmitters: budgets per row, one call
        ch = ChannelConfig(fading="rayleigh", noise_std=0.5, energy=1.0 / n)
        beta = stepsize_theorem1(prob.pc, ch, n, safety=0.8) * ch.mu_h
        ref_sq = float(np.mean(_node_grad_sq(prob.to_mc("cpu"))))
        fracs = (np.inf, 1.0, 0.25, 0.05)  # budget / initial mean ‖g_n‖²
        algos = tuple("blind" if not np.isfinite(f) else "blind_ec"
                      for f in fracs)
        budgets = [float(f) * ref_sq if np.isfinite(f) else float("inf")
                   for f in fracs]
        return [(fracs, [ch] * len(fracs), algos, [beta] * len(fracs),
                 {"n_antennas": 16, "power_budget": budgets}, 1)]
    if part == "g":  # participation per row: one call
        ch = ChannelConfig(fading="rayleigh", noise_std=0.5)
        beta = stepsize_theorem1(prob.pc, ch, n, safety=0.8)
        ps = (1.0, 0.9, 0.7, 0.5, 0.3)
        return [(ps, [ch] * len(ps), "gbma", [beta] * len(ps),
                 {"participation": list(ps)}, 1)]
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
    if part == "d":
        return [f"ablation_antennas,M={label},final={res.mean[0][-1]:.4e}"]
    if part == "e":
        return [f"ablation_accel,gamma={label},{a},final={emp[-1]:.4e}"
                for a, emp in zip(algos, res.mean)]
    if part == "f":
        return [f"ablation_blind_budget,frac="
                f"{'inf(blind)' if not np.isfinite(f) else f'{f:g}'},"
                f"final={emp[-1]:.4e}" for f, emp in zip(label, res.mean)]
    return [f"ablation_participation,p={p:g},final={emp[-1]:.4e}"
            for p, emp in zip(label, res.mean)]


def run_ablations(device: DeviceLike = None, *,
                  parts: tuple = ABLATION_PARTS, ota_impl: str = "auto",
                  **overrides) -> list:
    """Rows of the given parts of `benchmarks/ablations.py` (its order),
    `n` / `steps` / `seeds` overridable: (a) phase error, (b) fading
    families, (c) power control, (d) a multi-antenna edge, (e) momentum /
    Nesterov, (f) blind transmitters' power budget, (g) participation."""
    cfg = {**ABLATIONS, **overrides}
    dev = resolve_device(device)
    n = cfg["n"]
    prob = MSDProblem.make(n)
    mc = prob.to_mc(dev)
    rows = []
    for part in sorted(parts):
        for label, chs, algos, betas, kw, factor in ablation_calls(
                part, prob, n):
            res = run_mc(mc, chs, algos, betas, factor * cfg["steps"],
                         cfg["seeds"], ota_impl=ota_impl, device=dev, **kw)
            rows += _ablation_rows(part, label, chs, algos, res)
    return rows
