"""The port's Monte Carlo main path against the JAX reference, on the CPU.

`repro_torch.core.mc.engine.run_mc` vs `repro.core.mc.engine.run_mc` on
an MSD-like quadratic problem carried across with `problem_from_arrays`
(N = 48, d = 16, 40 steps, 2 seeds, 2 rows): gbma under rayleigh, equal
and rician with phase error 0.3, centralized, momentum and nesterov, with
per-seed curves kept and reduced on the device. Then the calls of the
figure sweeps at N in {8, 13, 20}: a padded node-count sweep, mixed
algorithm rows, fdm with and without channel inversion, power_control,
per-row participation and a call combining padding, fdm and
participation; and the port's padded call against its own per-N calls.

Then the antenna paths (N = 13 or padded {8, 13}, 40 steps): gbma at a
static M (1 included) and per-row M, blind and blind_ec at static and
per-row M with binding and unbounded power budgets, with participation
and mixed with gbma and centralized rows (fig7's call shape); and the
problem kinds: localization (gbma / fdm / centralized from θ₀ = (45, 45),
padded) and logistic, full-batch and with minibatches (scalar and
per-row `batch_frac`, padded, mixed with blind rows: fig8's shapes).

Bars: risks, mean and cum_energy within rtol 1e-5 (the engine-parity bar
the repo uses; normals differ by an ulp and the iteration is contractive).
ci95 is a spread across seeds — a difference of nearly equal risks — so
its error is bounded by the risks' error, not by its own size: it is held
to rtol 1e-5 plus atol 1e-5·|mean|. The logistic risk is an excess
F − F* of an f32 objective F ≈ 0.5, and θ drifts by ulps between the
packages along a trajectory, which moves F − F* of one seed at one step
past 1e-5 relative in the minibatch cases: its risks and mean also take
atol 4 ulps of F* (ROADMAP §3, F8). Theorem-1 bounds and energy_to_target
within 1e-6. The figure twins (`repro_torch.figures`) emit the same
rows as `benchmarks.fig2_equal_gains`, `fig3_rayleigh`,
`fig4_fdm_comparison`, `fig5_localization`, `fig6_energy_scaling`,
`fig7_blind_transmitters`, `fig8_federated_logistic` and every part of
`ablations` at the smoke test's tiny constants.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from test_torch_helpers import (jax_original_layout, port_channel,  # noqa: E402
                                port_pc, port_problem, rel_err)

import benchmarks.ablations as ablations_ref  # noqa: E402
import benchmarks.fig2_equal_gains as fig2_ref  # noqa: E402
import benchmarks.fig3_rayleigh as fig3_ref  # noqa: E402
import benchmarks.fig4_fdm_comparison as fig4_ref  # noqa: E402
import benchmarks.fig5_localization as fig5_ref  # noqa: E402
import benchmarks.fig6_energy_scaling as fig6_ref  # noqa: E402
import benchmarks.fig7_blind_transmitters as fig7_ref  # noqa: E402
import benchmarks.fig8_federated_logistic as fig8_ref  # noqa: E402
from benchmarks.common import MSDProblem  # noqa: E402
from repro.core.channel import ChannelConfig  # noqa: E402
from repro.core.mc.engine import energy_to_target as jax_energy  # noqa: E402
from repro.core.mc.engine import run_mc as jax_run_mc  # noqa: E402
from repro.core.montecarlo import (localization_mc_problem,  # noqa: E402
                                   logistic_mc_problem)
from repro.core.theory import stepsize_theorem1  # noqa: E402
from repro.data.synthetic import (localization_field,  # noqa: E402
                                  logistic_classification)
from repro_torch.core.mc import engine  # noqa: E402
from repro_torch.kernels.ota import ops  # noqa: E402
from repro_torch.figures import (run_ablations, run_fig2,  # noqa: E402
                                 run_fig3, run_fig4, run_fig5, run_fig6,
                                 run_fig7, run_fig8)

N, D, STEPS, SEEDS = 48, 16, 40, 2


@pytest.fixture(scope="module")
def msd():
    prob = MSDProblem.make(N, dim=D)
    jp = prob.to_mc()
    return prob, jp, port_problem(jp)


def _rows(prob, fading, phase_error_max):
    cfgs = [ChannelConfig(fading=fading, scale=1.0, noise_std=1.0,
                          energy=e, phase_error_max=phase_error_max)
            for e in (1.0, 0.5)]
    betas = [0.5 * stepsize_theorem1(prob.pc, c, N, safety=0.9)
             for c in cfgs]
    return cfgs, betas


def _assert_parity(out, ref, risk_atol: float = 0.0):
    np.testing.assert_allclose(out.mean, ref.mean, rtol=1e-5,
                               atol=risk_atol)
    assert np.all(np.abs(out.ci95 - ref.ci95)
                  <= 1e-5 * np.abs(ref.ci95) + 1e-5 * np.abs(ref.mean)
                  + risk_atol)
    if ref.risks is None:
        assert out.risks is None and out.cum_energy is None
    else:
        np.testing.assert_allclose(out.risks, ref.risks, rtol=1e-5,
                                   atol=risk_atol)
        np.testing.assert_allclose(out.cum_energy, ref.cum_energy,
                                   rtol=1e-5, atol=0)
    if ref.bounds is None:
        assert out.bounds is None
    else:
        assert rel_err(out.bounds, ref.bounds) <= 1e-6


CASES = [
    ("gbma", "rayleigh", 0.0, True),
    ("gbma", "rayleigh", 0.0, False),
    ("gbma", "equal", 0.0, True),
    ("gbma", "rician", 0.3, True),
    ("centralized", "rayleigh", 0.0, True),
    ("momentum", "rayleigh", 0.0, True),
    ("nesterov", "rayleigh", 0.0, True),
    ("nesterov", "rayleigh", 0.0, False),
]


@pytest.mark.parametrize("algo,fading,phase_error_max,keep", CASES)
def test_run_mc_matches_reference(msd, algo, fading, phase_error_max, keep):
    prob, jp, tp = msd
    cfgs, betas = _rows(prob, fading, phase_error_max)
    with jax_original_layout():
        ref = jax_run_mc(jp, cfgs, algo, betas, STEPS, SEEDS, pc=prob.pc,
                         keep_seed_curves=keep)
    out = engine.run_mc(tp, [port_channel(c) for c in cfgs], algo, betas,
                        STEPS, SEEDS, pc=port_pc(prob.pc),
                        keep_seed_curves=keep, device="cpu")
    assert out.mean.shape == (2, STEPS + 1)
    _assert_parity(out, ref)
    if keep:
        # a target between the curves' values, away from any crossing
        target = float(np.exp(np.mean(np.log(ref.risks))))
        np.testing.assert_allclose(engine.energy_to_target(out, target),
                                   jax_energy(ref, target), rtol=1e-6)


def test_run_mc_matches_pallas_reference(msd):
    """The reference through its Pallas OTA kernel (interpret mode) vs the
    port through its OTA wrapper's plain route."""
    prob, jp, tp = msd
    cfgs, betas = _rows(prob, "rayleigh", 0.0)
    with jax_original_layout():
        ref = jax_run_mc(jp, cfgs, "gbma", betas, STEPS, SEEDS, pc=prob.pc,
                         ota_impl="pallas")
    out = engine.run_mc(tp, [port_channel(c) for c in cfgs], "gbma", betas,
                        STEPS, SEEDS, pc=port_pc(prob.pc), ota_impl="ref",
                        device="cpu")
    _assert_parity(out, ref)


def test_auto_route_on_the_cpu_is_the_plain_version(msd):
    """Under 'auto' a CPU run goes through the OTA wrapper's plain version
    (no kernel launch): bit for bit the explicit 'ref' route."""
    prob, _, tp = msd
    cfgs, betas = _rows(prob, "rayleigh", 0.0)
    chs = [port_channel(c) for c in cfgs]
    before = ops.launch_count
    auto = engine.run_mc(tp, chs, "gbma", betas, 12, 3, device="cpu")
    ref = engine.run_mc(tp, chs, "gbma", betas, 12, 3, ota_impl="ref",
                        device="cpu")
    assert ops.launch_count == before
    np.testing.assert_array_equal(auto.risks, ref.risks)
    np.testing.assert_array_equal(auto.cum_energy, ref.cum_energy)
    with pytest.raises(ValueError, match="ota_impl"):
        engine.run_mc(tp, chs, "gbma", betas, 12, 3, ota_impl="inline",
                      device="cpu")


def test_slice_result_views_rows(msd):
    prob, _, tp = msd
    cfgs, betas = _rows(prob, "rayleigh", 0.0)
    chs = [port_channel(c) for c in cfgs]
    base = engine.run_mc(tp, chs, "gbma", betas, 12, 3,
                         keep_seed_curves=False, device="cpu")
    row1 = engine.slice_result(base, [1])
    np.testing.assert_array_equal(row1.mean, base.mean[1:])
    np.testing.assert_array_equal(row1.ci95, base.ci95[1:])
    assert row1.risks is None and row1.device == base.device


def _parse(row: str):
    """A figure row -> (key fields, main value, ±ci95 or None); a last
    field `name=value` (the ablation rows) keys on its name."""
    parts = row.split(",")
    if parts[-1].startswith("±"):
        return tuple(parts[:-2]), float(parts[-2]), float(parts[-1][1:])
    name, _, value = parts[-1].rpartition("=")
    return tuple(parts[:-1]) + (name,), float(value), None


# the smoke test's tiny constants (tests/test_figures_smoke.py)
TINY = {"STEPS": 6, "SEEDS": 2, "N": 16, "N_GRID": (8, 13),
        "EPS_GRID": (1.0, 1.5), "M": 3, "M_GRID": (1, 4)}
FIGS = {"fig2": (fig2_ref, run_fig2), "fig3": (fig3_ref, run_fig3),
        "fig4": (fig4_ref, run_fig4), "fig5": (fig5_ref, run_fig5),
        "fig6": (fig6_ref, run_fig6), "fig7": (fig7_ref, run_fig7),
        "fig8": (fig8_ref, run_fig8)}
# the row prefix of each ablation part
ABLATION_ROWS = {"a": "ablation_phase", "b": "ablation_fading",
                 "c": "ablation_powerctl", "d": "ablation_antennas",
                 "e": "ablation_accel", "f": "ablation_blind_budget",
                 "g": "ablation_participation"}


def _twin_kwargs(mod) -> dict:
    names = {"STEPS": "steps", "SEEDS": "seeds", "N": "n",
             "N_GRID": "n_grid", "EPS_GRID": "eps_grid", "M": "m",
             "M_GRID": "m_grid"}
    return {key: TINY[attr] for attr, key in names.items()
            if hasattr(mod, attr)}


def _tiny_reference_rows(mod) -> list:
    with pytest.MonkeyPatch.context() as mp:
        for attr, val in TINY.items():
            if hasattr(mod, attr):
                mp.setattr(mod, attr, val)
        with jax_original_layout():
            return mod.run(verbose=False)


def _assert_rows_match(rows, ref_rows):
    assert len(rows) == len(ref_rows) and rows
    for row, ref in zip(rows, ref_rows):
        key, val, ci = _parse(row)
        rkey, rval, rci = _parse(ref)
        assert key == rkey
        assert abs(val - rval) <= 1e-5 * abs(rval), (row, ref)
        if rci is not None:
            # ±ci95 prints 3 significant digits: equal up to that rounding
            assert abs(ci - rci) <= 0.01 * abs(rci) + 1e-5 * abs(rval)


@pytest.mark.parametrize("name", sorted(FIGS))
def test_fig_twin_matches_reference_rows(name):
    ref_mod, run_twin = FIGS[name]
    ref_rows = _tiny_reference_rows(ref_mod)
    _assert_rows_match(run_twin(device="cpu", **_twin_kwargs(ref_mod)),
                       ref_rows)


@pytest.fixture(scope="module")
def ablation_reference_rows():
    return _tiny_reference_rows(ablations_ref)


@pytest.mark.parametrize("part", sorted(ABLATION_ROWS))
def test_ablation_twin_matches_reference_rows(part, ablation_reference_rows):
    prefix = ABLATION_ROWS[part] + ","
    ref_rows = [r for r in ablation_reference_rows if r.startswith(prefix)]
    rows = run_ablations(device="cpu", parts=(part,),
                         **_twin_kwargs(ablations_ref))
    _assert_rows_match(rows, ref_rows)


# ------------------------------------------ node-count sweeps, mixed rows
SWEEP_N = (8, 13, 20)


@pytest.fixture(scope="module")
def sweep():
    probs = [MSDProblem.make(n, dim=D) for n in SWEEP_N]
    jps = [p.to_mc() for p in probs]
    return probs, jps, [port_problem(jp) for jp in jps]


# (row node counts, algos, fading, keyword arguments, keep_seed_curves)
SWEEP_CASES = {
    "padded": ((8, 13, 20), "gbma", "rayleigh", {}, True),
    "padded-equal-reduced": ((8, 13, 20), "gbma", "equal", {}, False),
    "mixed-fdm-centralized": ((20, 20, 20), ("gbma", "fdm", "centralized"),
                              "rayleigh", {}, True),
    "mixed-momentum": ((20, 20, 20), ("gbma", "momentum", "nesterov"),
                       "rayleigh", {"momentum": 0.5}, True),
    "fdm-inverted": ((20, 20), "fdm", "rayleigh",
                     {"invert_channel": True}, True),
    "fdm": ((20, 20), "fdm", "rayleigh", {"invert_channel": False}, True),
    "power-control": ((20, 20), "power_control", "rayleigh",
                      {"h_min": 0.3}, True),
    "participation": ((20, 20, 20), "gbma", "rayleigh",
                      {"participation": [1.0, 0.7, 0.3]}, True),
    "padded-fdm-participation": ((8, 13, 20), ("gbma", "fdm", "fdm"),
                                 "rician", {"participation": [1.0, 0.7, 0.3],
                                            "invert_channel": False}, True),
}


def _sweep_rows(sweep, counts, fading):
    probs, jps, tps = sweep
    idx = [SWEEP_N.index(n) for n in counts]
    cfgs = [ChannelConfig(fading=fading, scale=1.0, noise_std=1.0,
                          energy=e, rician_k=2.0)
            for e in (1.0, 0.5, 0.25)[:len(counts)]]
    betas = [0.5 * stepsize_theorem1(probs[i].pc, c, SWEEP_N[i], safety=0.9)
             for i, c in zip(idx, cfgs)]
    pcs = [probs[i].pc for i in idx]
    return ([jps[i] for i in idx], [tps[i] for i in idx], cfgs, betas, pcs)


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_sweep_calls_match_reference(sweep, case):
    counts, algo, fading, kw, keep = SWEEP_CASES[case]
    jps, tps, cfgs, betas, pcs = _sweep_rows(sweep, counts, fading)
    with jax_original_layout():
        ref = jax_run_mc(jps, cfgs, algo, betas, STEPS, SEEDS, pc=pcs,
                         keep_seed_curves=keep, **kw)
    out = engine.run_mc(tps, [port_channel(c) for c in cfgs], algo, betas,
                        STEPS, SEEDS, pc=[port_pc(p) for p in pcs],
                        keep_seed_curves=keep, device="cpu", **kw)
    assert out.mean.shape == (len(counts), STEPS + 1)
    _assert_parity(out, ref)
    if keep:
        target = float(np.exp(np.mean(np.log(ref.risks))))
        np.testing.assert_allclose(engine.energy_to_target(out, target),
                                   jax_energy(ref, target), rtol=1e-6)


def test_padded_call_equals_per_n_calls(sweep):
    """One padded call against one call per N, at the reference's own
    1e-5 bar (its padded sweep is pinned to per-N runs the same way)."""
    _, tps, cfgs, betas, _ = _sweep_rows(sweep, SWEEP_N, "rayleigh")
    chs = [port_channel(c) for c in cfgs]
    padded = engine.run_mc(tps, chs, "gbma", betas, STEPS, SEEDS,
                           device="cpu")
    for i, (tp, ch, beta) in enumerate(zip(tps, chs, betas)):
        single = engine.run_mc(tp, [ch], "gbma", [beta], STEPS, SEEDS,
                               device="cpu")
        np.testing.assert_allclose(padded.risks[i], single.risks[0],
                                   rtol=1e-5, atol=0)
        np.testing.assert_allclose(padded.cum_energy[i],
                                   single.cum_energy[0], rtol=1e-5, atol=0)


def test_mixed_rows_keep_the_callers_row_order(sweep):
    """Rows are run in slot-group order and handed back in the caller's:
    a mixed call's rows equal the same rows run alone, bit for bit."""
    _, tps, cfgs, betas, _ = _sweep_rows(sweep, (20, 20, 20), "rayleigh")
    chs = [port_channel(c) for c in cfgs]
    algos = ("centralized", "gbma", "fdm")
    mixed = engine.run_mc(tps, chs, algos, betas, 12, SEEDS, device="cpu")
    for i, algo in enumerate(algos):
        alone = engine.run_mc(tps[i], [chs[i]], algo, [betas[i]], 12, SEEDS,
                              device="cpu")
        np.testing.assert_array_equal(mixed.risks[i], alone.risks[0])


# ---------------------------------------------- antennas, blind, blind_ec
ANTENNA_N = (8, 13)


@pytest.fixture(scope="module")
def antenna_problems():
    jps = [MSDProblem.make(n, dim=D).to_mc() for n in ANTENNA_N]
    return jps, [port_problem(jp) for jp in jps]


# (row node counts, algos, keyword arguments)
ANTENNA_CASES = {
    "gbma-static-m1": ((13, 13), "gbma", {"n_antennas": 1}),
    "gbma-static-m3": ((13, 13), "gbma", {"n_antennas": 3}),
    "gbma-per-row-m": ((13, 13), "gbma", {"n_antennas": (1, 4)}),
    "gbma-per-row-m-padded": ((8, 13), ("gbma", "momentum"),
                              {"n_antennas": (2, 5), "momentum": 0.5}),
    "blind-static": ((13, 13), "blind", {"n_antennas": 3}),
    "blind-per-row-padded": ((8, 13), "blind", {"n_antennas": (4, 2)}),
    "blind-ec-binding-and-unbounded": (
        (13, 13, 13), ("blind_ec", "blind_ec", "blind"),
        {"n_antennas": 4, "power_budget": [0.5, float("inf"), 0.5]}),
    "blind-ec-scalar-budget-participation": (
        (13, 13), ("blind_ec", "blind"),
        {"n_antennas": (3, 5), "power_budget": 0.2,
         "participation": [0.7, 0.5]}),
    "fig7-shape": ((8, 8, 13, 13), ("gbma", "blind", "blind_ec",
                                    "centralized"),
                   {"n_antennas": (1, 3, 3, 1),
                    "power_budget": [float("inf"), float("inf"), 0.3,
                                     float("inf")]}),
}


@pytest.mark.parametrize("case", sorted(ANTENNA_CASES))
def test_antenna_calls_match_reference(antenna_problems, case):
    counts, algo, kw = ANTENNA_CASES[case]
    jps, tps = antenna_problems
    idx = [ANTENNA_N.index(n) for n in counts]
    cfgs = [ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                          energy=e) for e in (1.0, 0.5, 0.25, 0.125)
            [:len(counts)]]
    betas = [0.01, 0.008, 0.006, 0.004][:len(counts)]
    with jax_original_layout():
        ref = jax_run_mc([jps[i] for i in idx], cfgs, algo, betas, STEPS,
                         SEEDS, **kw)
    out = engine.run_mc([tps[i] for i in idx],
                        [port_channel(c) for c in cfgs], algo, betas, STEPS,
                        SEEDS, device="cpu", **kw)
    assert out.mean.shape == (len(counts), STEPS + 1)
    assert np.all(np.isfinite(out.risks))
    _assert_parity(out, ref)


def test_antenna_settings_drop_the_theorem1_bound(antenna_problems):
    """Theorem 1 covers the single-antenna edge: with any antenna
    setting `bounds` is None, as in the reference."""
    _, tps = antenna_problems
    prob = MSDProblem.make(13, dim=D)
    cfg = ChannelConfig(fading="rayleigh")
    beta = stepsize_theorem1(prob.pc, cfg, 13, safety=0.9)
    kw = dict(pc=port_pc(prob.pc), device="cpu")
    ch = port_channel(cfg)
    plain = engine.run_mc(tps[1], [ch], "gbma", [beta], 4, 2, **kw)
    assert plain.bounds is not None
    for m in (1, (2,)):
        assert engine.run_mc(tps[1], [ch], "gbma", [beta], 4, 2,
                             n_antennas=m, **kw).bounds is None


def test_static_m1_is_not_the_single_antenna_stream(antenna_problems):
    """`n_antennas=1` takes the MRC path (an extra key split): another
    stream than `n_antennas=None`, as in the reference."""
    _, tps = antenna_problems
    ch = port_channel(ChannelConfig(fading="rayleigh"))
    single = engine.run_mc(tps[1], [ch], "gbma", [0.01], 6, 2, device="cpu")
    m1 = engine.run_mc(tps[1], [ch], "gbma", [0.01], 6, 2, n_antennas=1,
                       device="cpu")
    per_row = engine.run_mc(tps[1], [ch], "gbma", [0.01], 6, 2,
                            n_antennas=(1,), device="cpu")
    assert not np.array_equal(single.risks, m1.risks)
    np.testing.assert_allclose(per_row.risks, m1.risks, rtol=1e-6, atol=0)


# --------------------------------------------- localization and logistic
def _localization_problems():
    out = []
    for n, seed in ((16, 0), (9, 1)):
        r, x, src, _ = localization_field(n, signal_a=100.0, snr_db=-10.0,
                                          seed=seed)
        out.append(localization_mc_problem(r, x, src, 100.0))
    return out


def _logistic_problems():
    out = []
    for n in (8, 13):
        X, y, _ = logistic_classification(n * 6, dim=16, seed=0)
        out.append(logistic_mc_problem(X, y, n, lam=0.1))
    return out


@pytest.fixture(scope="module")
def kinds():
    loc, logi = _localization_problems(), _logistic_problems()
    return {"localization": (loc, [port_problem(p) for p in loc]),
            "logistic": (logi, [port_problem(p) for p in logi])}


# (kind, problem indices, algos, channel (noise_std, energy), betas,
#  keyword arguments)
KIND_CASES = {
    "localization-fig5-shape": (
        "localization", (0,) * 3, ("gbma", "fdm", "centralized"),
        (0.3, 16 ** -1.5), (0.8, 0.8, 1.0),
        {"theta0": np.array([45.0, 45.0])}),
    "localization-padded": (
        "localization", (0, 1), "gbma", (0.3, 0.1), (0.8, 0.8),
        {"theta0": np.array([45.0, 45.0])}),
    "logistic-full-batch": (
        "logistic", (0, 0), ("gbma", "centralized"), (0.5, 1 / 8),
        (0.4, 0.5), {}),
    "logistic-per-row-batch-frac": (
        "logistic", (0,) * 3, "gbma", (0.5, 1 / 8), (0.4,) * 3,
        {"batch_frac": (1.0, 0.5, 0.25)}),
    "logistic-fig8-shape": (
        "logistic", (0, 0, 1, 1), ("gbma", "blind", "gbma", "centralized"),
        (0.5, 1 / 8), (0.4, 0.5, 0.4, 0.5),
        {"batch_frac": 0.5, "n_antennas": (1, 3, 1, 1)}),
    "logistic-blind-ec-minibatch": (
        "logistic", (1, 1), ("blind_ec", "gbma"), (0.5, 1 / 13),
        (0.5, 0.4), {"batch_frac": [0.5, 1.0], "n_antennas": 2,
                     "power_budget": 0.05}),
}


@pytest.mark.parametrize("case", sorted(KIND_CASES))
def test_problem_kinds_match_reference(kinds, case):
    kind, idx, algo, (noise, energy), betas, kw = KIND_CASES[case]
    jps, tps = kinds[kind]
    cfgs = [ChannelConfig(fading="rayleigh", scale=1.0, noise_std=noise,
                          energy=energy) for _ in idx]
    with jax_original_layout():
        ref = jax_run_mc([jps[i] for i in idx], cfgs, algo, list(betas),
                         STEPS, SEEDS, **kw)
    out = engine.run_mc([tps[i] for i in idx],
                        [port_channel(c) for c in cfgs], algo, list(betas),
                        STEPS, SEEDS, device="cpu", **kw)
    assert np.all(np.isfinite(out.risks))
    atol = 0.0
    if kind == "logistic":  # 4 ulps of the f32 objective (F8)
        atol = 4 * float(np.spacing(np.float32(max(
            float(np.asarray(p.data["f_star"])) for p in jps))))
    _assert_parity(out, ref, risk_atol=atol)


def test_minibatch_lanes_follow_round_of_the_fraction(kinds):
    """b = max(1, round(f·k)): with k = 6 local samples, fractions 0.5
    and 0.55 both take 3 lanes (the same run), 0.01 takes 1."""
    _, tps = kinds["logistic"]
    ch = port_channel(ChannelConfig(fading="rayleigh", noise_std=0.5))
    runs = {f: engine.run_mc(tps[0], [ch], "gbma", [0.4], 5, 2,
                             batch_frac=f, device="cpu").risks
            for f in (0.5, 0.55, 0.01)}
    np.testing.assert_array_equal(runs[0.5], runs[0.55])
    assert not np.array_equal(runs[0.5], runs[0.01])
