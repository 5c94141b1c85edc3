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

Bars: risks, mean and cum_energy within rtol 1e-5 (the engine-parity bar
the repo uses; normals differ by an ulp and the iteration is contractive).
ci95 is a spread across seeds — a difference of nearly equal risks — so
its error is bounded by the risks' error, not by its own size: it is held
to rtol 1e-5 plus atol 1e-5·|mean|. Theorem-1 bounds and energy_to_target
within 1e-6. The figure twins (`repro_torch.figures`) emit the same
rows as `benchmarks.fig2_equal_gains`, `fig3_rayleigh`,
`fig4_fdm_comparison`, `fig6_energy_scaling` and parts (a), (b), (c),
(e) and (g) of `ablations` at the smoke test's tiny constants.
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
import benchmarks.fig6_energy_scaling as fig6_ref  # noqa: E402
from benchmarks.common import MSDProblem  # noqa: E402
from repro.core.channel import ChannelConfig  # noqa: E402
from repro.core.mc.engine import energy_to_target as jax_energy  # noqa: E402
from repro.core.mc.engine import run_mc as jax_run_mc  # noqa: E402
from repro.core.theory import stepsize_theorem1  # noqa: E402
from repro_torch.core.mc import engine  # noqa: E402
from repro_torch.kernels.ota import ops  # noqa: E402
from repro_torch.figures import (run_ablations, run_fig2,  # noqa: E402
                                 run_fig3, run_fig4, run_fig6)

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


def _assert_parity(out, ref):
    np.testing.assert_allclose(out.mean, ref.mean, rtol=1e-5, atol=0)
    assert np.all(np.abs(out.ci95 - ref.ci95)
                  <= 1e-5 * np.abs(ref.ci95) + 1e-5 * np.abs(ref.mean))
    if ref.risks is None:
        assert out.risks is None and out.cum_energy is None
    else:
        np.testing.assert_allclose(out.risks, ref.risks, rtol=1e-5, atol=0)
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
        "EPS_GRID": (1.0, 1.5)}
FIGS = {"fig2": (fig2_ref, run_fig2), "fig3": (fig3_ref, run_fig3),
        "fig4": (fig4_ref, run_fig4), "fig6": (fig6_ref, run_fig6)}
# the row prefix of each ported ablation part
ABLATION_ROWS = {"a": "ablation_phase", "b": "ablation_fading",
                 "c": "ablation_powerctl", "e": "ablation_accel",
                 "g": "ablation_participation"}


def _twin_kwargs(mod) -> dict:
    names = {"STEPS": "steps", "SEEDS": "seeds", "N": "n",
             "N_GRID": "n_grid", "EPS_GRID": "eps_grid"}
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
