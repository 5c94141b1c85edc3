"""The port's Monte Carlo main path against the JAX reference, on the CPU.

`repro_torch.core.mc.engine.run_mc` vs `repro.core.mc.engine.run_mc` on
an MSD-like quadratic problem carried across with `problem_from_arrays`
(N = 48, d = 16, 40 steps, 2 seeds, 2 rows): gbma under rayleigh, equal
and rician with phase error 0.3, centralized, momentum and nesterov, with
per-seed curves kept and reduced on the device.

Bars: risks, mean and cum_energy within rtol 1e-5 (the engine-parity bar
the repo uses; normals differ by an ulp and the iteration is contractive).
ci95 is a spread across seeds — a difference of nearly equal risks — so
its error is bounded by the risks' error, not by its own size: it is held
to rtol 1e-5 plus atol 1e-5·|mean|. Theorem-1 bounds and energy_to_target
within 1e-6. The fig2/fig3 twins (`repro_torch.figures`) emit the same
rows as `benchmarks.fig2_equal_gains` / `fig3_rayleigh` at the smoke
test's tiny constants.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from test_torch_helpers import (jax_original_layout, port_channel,  # noqa: E402
                                port_pc, port_problem, rel_err)

import benchmarks.fig2_equal_gains as fig2_ref  # noqa: E402
import benchmarks.fig3_rayleigh as fig3_ref  # noqa: E402
from benchmarks.common import MSDProblem  # noqa: E402
from repro.core.channel import ChannelConfig  # noqa: E402
from repro.core.mc.engine import energy_to_target as jax_energy  # noqa: E402
from repro.core.mc.engine import run_mc as jax_run_mc  # noqa: E402
from repro.core.theory import stepsize_theorem1  # noqa: E402
from repro_torch.core.mc import engine  # noqa: E402
from repro_torch.kernels.ota import ops  # noqa: E402
from repro_torch.figures import run_fig2, run_fig3  # noqa: E402

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
    """A figure row -> (key fields, main value, ±ci95 or None)."""
    parts = row.split(",")
    if parts[-1].startswith("±"):
        return tuple(parts[:-2]), float(parts[-2]), float(parts[-1][1:])
    return tuple(parts[:-1]), float(parts[-1]), None


@pytest.mark.parametrize("name", ["fig2", "fig3"])
def test_fig_twin_matches_reference_rows(name, monkeypatch):
    ref_mod = {"fig2": fig2_ref, "fig3": fig3_ref}[name]
    run_twin = {"fig2": run_fig2, "fig3": run_fig3}[name]
    tiny = {"STEPS": 6, "SEEDS": 2, "N_GRID": (8, 13),
            "EPS_GRID": (1.0, 1.5)}
    for attr, val in tiny.items():
        monkeypatch.setattr(ref_mod, attr, val)
    with jax_original_layout():
        ref_rows = ref_mod.run(verbose=False)
    rows = run_twin(device="cpu", n_grid=tiny["N_GRID"],
                    eps_grid=tiny["EPS_GRID"], steps=tiny["STEPS"],
                    seeds=tiny["SEEDS"])
    assert len(rows) == len(ref_rows)
    for row, ref in zip(rows, ref_rows):
        key, val, ci = _parse(row)
        rkey, rval, rci = _parse(ref)
        assert key == rkey
        assert abs(val - rval) <= 1e-5 * abs(rval), (row, ref)
        if rci is not None:
            # ±ci95 prints 3 significant digits: equal up to that rounding
            assert abs(ci - rci) <= 0.01 * abs(rci) + 1e-5 * abs(rval)
