"""The port's hoisted RNG plan, on the CPU.

* Draw twins: each algorithm's `hoist_draws` twin, over the `(T, B, 2)`
  step keys of all steps, equals the per-step draw of every step bit for
  bit — gbma (momentum and nesterov share it) single-antenna, at a
  static M and at per-row M; blind at a static and per-row M; fdm with
  and without inversion; power_control — across the fading families,
  with and without the phase stream, at one N and padded (the dynamic-N
  and antenna counter layouts). So are the hoisted participation and
  minibatch index streams.
* `run_mc`: 'hoisted' against 'inscan' bit for bit per family (the
  reference's cases in `tests/test_exec.py`: phase error, padded N,
  participation, minibatches), mixed calls keeping the per-step path,
  and the port's hoisted `run_mc` against the reference's at the engine
  bar (rtol 1e-5; ci95 at F3's bar; the logistic risks with F8's 4-ulp
  floor, ROADMAP §3).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from test_torch_helpers import (jax_original_layout, port_channel,  # noqa: E402
                                port_problem)

from benchmarks.common import MSDProblem  # noqa: E402
from repro.core.channel import ChannelConfig  # noqa: E402
from repro.core.mc.engine import run_mc as jax_run_mc  # noqa: E402
from repro.core.montecarlo import logistic_mc_problem  # noqa: E402
from repro.data.synthetic import logistic_classification  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core.mc import exec as exec_mod  # noqa: E402
from repro_torch.core.mc import slots  # noqa: E402
from repro_torch.core.mc.engine import run_mc  # noqa: E402
from repro_torch.core.mc.problems import MCProblemBatch  # noqa: E402
from repro_torch.core.mc.slots import (ALGO_REGISTRY, SlotCtx,  # noqa: E402
                                       with_antennas)

N, D, T = 13, 10, 5
COUNTS = (13, 7, 13, 9)  # one trajectory per entry; padded draws use them


def _ctx(fading, phase, *, padded=False, n_antennas=None, m_sizes=(),
         invert=False):
    """A 4-trajectory slot context at N = 13 (or counts (13, 7, 13, 9)
    padded to 13), with per-row antenna counts (2, 4, 4, 2) under
    `m_sizes`."""
    b = len(COUNTS)
    counts = torch.tensor(COUNTS if padded else (N,) * b)
    full = lambda v: torch.full((b,), v, dtype=torch.float32)
    p = {"scale": full(0.9), "rician_k": full(3.0),
         "phase_error_max": torch.tensor([phase, 0.0, phase, 0.2]),
         "noise_std": full(0.5), "energy": full(0.7),
         "n_nodes": counts.to(torch.float32)}
    if m_sizes:
        p["n_antennas"] = torch.tensor([2.0, 4.0, 4.0, 2.0])
    mask = (torch.arange(N) < counts[:, None]).to(torch.float32)
    ctx = SlotCtx(fading=fading, p=p, mask=mask, counts=counts,
                  n_sizes=tuple(sorted(set(COUNTS))) if padded else (N,),
                  invert_channel=invert, phase_zero=phase == 0.0)
    return with_antennas(ctx, n_antennas, m_sizes)


def _step_keys(seed: int) -> torch.Tensor:
    return rng.split(rng.key(torch.arange(len(COUNTS)) + seed), T)


def _assert_twin(name: str, draw, ctx, seed: int) -> dict:
    """The registered twin of `name` against `draw` at every step: the
    same keys, each tensor equal bit for bit."""
    keys = _step_keys(seed)
    hoisted = ALGO_REGISTRY[name].hoist_draws(keys.transpose(0, 1), ctx, N,
                                              D)
    for t in range(T):
        step = draw(keys[:, t], ctx, N, D)
        assert set(step) == set(hoisted)
        for k, v in step.items():
            assert hoisted[k].shape == (T,) + v.shape, k
            assert torch.equal(hoisted[k][t], v), (name, k, t)
    return hoisted


FADINGS = ("equal", "rayleigh", "rician", "lognormal")


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("mode", ["single", "static_m", "per_row_m"])
@pytest.mark.parametrize("phase", [0.0, 0.4])
@pytest.mark.parametrize("fading", FADINGS)
def test_gbma_twin_equals_the_per_step_draws(fading, phase, mode, padded):
    kw = {"single": {}, "static_m": {"n_antennas": 3},
          "per_row_m": {"m_sizes": (2, 4)}}[mode]
    ctx = _ctx(fading, phase, padded=padded, **kw)
    hoisted = _assert_twin("gbma", slots._gbma_draw, ctx, seed=11)
    # deterministic gains are not drawn, as in the reference
    assert ("h" in hoisted) != (fading == "equal" and phase == 0.0)
    for name in ("momentum", "nesterov"):
        assert ALGO_REGISTRY[name].hoist_draws is slots._gbma_hoist_draws


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("fading", FADINGS)
def test_blind_twin_equals_the_per_step_draws(fading, per_row, padded):
    ctx = _ctx(fading, 0.0, padded=padded,
               **({"m_sizes": (2, 4)} if per_row else {"n_antennas": 3}))
    _assert_twin("blind", slots._blind_draw, ctx, seed=5)
    assert ALGO_REGISTRY["blind_ec"].hoist_draws \
        is slots._blind_hoist_draws


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("fading", ["equal", "rayleigh", "lognormal"])
def test_fdm_and_power_control_twins_equal_the_per_step_draws(
        fading, invert, padded):
    ctx = _ctx(fading, 0.0, padded=padded, invert=invert)
    _assert_twin("fdm", slots._fdm_draw, ctx, seed=3)
    _assert_twin("power_control", slots._ota_draw, ctx, seed=3)


def test_centralized_hoists_nothing():
    assert ALGO_REGISTRY["centralized"].hoist_draws is None
    assert slots.hoist_draw_elems("centralized", steps=4, n_max=8, dim=2,
                                  m_live=1, invert_channel=False) == 0


def test_hoisted_participation_and_index_streams_equal_per_step_draws():
    keys = rng.key(torch.tensor([0, 7, 9]))
    part_keys = rng.split(rng.fold_in(keys, exec_mod._PART_STREAM), T)
    hoisted = rng.uniform(part_keys.transpose(0, 1), (N,))
    X, y, _ = logistic_classification(48, dim=6, seed=1)
    tp = port_problem(logistic_mc_problem(X, y, 8, lam=0.1))
    batch = MCProblemBatch.stack([tp])
    sample_idx = batch.spec.sample_indices_row
    data_keys = rng.split(rng.fold_in(keys, exec_mod._DATA_STREAM), T)
    idx = sample_idx(batch.data, data_keys.transpose(0, 1).reshape(-1, 2),
                     3).unflatten(0, (T, 3))
    for t in range(T):
        assert torch.equal(hoisted[t], rng.uniform(part_keys[:, t], (N,)))
        assert torch.equal(idx[t], sample_idx(batch.data, data_keys[:, t],
                                              3))


# --------------------------------------------------------------------------
# run_mc: hoisted against inscan, mixed calls, against the reference
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def problems():
    jps = [MSDProblem.make(n, dim=D).to_mc() for n in (8, 13)]
    X, y, _ = logistic_classification(48, dim=6, seed=1)
    jl = logistic_mc_problem(X, y, 8, lam=0.1)
    return {"msd": (jps[1], port_problem(jps[1])),
            "padded": (jps, [port_problem(j) for j in jps]),
            "logistic": (jl, port_problem(jl))}


def _chs(n, fading="rayleigh", phase=0.0):
    return [ChannelConfig(fading=fading, noise_std=0.5, energy=e,
                          phase_error_max=phase, rician_k=2.0)
            for e in (1.0, 0.5)[:n]]


# (problem, algo, fading, phase, keyword arguments)
PLAN_CASES = {
    "gbma": ("msd", "gbma", "rayleigh", 0.0, {}),
    "gbma-rician-phase": ("msd", "gbma", "rician", 0.3, {}),
    "gbma-equal": ("msd", "gbma", "equal", 0.0, {}),
    "gbma-padded": ("padded", "gbma", "lognormal", 0.0, {}),
    "gbma-static-m": ("msd", "gbma", "rayleigh", 0.0, {"n_antennas": 3}),
    "momentum-per-row-m-padded": ("padded", "momentum", "rayleigh", 0.0,
                                  {"n_antennas": (2, 5),
                                   "momentum": 0.5}),
    "nesterov-participation": ("msd", "nesterov", "rayleigh", 0.0,
                               {"participation": [0.7, 1.0]}),
    "blind-static-m": ("msd", "blind", "rician", 0.0, {"n_antennas": 3}),
    "blind-ec-per-row-m-padded": ("padded", "blind_ec", "rayleigh", 0.0,
                                  {"n_antennas": (4, 2),
                                   "power_budget": 0.05}),
    "fdm": ("padded", "fdm", "rayleigh", 0.0, {"invert_channel": False}),
    "fdm-inverted": ("msd", "fdm", "rician", 0.2, {"invert_channel": True}),
    "power-control": ("padded", "power_control", "rayleigh", 0.0,
                      {"participation": [0.5, 0.9]}),
    "logistic-minibatch": ("logistic", "gbma", "rayleigh", 0.0,
                           {"batch_frac": 0.5}),
}


def _port_args(problems, case):
    kind, algo, fading, phase, kw = PLAN_CASES[case]
    jp, tp = problems[kind]
    betas = [0.3, 0.2] if kind == "logistic" else [0.01, 0.008]
    chs = _chs(2, fading, phase)
    return jp, tp, chs, algo, betas, kw


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_hoisted_run_mc_equals_inscan_bit_for_bit(problems, case):
    _, tp, chs, algo, betas, kw = _port_args(problems, case)
    out = {plan: run_mc(tp, [port_channel(c) for c in chs], algo, betas, 12,
                        3, rng_plan=plan, device="cpu", **kw)
           for plan in ("hoisted", "inscan")}
    assert out["hoisted"].plan.rng_plan == "hoisted"
    for f in ("risks", "cum_energy", "mean", "ci95"):
        np.testing.assert_array_equal(getattr(out["hoisted"], f),
                                      getattr(out["inscan"], f))


def test_hoisting_draws_through_the_twin_and_mixed_calls_do_not(
        problems, monkeypatch):
    """A single-algorithm call draws through its twin under 'hoisted' and
    not under 'inscan'; a mixed call never does (the reference's rule) and
    is the per-step call bit for bit."""
    _, tp = problems["msd"]
    chs = [port_channel(c) for c in _chs(2)]
    calls = []
    for name in ("gbma", "fdm"):
        spec = ALGO_REGISTRY[name]

        def twin(*a, real=spec.hoist_draws, name=name):
            calls.append(name)
            return real(*a)

        monkeypatch.setitem(ALGO_REGISTRY, name,
                            dataclasses.replace(spec, hoist_draws=twin))
    run_mc(tp, chs, "gbma", [0.01] * 2, 6, 2, device="cpu")
    assert calls == ["gbma"]
    run_mc(tp, chs, "gbma", [0.01] * 2, 6, 2, rng_plan="inscan",
           device="cpu")
    mixed = {plan: run_mc(tp, chs + chs[:1], ("gbma", "fdm", "centralized"),
                          [0.01] * 3, 6, 2, rng_plan=plan, device="cpu")
             for plan in ("hoisted", "inscan")}
    assert calls == ["gbma"]
    np.testing.assert_array_equal(mixed["hoisted"].risks,
                                  mixed["inscan"].risks)
    np.testing.assert_array_equal(mixed["hoisted"].cum_energy,
                                  mixed["inscan"].cum_energy)


REFERENCE_CASES = ("gbma-rician-phase", "gbma-padded",
                   "momentum-per-row-m-padded", "blind-ec-per-row-m-padded",
                   "fdm", "power-control", "logistic-minibatch")


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_hoisted_run_mc_matches_the_reference(problems, case):
    jp, tp, chs, algo, betas, kw = _port_args(problems, case)
    with jax_original_layout():
        ref = jax_run_mc(jp, chs, algo, betas, 12, 3, rng_plan="hoisted",
                         **kw)
    out = run_mc(tp, [port_channel(c) for c in chs], algo, betas, 12, 3,
                 device="cpu", **kw)
    atol = 0.0
    if case.startswith("logistic"):  # F8: 4 ulps of F*
        f_star = float(np.asarray(jp.data["f_star"]).reshape(-1)[0])
        atol = 4.0 * float(np.spacing(np.float32(f_star)))
    np.testing.assert_allclose(out.risks, ref.risks, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(out.cum_energy, ref.cum_energy, rtol=1e-5)
    np.testing.assert_allclose(out.mean, ref.mean, rtol=1e-5, atol=atol)
    assert np.all(np.abs(out.ci95 - ref.ci95)
                  <= 1e-5 * np.abs(ref.ci95) + 1e-5 * np.abs(ref.mean)
                  + atol)
