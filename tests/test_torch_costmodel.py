"""The port's cost model (`repro_torch.core.mc.costmodel`) on the CPU.

* The reference's cases (`tests/test_costmodel.py`, the same names):
  predictions monotone in N, seeds and steps; the profile factor's
  interpolation and clamp; the worst family priced; the versioned
  artifact keyed by `<platform>/<device_count>` (stale versions, foreign
  keys and peaks-only entries not loaded); cached machine peaks measured
  once per key; `auto_plan(cost_model="measured")` the analytic plan
  exactly without an entry, re-pricing the chunk with an injected model,
  and keeping the analytic chunk inside the 5 % band.
* Parity with the reference: `mc_slot_model`, the analytic model's
  `predict_step_us` / `predict_run_us` on the same `Workload` and
  `ExecPlan` (rtol 1e-12), artifacts written by either package read by
  the other, and `auto_plan(cost_model="measured")` equal to the
  reference's for the same synthetic model.
* The port's own: `platform_key` from the device (`cpu/1`), the committed
  artifact's `cuda/1` entry made on the card, a smoke calibration on the
  CPU, and the profile's departure (a point the dispatch covers entirely
  is left out).
"""
from __future__ import annotations

import itertools
import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.mc import costmodel  # noqa: E402
from repro_torch.core.mc.costmodel import (CALIBRATION_VERSION,  # noqa: E402
                                           CalibrationConfig, CostModel,
                                           Workload, analytic_cost_model,
                                           cached_machine_peaks,
                                           load_cost_model, mc_slot_model,
                                           platform_key)
from repro_torch.core.mc.plan import ExecPlan, auto_plan  # noqa: E402

CPU_KEY = "cpu/1"


# --------------------------------------------------------------------------
# fixtures: synthetic artifacts / models
# --------------------------------------------------------------------------
def _entry(**over) -> dict:
    entry = {
        "coeffs": {"gbma": {"c0_us": 10.0, "c1_us": 1e-3},
                   "blind": {"c0_us": 20.0, "c1_us": 2e-3}},
        "dispatch_us": 300.0,
        "compile_s": 1.5,
        "chunk_profile": [[1 << 20, 1.0], [64 << 20, 1.7]],
        "peaks": {"peak_gflops": 4.0, "peak_gibs": 3.0},
    }
    entry.update(over)
    return entry


def _write_artifact(path, entry=None, key=None,
                    version=CALIBRATION_VERSION) -> None:
    data = {"version": version,
            "entries": {key if key else CPU_KEY:
                        _entry() if entry is None else entry}}
    path.write_text(json.dumps(data))


def _synthetic(dispatch_us=0.0, compile_s=0.0, c0=0.0, c1=1.0,
               chunk_profile=(), cls=CostModel) -> CostModel:
    return cls(
        coeffs=(("blind", c0, c1), ("gbma", c0, c1)),
        dispatch_us=dispatch_us, compile_s=compile_s,
        chunk_profile=chunk_profile,
        peaks=(("peak_gflops", 1.0), ("peak_gibs", 1.0)),
        source="measured")


_PLAN = ExecPlan(seed_chunk=4, n_shards=0, row_shards=1,
                 keep_seed_curves=False)


def _wl(**over) -> Workload:
    base = dict(n_rows=2, seeds=8, steps=50, n_max=64, dim=8)
    base.update(over)
    return Workload(**base)


# --------------------------------------------------------------------------
# slot model + prediction properties
# --------------------------------------------------------------------------
def test_slot_model_families_and_roofline_delegate():
    """The closed-form slot model, and equal to the reference's (which
    its roofline renders) over a grid."""
    from repro.core.mc.costmodel import mc_slot_model as jslot

    g = mc_slot_model("gbma", 64, 8)
    assert g["flops"] == 8 * 64 * 8 + 2 * 8 * 8
    assert g["bytes"] == (5 * 64 * 8 + 64) * 4
    b = mc_slot_model("blind", 64, 8, m=4)
    assert b["flops"] > g["flops"]
    for algo, n, d, m in itertools.product(
            ("gbma", "blind"), (1, 17, 64, 4096), (2, 24, 90), (1, 4, 32)):
        assert mc_slot_model(algo, n, d, m) == jslot(algo, n, d, m)
    with pytest.raises(ValueError, match="no slot model"):
        mc_slot_model("warp", 8, 8)


@pytest.mark.parametrize("model", [analytic_cost_model(),
                                   _synthetic(dispatch_us=300.0, c0=5.0,
                                              c1=1e-3)])
def test_predict_run_us_monotone_in_n_seeds_steps(model):
    """Predicted wall-clock never decreases when the workload grows along
    any axis."""
    for axis, grid in (("n_max", (16, 64, 256, 1024)),
                       ("seeds", (4, 8, 16, 64)),
                       ("steps", (10, 50, 200, 1000))):
        preds = [model.predict_run_us(_PLAN, _wl(**{axis: v}),
                                      device_count=1) for v in grid]
        assert preds == sorted(preds), (axis, preds)
        assert all(p > 0 for p in preds)


def test_profile_factor_interpolates_and_clamps():
    m = _synthetic(chunk_profile=((100.0, 1.0), (200.0, 2.0)))
    assert m._profile_factor(50.0) == 1.0
    assert m._profile_factor(150.0) == pytest.approx(1.5)
    assert m._profile_factor(10_000.0) == 2.0
    assert _synthetic()._profile_factor(123.0) == 1.0


def test_predict_step_us_prices_the_worst_family():
    m = _synthetic(c0=1.0, c1=1e-3)
    wl = _wl(algo_set=("gbma", "blind"), m_sizes=(2,))
    blind_only = m.predict_step_us(_PLAN, _wl(algo_set=("blind",),
                                              m_sizes=(2,)),
                                   device_count=1)
    assert m.predict_step_us(_PLAN, wl, device_count=1) == blind_only


PREDICT_GRID = [
    (ExecPlan(seed_chunk=c, rng_plan=rp, n_shards=0, row_shards=1,
              keep_seed_curves=keep),
     dict(n_rows=r, seeds=s, steps=t, n_max=n, dim=d, algo_set=a,
          m_sizes=m, b_max=b))
    for c, rp, keep in ((None, "hoisted", True), (4, "hoisted", False),
                        (8, "inscan", True))
    for r, s, t, n, d, a, m, b in (
        (1, 8, 50, 64, 8, ("gbma",), (), 0),
        (3, 16, 300, 500, 90, ("momentum",), (), 0),
        (2, 32, 150, 4096, 24, ("blind",), (2, 16), 0),
        (4, 64, 40, 80, 16, ("gbma", "fdm"), (1, 4), 5),
        (1, 1024, 150, 4096, 24, ("power_control",), (), 0))
]


@pytest.mark.parametrize("case", range(len(PREDICT_GRID)))
def test_analytic_predictions_equal_the_reference(case):
    """The analytic fallback keeps the reference's constants, so its
    predictions are the reference's (rtol 1e-12)."""
    from repro.core.mc.costmodel import Workload as JWorkload
    from repro.core.mc.costmodel import analytic_cost_model as janalytic
    from repro.core.mc.plan import ExecPlan as JPlan

    plan, kw = PREDICT_GRID[case]
    jplan = JPlan(**{k: v for k, v in plan.asdict().items()
                     if k != "retry"})
    port, ref = analytic_cost_model(), janalytic()
    wl, jwl = Workload(**kw), JWorkload(**kw)
    assert port.predict_step_us(plan, wl, 1) == pytest.approx(
        ref.predict_step_us(jplan, jwl, 1), rel=1e-12)
    assert port.predict_run_us(plan, wl, 1) == pytest.approx(
        ref.predict_run_us(jplan, jwl, 1), rel=1e-12)
    assert port.source == ref.source == "analytic"
    assert (port.dispatch_us, port.compile_s, port.chunk_profile,
            port.peaks) == (ref.dispatch_us, ref.compile_s,
                            ref.chunk_profile, ref.peaks)


# --------------------------------------------------------------------------
# the calibration artifact
# --------------------------------------------------------------------------
def test_load_cost_model_roundtrip(tmp_path):
    p = tmp_path / "cal.json"
    _write_artifact(p)
    m = load_cost_model(str(p), device="cpu")
    assert m is not None and m.source == "measured"
    assert dict((f, (a, b)) for f, a, b in m.coeffs) == \
        {"gbma": (10.0, 1e-3), "blind": (20.0, 2e-3)}
    assert m.dispatch_us == 300.0 and m.compile_s == 1.5
    assert m.chunk_profile == ((float(1 << 20), 1.0),
                               (float(64 << 20), 1.7))


def test_stale_artifacts_are_not_loaded(tmp_path):
    missing = tmp_path / "nope.json"
    assert load_cost_model(str(missing), device="cpu") is None

    garbage = tmp_path / "garbage.json"
    garbage.write_text("{not json")
    assert load_cost_model(str(garbage), device="cpu") is None

    stale = tmp_path / "stale.json"
    _write_artifact(stale, version=CALIBRATION_VERSION + 1)
    assert load_cost_model(str(stale), device="cpu") is None

    foreign = tmp_path / "foreign.json"
    _write_artifact(foreign, key="cuda/1")
    assert load_cost_model(str(foreign), device="cpu") is None
    assert load_cost_model(str(foreign), platform="cuda",
                           device_count=1) is not None

    peaks_only = tmp_path / "peaks.json"
    _write_artifact(peaks_only,
                    entry={"peaks": {"peak_gflops": 1.0,
                                     "peak_gibs": 1.0}})
    assert load_cost_model(str(peaks_only), device="cpu") is None


def test_cached_machine_peaks_measures_once(tmp_path):
    p = tmp_path / "cal.json"
    calls = []

    def fake(dim=1536, reps=3):
        calls.append(dim)
        return {"peak_gflops": 1.0, "peak_gibs": 2.0}

    first = cached_machine_peaks(dim=64, reps=1, path=str(p), measure=fake,
                                 device="cpu")
    assert first == {"peak_gflops": 1.0, "peak_gibs": 2.0}
    assert calls == [64]
    second = cached_machine_peaks(dim=64, reps=1, path=str(p),
                                  measure=fake, device="cpu")
    assert second == first and calls == [64]
    cached_machine_peaks(dim=64, reps=1, path=str(p), device_count=7,
                         measure=fake, device="cpu")
    assert calls == [64, 64]
    data = json.loads(p.read_text())
    assert data["version"] == CALIBRATION_VERSION
    assert set(data["entries"]) == {CPU_KEY, "cpu/7"}


def test_smoke_calibration_config_is_strictly_smaller():
    full, smoke = CalibrationConfig(), CalibrationConfig.smoke()
    assert max(smoke.n_grid) < max(full.n_grid)
    assert smoke.probe_seeds < full.probe_seeds
    assert smoke.peaks_dim < full.peaks_dim
    from repro.core.mc.costmodel import CalibrationConfig as JConfig

    assert full == CalibrationConfig(**vars(JConfig()))
    assert smoke == CalibrationConfig(**vars(JConfig.smoke()))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_artifacts_read_across_the_packages(tmp_path, writer):
    """An entry written by either package's `_write_entry` loads in the
    other as the same model (both at the CPU's `cpu/1` key)."""
    from repro.core.mc import costmodel as jcost

    p = str(tmp_path / "cal.json")
    (jcost if writer == "reference" else costmodel)._write_entry(
        p, CPU_KEY, _entry())
    jm = jcost.load_cost_model(p, platform="cpu", device_count=1)
    pm = load_cost_model(p, device="cpu")
    assert jm is not None and pm is not None
    assert (pm.coeffs, pm.dispatch_us, pm.compile_s, pm.chunk_profile,
            pm.peaks, pm.source) == (jm.coeffs, jm.dispatch_us,
                                     jm.compile_s, jm.chunk_profile,
                                     jm.peaks, jm.source)


# --------------------------------------------------------------------------
# auto_plan routing
# --------------------------------------------------------------------------
_AUTO_KW = dict(n_rows=4, seeds=64, steps=400, n_max=512, dim=16,
                memory_budget_bytes=1 << 30, device_count=1)


def test_auto_plan_measured_without_calibration_is_analytic(tmp_path):
    analytic = auto_plan(**_AUTO_KW)
    measured = auto_plan(**_AUTO_KW, cost_model="measured",
                         calibration_path=str(tmp_path / "absent.json"),
                         device="cpu")
    assert measured == analytic
    # the committed artifact has no cpu/1 entry: analytic there too
    assert auto_plan(**_AUTO_KW, cost_model="measured",
                     device="cpu") == analytic


def test_auto_plan_rejects_unknown_cost_model():
    with pytest.raises(ValueError, match="cost_model"):
        auto_plan(**_AUTO_KW, cost_model="vibes")


def test_auto_plan_injected_model_reprices_the_chunk():
    """A dispatch-dominated model makes every extra engine call a loss:
    the measured branch picks the all-live call where the analytic
    cache-target heuristic chunks."""
    analytic = auto_plan(**_AUTO_KW, target_chunk_bytes=1 << 24)
    assert analytic.seed_chunk is not None
    plan = auto_plan(**_AUTO_KW, target_chunk_bytes=1 << 24,
                     cost_model="measured",
                     _model=_synthetic(dispatch_us=1e9, c0=0.0, c1=0.0))
    assert plan.seed_chunk is None
    assert (plan.n_shards, plan.row_shards) == \
        (analytic.n_shards, analytic.row_shards)


def test_auto_plan_keeps_analytic_chunk_inside_the_tie_band():
    analytic = auto_plan(**_AUTO_KW, target_chunk_bytes=1 << 24)
    plan = auto_plan(**_AUTO_KW, target_chunk_bytes=1 << 24,
                     cost_model="measured",
                     _model=_synthetic(dispatch_us=0.0, c0=1.0, c1=0.0))
    assert plan == analytic


AUTO_CASES = [
    dict(target_chunk_bytes=1 << 24),
    dict(target_chunk_bytes=1 << 22, seeds=96),
    dict(n_rows=1, seeds=1024, steps=150, n_max=4096, dim=24,
         memory_budget_bytes=2 << 30),
    dict(algo_set=("blind",), m_sizes=(2, 8), target_chunk_bytes=1 << 23),
]
AUTO_MODELS = [dict(dispatch_us=1e9, c0=0.0, c1=0.0),
               dict(dispatch_us=0.0, c0=1.0, c1=0.0),
               dict(dispatch_us=300.0, c0=5.0, c1=1e-3,
                    chunk_profile=((1 << 20, 1.0), (1 << 26, 3.0)))]


@pytest.mark.parametrize("model", range(len(AUTO_MODELS)))
@pytest.mark.parametrize("case", range(len(AUTO_CASES)))
def test_auto_plan_measured_equals_the_reference(case, model):
    """The same synthetic model injected into both packages' `auto_plan`
    gives the same plan, field for field."""
    from repro.core.mc.costmodel import CostModel as JCostModel
    from repro.core.mc.plan import auto_plan as jauto

    kw = {**_AUTO_KW, **AUTO_CASES[case]}
    port = auto_plan(**kw, cost_model="measured",
                     _model=_synthetic(**AUTO_MODELS[model]))
    ref = jauto(**kw, cost_model="measured",
                _model=_synthetic(**AUTO_MODELS[model], cls=JCostModel))
    assert port.asdict() == ref.asdict()


# --------------------------------------------------------------------------
# the port's own
# --------------------------------------------------------------------------
def test_platform_key_comes_from_the_device():
    assert platform_key(device="cpu") == CPU_KEY
    assert platform_key(4, platform="cuda") == "cuda/4"
    assert costmodel.default_calibration_path().endswith(
        "src/repro_torch/core/mc/CALIBRATION_mc.json")


def test_the_committed_artifact_holds_a_measured_cuda_entry():
    """`CALIBRATION_mc.json` beside the module holds the `cuda/1` entry a
    full calibration made on the card (its name and power limit from
    `nvidia-smi` recorded), in the reference's versioned format."""
    path = costmodel.default_calibration_path()
    data = costmodel._read_artifact(path)
    assert data is not None and data["version"] == CALIBRATION_VERSION
    entry = data["entries"]["cuda/1"]
    assert entry["config"] == json.loads(json.dumps(
        vars(CalibrationConfig())), parse_int=int)
    assert "H100" in entry["nvidia_smi"] and " W" in entry["nvidia_smi"]
    assert entry["cuda_version"] and entry["torch_version"]
    model = load_cost_model(path, platform="cuda", device_count=1)
    assert model is not None and model.source == "measured"
    assert all(math.isfinite(v) and v >= 0 for _, c0, c1 in model.coeffs
               for v in (c0, c1))


def test_smoke_calibration_on_the_cpu(tmp_path):
    """`python -m repro_torch.core.mc.costmodel --smoke --device cpu`
    writes a `cpu/1` entry with finite, non-negative coefficients that
    loads as 'measured'; the tracked artifact is untouched."""
    before = open(costmodel.default_calibration_path()).read()
    out = tmp_path / "cal.json"
    costmodel.main(["--smoke", "--out", str(out), "--device", "cpu",
                    "--quiet"])
    entry = json.loads(out.read_text())["entries"][CPU_KEY]
    values = [c[k] for c in entry["coeffs"].values()
              for k in ("c0_us", "c1_us")]
    assert all(math.isfinite(v) and v >= 0 for v in values)
    assert entry["dispatch_us"] >= 50.0 and entry["compile_s"] >= 0.05
    assert entry["device_name"] == "cpu" and entry["nvidia_smi"] is None
    assert load_cost_model(str(out), device="cpu").source == "measured"
    assert open(costmodel.default_calibration_path()).read() == before


def test_profile_leaves_out_points_the_dispatch_covers(tmp_path,
                                                       monkeypatch):
    """Scripted timings where a call's cost is its step loop, whatever
    its seeds: 20 ms at the dispatch probe's shape, 10 ms at the
    profile's. The many-call profile points subtract to nothing and are
    left out, so no factor blows up (the reference's clamp would give
    ~1e10)."""
    def fake_run(prob, algo, steps, seeds, *, device, seed_chunk=None,
                 warm_reps=3):
        per_call = 0.02 if prob.n_nodes == 16 else 0.01
        return per_call * (seeds // seed_chunk if seed_chunk else 1)

    monkeypatch.setattr(costmodel, "_timed_run", fake_run)
    monkeypatch.setattr(costmodel, "measure_machine_peaks",
                        lambda dim, reps=3, device=None: {
                            "peak_gflops": 1.0, "peak_gibs": 1.0})
    entry = costmodel.calibrate(CalibrationConfig.smoke(),
                                path=str(tmp_path / "cal.json"),
                                device="cpu")
    assert entry["dispatch_us"] == pytest.approx(2e4)
    assert [f for _, f in entry["chunk_profile"]] == [1.0]
    assert len(entry["chunk_profile"]) == 1  # the all-live point only
