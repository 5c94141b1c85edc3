"""The port's execution plans against the JAX reference, on the CPU.

* Checkpoints (`repro_torch.checkpoint.ckpt`): round trips of nested
  tensors and arrays, the typed `CheckpointCorrupt` on zero-length,
  torn, bit-flipped, tampered and missing files, the `.prev` rotation, a
  legacy file without its sha, and files read across the packages both
  ways (`repro.checkpoint.ckpt` writes what the port reads and reads
  what the port writes).
* Plans (`repro_torch.core.mc.plan`): `RetryPolicy` delays, its injected
  sleep and its validation, `ExecPlan.asdict`; `auto_plan` and
  `exec.estimate_peak_bytes` equal to the reference's field for field at
  one device (the reference's own cases, LARGE -> chunks of 32 among
  them, and a grid over algorithms, chunks, antennas, `b_max`,
  participation and `invert_channel`); `chan_merge` and
  `finalize_merged_stats` against numpy and the reference; `run_mc`'s
  plan errors and `NotImplementedError` for placement over several
  devices and the measured cost model (ROADMAP M8); `MCResult.plan`.
* Chunks (`exec.run_chunked`): chunked curves and moments against the
  reference's chunked `run_mc` per family at the engine bar (rtol 1e-5;
  ci95 at F3's bar, ROADMAP §3; the logistic risks with F8's 4-ulp
  floor), chunked against unchunked port curves within rtol 1e-6 (the
  reference's own criterion); resume bit-identical after an interrupt,
  starting at the first unfinished chunk, a finished sweep
  short-circuiting and a foreign checkpoint rejected; a corrupt main
  checkpoint falling back to `.prev` and two corrupt ones restarting
  with a warning; retry bit-identical after k faults, an exhausted
  budget re-raising, no policy failing fast, the save outside the retry;
  and `_workload_fingerprint` equal in two fresh interpreters.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from test_torch_helpers import (jax_original_layout, port_channel,  # noqa: E402
                                port_problem)

from _fault_harness import bit_flip, torn_write  # noqa: E402
from benchmarks.common import MSDProblem  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core.channel import ChannelConfig  # noqa: E402
from repro.core.mc import exec as jexec  # noqa: E402
from repro.core.mc import plan as jplan  # noqa: E402
from repro.core.mc.engine import run_mc as jax_run_mc  # noqa: E402
from repro.core.montecarlo import logistic_mc_problem  # noqa: E402
from repro.data.synthetic import logistic_classification  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointCorrupt  # noqa: E402
from repro_torch.core.mc import exec as exec_mod  # noqa: E402
from repro_torch.core.mc import plan as plan_mod  # noqa: E402
from repro_torch.core.mc.engine import run_mc, slice_result  # noqa: E402
from repro_torch.core.mc.plan import (ExecPlan, RetryPolicy,  # noqa: E402
                                      auto_plan, validate_plan)

N, D, STEPS, SEEDS = 12, 8, 10, 8
SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(scope="module")
def mc():
    jp = MSDProblem.make(N, dim=D).to_mc()
    return jp, port_problem(jp)


@pytest.fixture(scope="module")
def logistic():
    X, y, _ = logistic_classification(40, dim=6, seed=3)
    jp = logistic_mc_problem(X, y, 8, lam=0.1)
    return jp, port_problem(jp)


def _ch(**kw):
    kw.setdefault("fading", "rayleigh")
    kw.setdefault("noise_std", 0.5)
    return ChannelConfig(**kw)


def _pch(**kw):
    return port_channel(_ch(**kw))


def _retry(**kw):
    kw.setdefault("max_attempts", 3)
    kw.setdefault("sleep", lambda dt: None)
    return RetryPolicy(**kw)


class _Faults:
    """`{seed offset: n}`: the chunk at that offset fails its first n
    attempts (the port's chunk fault hook); `fired` records them."""

    def __init__(self, schedule: dict):
        self.schedule, self.fired = dict(schedule), []

    def __call__(self, info: dict) -> None:
        if self.schedule.get(info["off"], 0) >= info["attempt"]:
            self.fired.append(dict(info))
            raise RuntimeError(f"injected chunk fault at off={info['off']}")

    def __enter__(self):
        self._remove = exec_mod.install_chunk_fault_hook(self)
        return self

    def __exit__(self, *exc):
        self._remove()


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
def _tree():
    return {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "n": np.int64(5)}


def test_checkpoint_round_trips_nested_tensors(tmp_path):
    path = str(tmp_path / "c.npz")
    tree = {"acc": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "half": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
            "seq": [np.int64(3), (np.ones(2, np.float64), None)]}
    ckpt.save(path, tree)
    raw = ckpt.peek(path)
    assert set(raw) == {"acc", "half", "seq/0", "seq/1/0"}
    assert raw["half"].dtype == np.float32  # bf16 stored as f32
    back = ckpt.restore(path, tree)
    assert back["acc"].dtype == torch.float32 and torch.equal(
        back["acc"], tree["acc"])
    assert back["half"].dtype == torch.bfloat16 and torch.equal(
        back["half"], tree["half"])
    assert back["seq"][0] == 3 and back["seq"][1][1] is None
    np.testing.assert_array_equal(back["seq"][1][0], np.ones(2))
    with np.load(path) as f:
        assert "__sha256__" in f and f["__sha256__"].shape == (32,)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(path, {**tree, "acc": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(path, {**tree, "other": torch.zeros(1)})


def _zero_length(path, tree):
    open(path, "wb").close()


def _torn(path, tree):
    torn_write(path)


def _bit_flip(path, tree):
    # a raw on-disk flip trips the archive's CRC first: still typed
    bit_flip(path, needle=tree["a"].tobytes())


def _tamper(path, tree):
    # a CRC-consistent rewrite with one value changed and the stale sha
    with np.load(path) as f:
        flat = {k: f[k].copy() for k in f.files}
    flat["a"].flat[0] += 1.0
    with open(path, "wb") as f:
        np.savez(f, **flat)


def _missing(path, tree):
    os.remove(path)


@pytest.mark.parametrize("corrupt,reason", [
    (_zero_length, "zero-length"), (_torn, "unreadable archive"),
    (_bit_flip, None), (_tamper, "sha256 mismatch"),
    (_missing, "does not exist")])
def test_checkpoint_corruption_raises_typed(tmp_path, corrupt, reason):
    path = str(tmp_path / "c.npz")
    ckpt.save(path, _tree())
    corrupt(path, _tree())
    with pytest.raises(CheckpointCorrupt, match=reason) as ei:
        ckpt.peek(path)
    assert ei.value.path == path
    with pytest.raises(CheckpointCorrupt):
        ckpt.restore(path, _tree())


def test_checkpoint_rotates_prev_and_loads_legacy_files(tmp_path):
    path = str(tmp_path / "c.npz")
    first = _tree()
    ckpt.save(path, first)
    second = {"a": first["a"] + 1.0, "n": np.int64(6)}
    ckpt.save(path, second)
    np.testing.assert_array_equal(ckpt.peek(path)["a"], second["a"])
    np.testing.assert_array_equal(
        ckpt.peek(path + ckpt.PREV_SUFFIX)["a"], first["a"])
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy[:-4], **_tree())
    np.testing.assert_array_equal(ckpt.peek(legacy)["a"], first["a"])


def test_checkpoint_files_read_across_the_packages(tmp_path):
    """The same npz format and content hash: each package's file passes
    the other's sha check and restores through it."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.int64(7), np.ones(3, np.float32)]}
    by_ref, by_port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jckpt.save(by_ref, tree)
    ckpt.save(by_port, tree)
    for path in (by_ref, by_port):
        for peek in (ckpt.peek, jckpt.peek):
            raw = peek(path)
            assert set(raw) == {"a", "b/0", "b/1"}
            np.testing.assert_array_equal(raw["a"], tree["a"])
    with open(by_ref, "rb") as f, open(by_port, "rb") as g:
        ref_sha = np.load(f)["__sha256__"]
        port_sha = np.load(g)["__sha256__"]
    np.testing.assert_array_equal(ref_sha, port_sha)
    back = ckpt.restore(by_ref, {"a": torch.zeros(2, 3),
                                 "b": [np.int64(0), torch.zeros(3)]})
    np.testing.assert_array_equal(back["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(back["b"][1].numpy(), tree["b"][1])
    template = {"a": tree["a"], "b": [np.int32(0), tree["b"][1]]}
    np.testing.assert_array_equal(
        jckpt.restore(by_port, template)["a"], tree["a"])


# --------------------------------------------------------------------------
# RetryPolicy, ExecPlan, validate_plan
# --------------------------------------------------------------------------
def test_retry_policy_delays_sleep_and_asdict():
    rp = RetryPolicy(max_attempts=6, base_delay_s=0.05, cap_delay_s=0.3)
    assert [rp.delay_s(a) for a in range(1, 6)] == \
        [0.05, 0.1, 0.2, 0.3, 0.3]
    slept = []
    rp = RetryPolicy(base_delay_s=0.5, sleep=slept.append)
    rp.wait(1)
    rp.wait(2)
    assert slept == [0.5, 1.0]
    d = ExecPlan(retry=RetryPolicy(sleep=_ch)).asdict()
    assert d["retry"]["sleep"] == _ch.__qualname__
    assert d["retry"]["max_attempts"] == 3
    assert ExecPlan().asdict() == jplan.ExecPlan().asdict()


@pytest.mark.parametrize("plan,match", [
    (ExecPlan(rng_plan="nope"), "rng_plan"),
    (ExecPlan(seed_chunk=3), "divide"),
    (ExecPlan(seed_chunk=0), "positive"),
    (ExecPlan(n_shards=3), "n_shards"),
    (ExecPlan(row_shards=2), "row_shards"),
    (ExecPlan(retry=RetryPolicy(max_attempts=0)), "max_attempts"),
    (ExecPlan(retry=RetryPolicy(base_delay_s=-1.0)), "nonnegative")])
def test_validate_plan_errors(plan, match):
    with pytest.raises(ValueError, match=match):
        validate_plan(plan, seeds=8, n_rows=3)


# --------------------------------------------------------------------------
# auto_plan and estimate_peak_bytes against the reference
# --------------------------------------------------------------------------
# the reference's own cases (tests/test_plan.py) at one device, then a
# grid over algorithms, chunks, antennas, b_max, participation, inversion
AUTO_CASES = [
    dict(n_rows=1, seeds=8, steps=10, n_max=16, dim=4),
    dict(n_rows=1, seeds=64, steps=50, n_max=256, dim=16,
         target_chunk_bytes=512 * 1024),
    dict(n_rows=1, seeds=1024, steps=150, n_max=4096, dim=24,
         memory_budget_bytes=2 * 2**30),
    dict(n_rows=3, seeds=16, steps=10, n_max=16, dim=4),
    dict(n_rows=3, seeds=96, steps=300, n_max=500, dim=90,
         algo_set=("gbma", "fdm", "centralized")),
    dict(n_rows=2, seeds=64, steps=200, n_max=800, dim=90,
         algo_set=("fdm",), invert_channel=True),
    dict(n_rows=2, seeds=64, steps=200, n_max=800, dim=90,
         algo_set=("fdm",), target_chunk_bytes=8 * 2**20),
    dict(n_rows=4, seeds=128, steps=600, n_max=500, dim=90,
         algo_set=("blind",), n_antennas=32),
    dict(n_rows=4, seeds=128, steps=600, n_max=160, dim=90,
         algo_set=("blind_ec",), m_sizes=(1, 4, 16, 64)),
    dict(n_rows=3, seeds=64, steps=300, n_max=80, dim=16,
         algo_set=("gbma",), b_max=25, participation_on=True),
    dict(n_rows=1, seeds=1024, steps=150, n_max=4096, dim=24,
         n_antennas=16, memory_budget_bytes=2 * 2**30),
    dict(n_rows=1, seeds=1024, steps=150, n_max=4096, dim=24,
         rng_plan="inscan", memory_budget_bytes=2 * 2**30),
    dict(n_rows=2, seeds=60, steps=400, n_max=4096, dim=24,
         algo_set=("power_control",), memory_budget_bytes=64 * 2**20,
         keep_seed_curves=True),
    dict(n_rows=1, seeds=12, steps=50, n_max=64, dim=8,
         algo_set=("nesterov",), target_chunk_bytes=0),
]


@pytest.mark.parametrize("case", range(len(AUTO_CASES)))
def test_auto_plan_equals_the_reference(case):
    kw = {"memory_budget_bytes": plan_mod.DEFAULT_MEMORY_BUDGET_BYTES,
          **AUTO_CASES[case], "device_count": 1}
    port = auto_plan(**kw)
    ref = jplan.auto_plan(**kw)
    assert port.asdict() == ref.asdict()
    if case == 2:  # LARGE: the reference's hand-tuned chunk, reduced
        assert port.seed_chunk == 32 and port.keep_seed_curves is False


def test_auto_plan_budget_defaults_and_measured_cost_model():
    assert plan_mod.device_memory_budget_bytes("cpu") \
        == plan_mod.DEFAULT_MEMORY_BUDGET_BYTES \
        == jplan.DEFAULT_MEMORY_BUDGET_BYTES
    assert plan_mod.DEFAULT_CHUNK_TARGET_BYTES \
        == jplan.DEFAULT_CHUNK_TARGET_BYTES
    kw = dict(n_rows=1, seeds=1024, steps=150, n_max=4096, dim=24)
    assert auto_plan(**kw, device="cpu") == auto_plan(
        **kw, memory_budget_bytes=plan_mod.DEFAULT_MEMORY_BUDGET_BYTES)
    with pytest.raises(NotImplementedError, match="ROADMAP M8"):
        auto_plan(**kw, device="cpu", cost_model="measured")
    with pytest.raises(ValueError, match="cost_model"):
        auto_plan(**kw, device="cpu", cost_model="guess")


ESTIMATE_GRID = [
    dict(algo_set=(a,), seed_chunk=c, n_antennas=m, b_max=b,
         participation_on=p, invert_channel=inv, rng_plan=rp,
         keep_seed_curves=keep)
    for a, m in (("gbma", None), ("gbma", 4), ("momentum", None),
                 ("fdm", None), ("power_control", None), ("blind", 8),
                 ("blind_ec", 2), ("centralized", None))
    for c, b, p, inv, rp, keep in ((None, 0, False, False, "hoisted", True),
                                   (16, 5, True, True, "hoisted", False),
                                   (8, 0, False, False, "inscan", True))
] + [dict(algo_set=("gbma", "fdm"), m_sizes=(1, 4)),
     dict(algo_set=("blind",), m_sizes=(2, 7), seed_chunk=32)]


@pytest.mark.parametrize("case", range(len(ESTIMATE_GRID)))
def test_estimate_peak_bytes_equals_the_reference(case):
    kw = dict(n_rows=3, seeds=64, steps=40, n_max=200, dim=90,
              **ESTIMATE_GRID[case])
    assert exec_mod.estimate_peak_bytes(**kw) \
        == jexec.estimate_peak_bytes(**kw)


# --------------------------------------------------------------------------
# Chan's merge
# --------------------------------------------------------------------------
def test_chan_merge_matches_numpy_and_the_reference():
    rs = np.random.default_rng(0)
    x = (3.0 + 1e-3 * rs.standard_normal((2, 23, 7))).astype(np.float32)
    mean, m2, n = np.zeros((2, 7), np.float32), np.zeros((2, 7),
                                                         np.float32), 0
    jmean, jm2 = mean, m2
    for lo, hi in ((0, 5), (5, 6), (6, 17), (17, 23)):
        blk = x[:, lo:hi]
        bm = blk.mean(axis=1)
        bm2 = ((blk - bm[:, None]) ** 2).sum(axis=1)
        mean, m2 = exec_mod.chan_merge(mean, m2, n, bm, bm2, hi - lo)
        jmean, jm2 = jexec.chan_merge(jmean, jm2, np.float32(n), bm, bm2,
                                      np.float32(hi - lo))
        assert mean.dtype == np.float32
        if n == 0:  # the first group comes through exactly
            np.testing.assert_array_equal(mean, bm)
            np.testing.assert_array_equal(m2, bm2)
        n = hi
    np.testing.assert_allclose(mean, np.asarray(jmean), rtol=1e-6)
    np.testing.assert_allclose(m2, np.asarray(jm2), rtol=1e-5)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(mean, x64.mean(axis=1), rtol=1e-6)
    np.testing.assert_allclose(m2, ((x64 - x64.mean(axis=1, keepdims=True))
                                    ** 2).sum(axis=1), rtol=1e-3)
    pm, pci = exec_mod.finalize_merged_stats(mean, m2, 23)
    jm, jci = jexec.finalize_merged_stats(mean, m2, 23)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(pci, jci)
    np.testing.assert_allclose(pci, 1.96 * x64.std(axis=1, ddof=1)
                               / np.sqrt(23), rtol=1e-3)
    assert np.all(exec_mod.finalize_merged_stats(mean, m2, 1)[1] == 0)
    # torch tensors merge as the arrays do
    tm, tm2 = exec_mod.chan_merge(torch.from_numpy(x[:, 0]),
                                  torch.zeros(2, 7), 1,
                                  torch.from_numpy(x[:, 1]),
                                  torch.zeros(2, 7), 1)
    am, am2 = exec_mod.chan_merge(x[:, 0], np.zeros((2, 7), np.float32), 1,
                                  x[:, 1], np.zeros((2, 7), np.float32), 1)
    np.testing.assert_array_equal(tm.numpy(), am)
    np.testing.assert_array_equal(tm2.numpy(), am2)


# --------------------------------------------------------------------------
# run_mc's plan resolution
# --------------------------------------------------------------------------
PLAN_ERRORS = [
    (dict(plan=ExecPlan(), rng_plan="hoisted"), ValueError, "rng_plan"),
    (dict(plan="auto", seed_chunk=2), ValueError, "seed_chunk"),
    (dict(plan=ExecPlan(), keep_seed_curves=False), ValueError,
     "keep_seed_curves"),
    (dict(plan="auto", ota_impl="ref"), ValueError, "ota_impl"),
    (dict(plan=ExecPlan(), shard_seeds=False), ValueError, "shard_seeds"),
    (dict(plan="fast"), ValueError, "ExecPlan or the string 'auto'"),
    (dict(rng_plan="fast"), ValueError, "rng_plan"),
    (dict(memory_budget_bytes=2**30), ValueError, "memory_budget_bytes"),
    (dict(plan=ExecPlan(), memory_budget_bytes=2**30), ValueError,
     "memory_budget_bytes"),
    (dict(resume_dir="r"), ValueError, "seed_chunk"),
    (dict(resume_dir="r", seed_chunk=2), ValueError, "keep_seed_curves"),
    (dict(seed_chunk=3), ValueError, "divide"),
    (dict(plan=ExecPlan(ota_impl="inline")), ValueError, "ota_impl"),
    (dict(plan=ExecPlan(n_shards=2)), NotImplementedError, "ROADMAP M8"),
    (dict(plan=ExecPlan(n_shards=4, seed_chunk=4)), NotImplementedError,
     "ROADMAP M8"),
]


@pytest.mark.parametrize("kw,err,match", PLAN_ERRORS)
def test_run_mc_plan_errors(mc, kw, err, match):
    _, tp = mc
    with pytest.raises(err, match=match):
        run_mc(tp, [_pch()], "gbma", [0.01], 4, SEEDS, device="cpu", **kw)


def test_row_placement_raises_naming_m8(mc):
    _, tp = mc
    with pytest.raises(NotImplementedError, match="ROADMAP M8"):
        run_mc(tp, [_pch(), _pch()], "gbma", [0.01, 0.02], 4, SEEDS,
               plan=ExecPlan(row_shards=2), device="cpu")


def test_run_mc_records_the_resolved_plan(mc):
    """The legacy knobs build the equivalent `ExecPlan` (the same run,
    bit for bit), `shard_seeds` places nothing on one device, "auto"
    resolves a concrete plan, and `slice_result` keeps the plan."""
    _, tp = mc
    args = (tp, [_pch(), _pch(noise_std=1.0)], "gbma", [0.01, 0.02], 6,
            SEEDS)
    legacy = run_mc(*args, rng_plan="inscan", seed_chunk=4,
                    keep_seed_curves=False, shard_seeds=True, device="cpu")
    assert legacy.plan == ExecPlan(rng_plan="inscan", seed_chunk=4,
                                   n_shards=1, keep_seed_curves=False)
    pinned = run_mc(*args, plan=legacy.plan, device="cpu")
    np.testing.assert_array_equal(pinned.mean, legacy.mean)
    np.testing.assert_array_equal(pinned.ci95, legacy.ci95)
    assert run_mc(*args, device="cpu").plan == ExecPlan()
    auto = run_mc(*args, plan="auto", device="cpu")
    assert auto.plan == ExecPlan(n_shards=0)
    assert slice_result(auto, [1]).plan == auto.plan
    tiny = run_mc(*args, plan="auto", memory_budget_bytes=4096,
                  device="cpu")
    assert tiny.plan.seed_chunk == 1 and not tiny.plan.keep_seed_curves


# --------------------------------------------------------------------------
# chunks against the reference, and against the port's unchunked calls
# --------------------------------------------------------------------------
def _families(mc, logistic):
    (jp, tp), (jl, tl) = mc, logistic
    return {
        "gbma": (jp, tp, "gbma", 0.01, {}),
        "fdm": (jp, tp, "fdm", 0.01, {}),
        "centralized": (jp, tp, "centralized", 0.01, {}),
        "power_control": (jp, tp, "power_control", 0.01, {}),
        "nesterov": (jp, tp, "nesterov", 0.01, {"momentum": 0.6}),
        "blind": (jp, tp, "blind", 0.01, {"n_antennas": 2}),
        "blind_ec": (jp, tp, "blind_ec", 0.01,
                     {"n_antennas": 2, "power_budget": 0.05}),
        "logistic": (jl, tl, "gbma", 0.3, {"batch_frac": 0.5}),
    }


FAMILIES = ("gbma", "fdm", "centralized", "power_control", "nesterov",
            "blind", "blind_ec", "logistic")


def _logistic_floor(jl) -> float:
    """F8's floor: 4 ulps of the logistic F* (ROADMAP §3)."""
    f_star = float(np.asarray(jl.data["f_star"]).reshape(-1)[0])
    return 4.0 * float(np.spacing(np.float32(f_star)))


@pytest.mark.parametrize("family", FAMILIES)
def test_chunked_calls_match_the_reference(mc, logistic, family):
    jp, tp, algo, beta, kw = _families(mc, logistic)[family]
    keep = family in ("gbma", "fdm", "power_control", "blind_ec")
    args = ([_ch()], algo, [beta], STEPS, SEEDS)
    with jax_original_layout():
        ref = jax_run_mc(jp, *args, seed_chunk=2, keep_seed_curves=keep,
                         **kw)
    out = run_mc(tp, [_pch()], algo, [beta], STEPS, SEEDS, seed_chunk=2,
                 keep_seed_curves=keep, device="cpu", **kw)
    atol = _logistic_floor(jl=logistic[0]) if family == "logistic" else 0.0
    np.testing.assert_allclose(out.mean, ref.mean, rtol=1e-5, atol=atol)
    assert np.all(np.abs(out.ci95 - ref.ci95)
                  <= 1e-5 * np.abs(ref.ci95) + 1e-5 * np.abs(ref.mean)
                  + atol)
    if keep:
        np.testing.assert_allclose(out.risks, ref.risks, rtol=1e-5,
                                   atol=atol)
        np.testing.assert_allclose(out.cum_energy, ref.cum_energy,
                                   rtol=1e-5)
    else:
        assert out.risks is None and out.cum_energy is None


def test_chunked_matches_unchunked_across_families(mc, logistic):
    """The reference's own 1e-6 criterion: chunked curves reproduce the
    all-live call for every family."""
    for family, (_, tp, algo, beta, kw) in _families(mc,
                                                     logistic).items():
        args = (tp, [_pch()], algo, [beta], STEPS, SEEDS)
        full = run_mc(*args, device="cpu", **kw)
        chunked = run_mc(*args, seed_chunk=2, device="cpu", **kw)
        for f in ("risks", "cum_energy", "mean"):
            np.testing.assert_allclose(getattr(chunked, f), getattr(full, f),
                                       rtol=1e-6, atol=1e-10,
                                       err_msg=f"{family} {f}")


# --------------------------------------------------------------------------
# resume
# --------------------------------------------------------------------------
def _counting_merge(monkeypatch):
    offs = []
    real = exec_mod._mc_moments_merge

    def counting(acc_mean, acc_m2, n_prev, *a, **k):
        offs.append(int(n_prev))
        return real(acc_mean, acc_m2, n_prev, *a, **k)

    monkeypatch.setattr(exec_mod, "_mc_moments_merge", counting)
    return offs


@pytest.mark.parametrize("family", ["gbma", "blind", "logistic"])
def test_interrupted_resume_is_bit_identical(family, mc, logistic, tmp_path,
                                             monkeypatch):
    """Interrupt at chunk k (ckpt.save raises after k saves), rerun with
    the same resume_dir: the moments equal the uninterrupted sweep's bit
    for bit, and the rerun starts at the first unfinished chunk."""
    _, tp, algo, beta, fkw = _families(mc, logistic)[family]
    args = (tp, [_pch()], algo, [beta], STEPS, SEEDS)
    kw = dict(seed_chunk=2, keep_seed_curves=False, device="cpu", **fkw)
    uninterrupted = run_mc(*args, **kw)

    real_save, calls = ckpt.save, {"n": 0}

    def dying_save(path, tree):
        real_save(path, tree)
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("simulated preemption")

    monkeypatch.setattr(ckpt, "save", dying_save)
    with pytest.raises(RuntimeError, match="preemption"):
        run_mc(*args, resume_dir=str(tmp_path), **kw)
    monkeypatch.setattr(ckpt, "save", real_save)
    assert int(ckpt.peek(str(tmp_path / exec_mod._RESUME_FILE))
               ["next_off"]) == 4  # 2 chunks of 2 seeds survived

    offs = _counting_merge(monkeypatch)
    resumed = run_mc(*args, resume_dir=str(tmp_path), **kw)
    assert offs == [4, 6]  # only the unfinished chunks ran
    np.testing.assert_array_equal(resumed.mean, uninterrupted.mean)
    np.testing.assert_array_equal(resumed.ci95, uninterrupted.ci95)


def test_finished_sweep_resume_short_circuits(mc, tmp_path, monkeypatch):
    _, tp = mc
    kw = dict(seed_chunk=2, keep_seed_curves=False,
              resume_dir=str(tmp_path), device="cpu")
    first = run_mc(tp, [_pch()], "gbma", [0.01], STEPS, SEEDS, **kw)

    def no_merge(*a, **k):  # pragma: no cover - failure path
        raise AssertionError("a finished sweep must not re-run chunks")

    monkeypatch.setattr(exec_mod, "_mc_moments_merge", no_merge)
    again = run_mc(tp, [_pch()], "gbma", [0.01], STEPS, SEEDS, **kw)
    np.testing.assert_array_equal(first.mean, again.mean)
    np.testing.assert_array_equal(first.ci95, again.ci95)


def test_resume_rejects_a_foreign_checkpoint(mc, tmp_path):
    _, tp = mc
    kw = dict(plan=ExecPlan(seed_chunk=2, keep_seed_curves=False),
              resume_dir=str(tmp_path), device="cpu")
    run_mc(tp, [_pch()], "gbma", [0.01], STEPS, SEEDS, **kw)
    with pytest.raises(ValueError, match="fingerprint"):
        # a different stepsize is a different workload, same directory
        run_mc(tp, [_pch()], "gbma", [0.02], STEPS, SEEDS, **kw)


def test_corrupt_main_checkpoint_falls_back_to_prev(mc, tmp_path,
                                                    monkeypatch):
    _, tp = mc
    args = (tp, [_pch()], "gbma", [0.01], STEPS, SEEDS)
    kw = dict(plan=ExecPlan(seed_chunk=2, keep_seed_curves=False),
              resume_dir=str(tmp_path), device="cpu")
    clean = run_mc(*args, **kw)
    main = str(tmp_path / exec_mod._RESUME_FILE)
    assert int(ckpt.peek(main)["next_off"]) == SEEDS
    assert int(ckpt.peek(main + ckpt.PREV_SUFFIX)["next_off"]) == SEEDS - 2
    torn_write(main)
    offs = _counting_merge(monkeypatch)
    with pytest.warns(UserWarning, match="corrupt resume checkpoint"):
        resumed = run_mc(*args, **kw)
    assert offs == [SEEDS - 2]  # resumed from .prev: one chunk redone
    np.testing.assert_array_equal(resumed.mean, clean.mean)
    np.testing.assert_array_equal(resumed.ci95, clean.ci95)


def test_both_corrupt_checkpoints_restart_with_a_warning(mc, tmp_path):
    _, tp = mc
    args = (tp, [_pch()], "gbma", [0.01], STEPS, SEEDS)
    kw = dict(plan=ExecPlan(seed_chunk=2, keep_seed_curves=False),
              resume_dir=str(tmp_path), device="cpu")
    clean = run_mc(*args, **kw)
    main = str(tmp_path / exec_mod._RESUME_FILE)
    torn_write(main)
    open(main + ckpt.PREV_SUFFIX, "wb").close()
    with pytest.warns(UserWarning, match="restarting the sweep"):
        restarted = run_mc(*args, **kw)
    np.testing.assert_array_equal(restarted.mean, clean.mean)
    np.testing.assert_array_equal(restarted.ci95, clean.ci95)


# --------------------------------------------------------------------------
# retry
# --------------------------------------------------------------------------
def test_k_faults_give_bit_identical_moments_and_curves(mc):
    _, tp = mc
    args = (tp, [_pch(), _pch(noise_std=1.0)], "gbma", [0.01, 0.02],
            STEPS, SEEDS)
    plan = ExecPlan(seed_chunk=2, keep_seed_curves=False)
    clean = run_mc(*args, plan=plan, device="cpu")
    slept = []
    with _Faults({0: 1, 4: 2}) as faults:
        survived = run_mc(*args, plan=plan.replace(
            retry=_retry(sleep=slept.append)), device="cpu")
    assert len(faults.fired) == 3
    assert slept == [0.05, 0.05, 0.1]  # the backoff restarts per chunk
    np.testing.assert_array_equal(survived.mean, clean.mean)
    np.testing.assert_array_equal(survived.ci95, clean.ci95)

    plan = ExecPlan(seed_chunk=2)
    clean = run_mc(*args, plan=plan, device="cpu")
    with _Faults({2: 1, 6: 1}):
        survived = run_mc(*args, plan=plan.replace(retry=_retry()),
                          device="cpu")
    for f in ("risks", "cum_energy", "mean", "ci95"):
        np.testing.assert_array_equal(getattr(survived, f),
                                      getattr(clean, f))


def test_faults_without_budget_or_past_it_reraise(mc):
    _, tp = mc
    args = (tp, [_pch()], "gbma", [0.01], STEPS, SEEDS)
    with _Faults({0: 1}):
        with pytest.raises(RuntimeError, match="injected chunk fault"):
            run_mc(*args, plan=ExecPlan(seed_chunk=2,
                                        keep_seed_curves=False),
                   device="cpu")
    with _Faults({2: 2}) as faults:  # needs 3 attempts
        with pytest.raises(RuntimeError, match="injected chunk fault"):
            run_mc(*args, plan=ExecPlan(seed_chunk=2, keep_seed_curves=False,
                                        retry=_retry(max_attempts=2)),
                   device="cpu")
    assert len(faults.fired) == 2  # both attempts burned


def test_checkpoint_save_stays_outside_the_retry(mc, tmp_path,
                                                 monkeypatch):
    _, tp = mc

    def dying_save(path, tree):
        raise RuntimeError("simulated disk death")

    monkeypatch.setattr(ckpt, "save", dying_save)
    with pytest.raises(RuntimeError, match="disk death"):
        run_mc(tp, [_pch()], "gbma", [0.01], STEPS, SEEDS,
               plan=ExecPlan(seed_chunk=2, keep_seed_curves=False,
                             retry=_retry()),
               resume_dir=str(tmp_path), device="cpu")


# --------------------------------------------------------------------------
# the fingerprint across processes
# --------------------------------------------------------------------------
_FINGERPRINT = """
import numpy as np
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.mc import exec as exec_mod
from repro_torch.core.mc.engine import run_mc
from repro_torch.core.mc.problems import logistic_mc_problem
rs = np.random.default_rng(3)
X = rs.standard_normal((40, 6))
y = np.where(rs.standard_normal(40) > 0, 1.0, -1.0)
prob = logistic_mc_problem(X, y, 8, lam=0.1, device="cpu")
seen = []
real = exec_mod._workload_fingerprint
exec_mod._workload_fingerprint = lambda *a: seen.append(real(*a)) or seen[-1]
run_mc(prob, [ChannelConfig(fading="rayleigh"), ChannelConfig()],
       ("gbma", "blind"), [0.3, 0.2], 4, 4, n_antennas=(1, 3),
       batch_frac=0.5, seed_chunk=2, keep_seed_curves=False, device="cpu")
print(bytes(seen[0]).hex())
"""


def test_workload_fingerprint_is_equal_in_fresh_processes():
    """No address, device index or other per-process value enters the
    fingerprint: two fresh interpreters agree (callables, the minibatch
    functions inside a tuple among them, hash by qualname)."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    runs = [subprocess.run([sys.executable, "-c", _FINGERPRINT], env=env,
                           capture_output=True, text=True, timeout=120,
                           check=True).stdout.strip() for _ in range(2)]
    assert len(runs[0]) == 64 and runs[0] == runs[1]


def test_static_signature_hashes_callables_by_qualname():
    a = exec_mod.static_signature({"f": _ch, "t": (_ch, 3), "n": 4})
    b = exec_mod.static_signature({"n": 4, "t": (_ch, 3), "f": _ch})
    assert a == b and len(a) == 64
    assert a != exec_mod.static_signature({"f": _pch, "t": (_ch, 3),
                                           "n": 4})
    assert dataclasses.is_dataclass(ExecPlan)


def test_figure_twins_pass_the_plan_through():
    """`run_fig2` / `run_fig3` hand `plan=` to `run_mc`, as the
    reference's `benchmarks/common.run_msd_figure` does: the per-step
    plan gives the default's rows exactly, a chunked reduced plan the
    same rows, and a legacy knob beside a plan raises."""
    from repro_torch.figures import run_fig3

    kw = dict(device="cpu", n_grid=(10, 20), eps_grid=(1.0,), steps=20,
              seeds=4)
    base = run_fig3(**kw)
    assert run_fig3(plan=ExecPlan(rng_plan="inscan"), **kw) == base
    chunked = run_fig3(plan=ExecPlan(seed_chunk=2, keep_seed_curves=False),
                       **kw)
    assert [r.split(",")[:-1] for r in chunked] \
        == [r.split(",")[:-1] for r in base]
    with pytest.raises(ValueError, match="ota_impl"):
        run_fig3(plan="auto", ota_impl="ref", **kw)
