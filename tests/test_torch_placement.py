"""Seed and row placement over a `(rows × mc)` mesh (ROADMAP M8), on the
CPU.

The reference places `_mc_core_impl` under `shard_map` over a
`("rows", "mc")` device mesh; its tests reach that path on one CPU with
forced host devices. The port runs one block per mesh device
(`exec.run_core`), and a device list that names the CPU four times is
its counterpart of four forced host devices.

* Against the reference: a subprocess runs `repro`'s `run_mc` under
  `XLA_FLAGS=--xla_force_host_platform_device_count=4`,
  `JAX_PLATFORMS=cpu` and `jax.threefry_partitionable(False)`, with
  `repro.compat.shard_map` set to `jax.shard_map(check_vma=False)` in
  that process only: under JAX 0.9.0 the reference's placed scan fails
  the varying-manual-axes check without it (ROADMAP §3, R7). It prints
  the curves of `ExecPlan(n_shards=2, row_shards=2)` over two channels
  and the chunked moments at `n_shards` 1, 2 and 4. The port's placed
  runs over four CPU entries are held to them: curves at the engine
  parity bar (rtol 1e-5: normals differ by an ulp, R2), the chunked mean
  at rtol 1e-6 and ci95 at rtol 1e-5 + atol 1e-9 (the reference's own
  placement bars, `tests/test_plan.py:341-344`).
* Against itself: placed curves and energies equal the unplaced call's
  bit for bit at (2 × 2), (1 × 4) and (4 × 1), under both RNG plans, for
  one algorithm, mixed algorithms (a row block of one algorithm keeps
  the call's per-step draws), rows of different N, antennas with error
  feedback, participation and minibatch logistic rows (fig8's shape);
  unchunked reduced statistics too, and `plan="auto"` over the list.
* The reference's placement tests, ported: `auto_plan` over the topology
  (and equal to the reference's at 4 devices over `test_torch_plan`'s
  cases), the oversubscription `ValueError`, `shard_seeds=True` matching
  the plain path, the cost model pricing a placed plan as the
  reference's does.
* Resume: a placed chunked sweep resumes bit for bit under its own
  mesh; under another mesh its checkpoint is another workload's and is
  refused (the reference's fingerprint error), and the sweep starts
  over from the first chunk.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from test_torch_helpers import port_problem  # noqa: E402

from benchmarks.common import MSDProblem  # noqa: E402
from repro.core.mc import plan as jplan  # noqa: E402
from repro.core.mc.costmodel import CostModel as JCostModel  # noqa: E402
from repro.core.mc.costmodel import Workload as JWorkload  # noqa: E402
from repro.data.synthetic import logistic_classification  # noqa: E402
from repro.core.montecarlo import logistic_mc_problem  # noqa: E402
from repro_torch import _device  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.mc import exec as exec_mod  # noqa: E402
from repro_torch.core.mc.costmodel import (CostModel,  # noqa: E402
                                           Workload, analytic_cost_model)
from repro_torch.core.mc.engine import run_mc  # noqa: E402
from repro_torch.core.mc.plan import (ExecPlan, auto_plan,  # noqa: E402
                                      resolve_seed_shards)

N, D, STEPS, SEEDS = 12, 8, 10, 8
ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU4 = ["cpu"] * 4

_REFERENCE = """
import functools, json
import jax
import numpy as np
import repro.compat
# R7: JAX 0.9.0's varying-manual-axes check rejects the reference's placed
# scan carry; exec.py looks compat.shard_map up when it runs
repro.compat.shard_map = functools.partial(jax.shard_map, check_vma=False)
from benchmarks.common import MSDProblem
from repro.core.channel import ChannelConfig
from repro.core.mc import ExecPlan, run_mc

assert jax.device_count() == 4, jax.devices()
mc = MSDProblem.make({n}, dim={d}).to_mc()
ch = ChannelConfig(fading="rayleigh", noise_std=0.5)
out = {{}}
with jax.threefry_partitionable(False):
    for name, k, rows in (("curves", 2, 2), ("unplaced curves", 0, 1)):
        res = run_mc(mc, [ch, ChannelConfig(fading="rayleigh",
                                            noise_std=0.7)],
                     "gbma", [0.01, 0.02], {steps}, {seeds},
                     plan=ExecPlan(n_shards=k, row_shards=rows))
        out[name] = {{"risks": res.risks.tolist(),
                      "cum_energy": res.cum_energy.tolist()}}
    for k in (1, 2, 4):
        res = run_mc(mc, [ch], "gbma", [0.01], {steps}, {seeds},
                     plan=ExecPlan(seed_chunk=4, n_shards=k,
                                   keep_seed_curves=False))
        out[str(k)] = {{"mean": res.mean.tolist(),
                        "ci95": res.ci95.tolist()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_placed():
    """The reference's placed runs under 4 forced host devices (a
    subprocess: XLA_FLAGS must be set before JAX starts)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH"))
        if p)
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE.format(n=N, d=D, steps=STEPS,
                                                 seeds=SEEDS)],
        env=env, capture_output=True, text=True, cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def mc():
    return port_problem(MSDProblem.make(N, dim=D).to_mc())


def _ch(**kw):
    kw.setdefault("fading", "rayleigh")
    kw.setdefault("noise_std", 0.5)
    return ChannelConfig(**kw)


# --------------------------------------------------------------------------
# against the reference's placed path
# --------------------------------------------------------------------------
def test_placed_curves_match_the_reference_mesh(mc, reference_placed):
    placed = run_mc(mc, [_ch(), _ch(noise_std=0.7)], "gbma", [0.01, 0.02],
                    STEPS, SEEDS, plan=ExecPlan(n_shards=2, row_shards=2),
                    device=CPU4)
    ref = reference_placed["curves"]
    np.testing.assert_allclose(placed.risks, np.float32(ref["risks"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(placed.cum_energy,
                               np.float32(ref["cum_energy"]), rtol=1e-5,
                               atol=0)


def test_the_shimmed_reference_places_its_own_curves(reference_placed):
    """R7's shim runs the reference's placed path as its own tests mean
    it to: placed curves equal its unplaced ones bit for bit, and its
    placed chunked moments equal its unplaced chunks' (`n_shards=1`)
    within its placement bars."""
    for f in ("risks", "cum_energy"):
        assert reference_placed["curves"][f] \
            == reference_placed["unplaced curves"][f]
    base = reference_placed["1"]
    for k in ("2", "4"):
        np.testing.assert_allclose(reference_placed[k]["mean"],
                                   base["mean"], rtol=1e-6)
        np.testing.assert_allclose(reference_placed[k]["ci95"],
                                   base["ci95"], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_placed_chunked_moments_match_the_reference(mc, reference_placed,
                                                    n_shards):
    placed = run_mc(mc, [_ch()], "gbma", [0.01], STEPS, SEEDS,
                    plan=ExecPlan(seed_chunk=4, n_shards=n_shards,
                                  keep_seed_curves=False), device=CPU4)
    ref = reference_placed[str(n_shards)]
    np.testing.assert_allclose(placed.mean, np.float32(ref["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(placed.ci95, np.float32(ref["ci95"]),
                               rtol=1e-5, atol=1e-9)


# --------------------------------------------------------------------------
# placed against unplaced, bit for bit
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def logistic():
    X, y, _ = logistic_classification(40, dim=6, seed=3)
    return port_problem(logistic_mc_problem(X, y, 8, lam=0.1))


def _workload(name, mc, logistic):
    chs = [_ch(noise_std=0.5 + 0.1 * i, energy=1.0 / (i + 1))
           for i in range(4)]
    betas = [0.01, 0.02, 0.015, 0.01]
    if name == "gbma":
        return (mc, chs, "gbma", betas), {}
    if name == "mixed algos":  # row block 0 holds gbma alone at (2 x 2)
        return (mc, chs, ("gbma", "gbma", "fdm", "centralized"), betas), {}
    if name == "rows of different N":
        mcs = [port_problem(MSDProblem.make(n, dim=D).to_mc())
               for n in (12, 7, 12, 5)]
        return (mcs, chs, ("gbma", "momentum", "nesterov", "gbma"),
                betas), {}
    if name == "antennas, error feedback":
        return (mc, chs, ("gbma", "blind_ec", "blind", "centralized"),
                betas), {"n_antennas": (1, 3, 2, 1), "power_budget": 0.05}
    if name == "participation":
        return (mc, chs, "power_control", betas), {
            "participation": (0.5, 1.0, 0.7, 0.9)}
    assert name == "minibatch logistic"  # fig8's shape
    return (logistic, chs, ("gbma", "gbma", "centralized", "blind"),
            [0.3] * 4), {"batch_frac": (0.5, 0.25, 1.0, 0.5),
                         "n_antennas": (1, 1, 1, 2)}


WORKLOADS = ("gbma", "mixed algos", "rows of different N",
             "antennas, error feedback", "participation",
             "minibatch logistic")
MESHES = ((2, 2), (1, 4), (4, 1))


@pytest.mark.parametrize("rows,mc_size", MESHES)
@pytest.mark.parametrize("name", WORKLOADS)
def test_placed_curves_equal_unplaced_bit_for_bit(mc, logistic, name, rows,
                                                  mc_size):
    """Each block replays its trajectories' streams with the call's
    static sizes (N_max, node counts, b_max, the algorithm set that
    decides hoisting), so no bit moves."""
    args, kw = _workload(name, mc, logistic)
    for rng_plan in ("hoisted", "inscan"):
        plain = run_mc(*args, STEPS, SEEDS, rng_plan=rng_plan,
                       device="cpu", **kw)
        placed = run_mc(*args, STEPS, SEEDS, device=CPU4, plan=ExecPlan(
            rng_plan=rng_plan, n_shards=mc_size, row_shards=rows), **kw)
        np.testing.assert_array_equal(placed.risks, plain.risks)
        np.testing.assert_array_equal(placed.cum_energy, plain.cum_energy)
        np.testing.assert_array_equal(placed.mean, plain.mean)
        np.testing.assert_array_equal(placed.ci95, plain.ci95)


@pytest.mark.parametrize("rows,mc_size", MESHES)
def test_placed_reduced_statistics_equal_unplaced(mc, rows, mc_size):
    """Unchunked `keep_seed_curves=False`: the moments of the gathered
    curves, as the reference reduces a placed call's curves."""
    args = (mc, [_ch(noise_std=0.4 + 0.1 * i) for i in range(4)], "gbma",
            [0.01] * 4, STEPS, SEEDS)
    plain = run_mc(*args, keep_seed_curves=False, device="cpu")
    placed = run_mc(*args, device=CPU4, plan=ExecPlan(
        n_shards=mc_size, row_shards=rows, keep_seed_curves=False))
    assert placed.risks is None and placed.cum_energy is None
    np.testing.assert_array_equal(placed.mean, plain.mean)
    np.testing.assert_array_equal(placed.ci95, plain.ci95)


def test_auto_plan_places_over_a_device_list(mc):
    """`plan="auto"` sizes the mesh from the list's length: 8 seeds take
    all four entries, and the curves stay the unplaced ones."""
    args = (mc, [_ch(), _ch(noise_std=0.7)], "gbma", [0.01, 0.02], STEPS,
            SEEDS)
    auto = run_mc(*args, plan="auto", device=CPU4)
    assert (auto.plan.n_shards, auto.plan.row_shards) == (4, 1)
    assert auto.device == "cpu,cpu,cpu,cpu"
    plain = run_mc(*args, device="cpu")
    np.testing.assert_array_equal(auto.risks, plain.risks)


def test_placed_chunks_run_one_block_per_mesh_entry(mc, monkeypatch):
    """Each chunk runs one block per mesh entry, row blocks in order and
    each over its seed blocks, with the block's own rows' algorithms;
    the merged moments hold the unplaced curves' at the reference's
    placement bars."""
    seen = []
    real = exec_mod._run_block

    def recording(params, betas, *a, **kw):
        seen.append((betas.device.type, len(a[1]), kw["algos"]))
        return real(params, betas, *a, **kw)

    monkeypatch.setattr(exec_mod, "_run_block", recording)
    ch = [_ch(), _ch(noise_std=0.7)]
    out = run_mc(mc, ch, ("gbma", "fdm"), [0.01, 0.02], STEPS, SEEDS,
                 plan=ExecPlan(seed_chunk=4, n_shards=2, row_shards=2,
                               keep_seed_curves=False), device=CPU4)
    # 2 chunks x (row block 0: gbma, row block 1: fdm) x 2 seed blocks of 2
    assert seen == [("cpu", 2, ("gbma",)), ("cpu", 2, ("gbma",)),
                    ("cpu", 2, ("fdm",)), ("cpu", 2, ("fdm",))] * 2
    monkeypatch.setattr(exec_mod, "_run_block", real)
    plain = run_mc(mc, ch, ("gbma", "fdm"), [0.01, 0.02], STEPS, SEEDS,
                   device="cpu")
    mean, ci95 = exec_mod.host_seed_stats(plain.risks)
    np.testing.assert_allclose(out.mean, mean, rtol=1e-6)
    np.testing.assert_allclose(out.ci95, ci95, rtol=1e-5, atol=1e-9)


# --------------------------------------------------------------------------
# the mesh's devices
# --------------------------------------------------------------------------
def test_mesh_devices_and_visible_counts(monkeypatch):
    cpu = torch.device("cpu")
    assert _device.visible_device_count(CPU4) == 4
    assert _device.visible_device_count("cpu") == 1
    assert _device.mesh_devices(CPU4, 2, 2) == [cpu] * 4
    assert _device.mesh_devices(["cpu"] * 6, 1, 4) == [cpu] * 4
    assert _device.mesh_devices("cpu", 1, 0) == [cpu]
    assert _device.mesh_devices("cpu", 3, 0) == [cpu] * 3
    with pytest.raises(ValueError, match="needs 4 devices"):
        _device.mesh_devices(["cpu", "cpu"], 2, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert _device.visible_device_count(None) == 0
    assert _device.visible_device_count("cuda") == 0
    for device in (None, "cuda", ["cuda:0"] * 4):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _device.mesh_devices(device, 2, 2)


def test_a_cuda_mesh_takes_the_cards_from_the_devices_index(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert _device.visible_device_count(None) == 4
    assert _device.visible_device_count("cuda:1") == 3
    assert _device.mesh_devices(None, 2, 2) == [
        torch.device("cuda", i) for i in range(4)]
    assert _device.mesh_devices("cuda:2", 1, 2) == [
        torch.device("cuda", 2), torch.device("cuda", 3)]
    assert _device.mesh_devices(["cuda:0"] * 4, 1, 4) == [
        torch.device("cuda:0")] * 4
    with pytest.raises(ValueError, match="4 are visible"):
        _device.mesh_devices("cuda:1", 1, 4)


# --------------------------------------------------------------------------
# the reference's placement tests, ported
# --------------------------------------------------------------------------
def test_auto_plan_places_over_the_topology():
    p = auto_plan(n_rows=3, seeds=16, steps=10, n_max=16, dim=4,
                  device_count=4, device="cpu")
    assert p.n_shards == 4 and p.row_shards == 1
    # the seed axis does not divide: the row axis picks up the devices
    p = auto_plan(n_rows=4, seeds=9, steps=10, n_max=16, dim=4,
                  device_count=4, device="cpu")
    assert p.n_shards == 0 and p.row_shards == 4
    # the device count of a list is its length
    assert auto_plan(n_rows=3, seeds=16, steps=10, n_max=16, dim=4,
                     device=CPU4) == auto_plan(
        n_rows=3, seeds=16, steps=10, n_max=16, dim=4, device_count=4,
        memory_budget_bytes=2 * 2**30)


def test_auto_plan_chunk_is_a_multiple_of_the_seed_shards():
    p = auto_plan(n_rows=1, seeds=64, steps=50, n_max=256, dim=16,
                  device_count=4, target_chunk_bytes=512 * 1024,
                  device="cpu")
    assert p.n_shards == 4 and p.seed_chunk is not None
    assert p.seed_chunk % p.n_shards == 0


# test_torch_plan.AUTO_CASES, at four devices
AUTO_CASES_4 = [
    dict(n_rows=1, seeds=8, steps=10, n_max=16, dim=4),
    dict(n_rows=1, seeds=64, steps=50, n_max=256, dim=16,
         target_chunk_bytes=512 * 1024),
    dict(n_rows=1, seeds=1024, steps=150, n_max=4096, dim=24),
    dict(n_rows=3, seeds=16, steps=10, n_max=16, dim=4),
    dict(n_rows=4, seeds=9, steps=10, n_max=16, dim=4),
    dict(n_rows=2, seeds=6, steps=10, n_max=16, dim=4),
    dict(n_rows=3, seeds=96, steps=300, n_max=500, dim=90,
         algo_set=("gbma", "fdm", "centralized")),
    dict(n_rows=4, seeds=128, steps=600, n_max=160, dim=90,
         algo_set=("blind_ec",), m_sizes=(1, 4, 16, 64)),
    dict(n_rows=3, seeds=64, steps=300, n_max=80, dim=16,
         algo_set=("gbma",), b_max=25, participation_on=True),
    dict(n_rows=2, seeds=60, steps=400, n_max=4096, dim=24,
         algo_set=("power_control",), memory_budget_bytes=64 * 2**20),
]


@pytest.mark.parametrize("case", range(len(AUTO_CASES_4)))
def test_auto_plan_at_four_devices_equals_the_reference(case):
    kw = {"memory_budget_bytes": 2 * 2**30, **AUTO_CASES_4[case],
          "device_count": 4}
    assert auto_plan(**kw).asdict() == jplan.auto_plan(**kw).asdict()


@pytest.mark.parametrize("plan,seeds,ndev", [
    (ExecPlan(n_shards=2, row_shards=2), 8, 2),
    (ExecPlan(n_shards=2, row_shards=2), 8, 4),
    (ExecPlan(n_shards=4, seed_chunk=4), 8, 4),
    (ExecPlan(n_shards=0, row_shards=2), 8, 2),
    (ExecPlan(n_shards=0, row_shards=2), 8, 4),
    (ExecPlan(row_shards=2), 9, 4),
    (ExecPlan(), 8, 4), (ExecPlan(), 6, 4), (ExecPlan(n_shards=1), 8, 1)])
def test_resolve_seed_shards_equals_the_reference(plan, seeds, ndev):
    """The oversubscription error where the reference raises, its value
    elsewhere."""
    jp = jplan.ExecPlan(**{k: v for k, v in plan.asdict().items()
                           if k != "retry"})
    try:
        want = jplan.resolve_seed_shards(jp, seeds, device_count=ndev)
    except ValueError:
        with pytest.raises(ValueError, match="device"):
            resolve_seed_shards(plan, seeds, device_count=ndev)
    else:
        assert resolve_seed_shards(plan, seeds, device_count=ndev) == want


def test_resolve_seed_shards_oversubscription():
    plan = ExecPlan(n_shards=2, row_shards=2)
    with pytest.raises(ValueError, match="device"):
        resolve_seed_shards(plan, 8, device_count=2)
    # row meshes the reference's check passes and its make_mesh refuses:
    # without seed shards, and under the auto rule, which takes every
    # device for the seeds whatever the rows
    for plan, seeds in ((ExecPlan(n_shards=0, row_shards=3), 8),
                        (ExecPlan(row_shards=3), 9)):
        with pytest.raises(ValueError, match="1 x 3 shards"):
            resolve_seed_shards(plan, seeds, device_count=2)
    with pytest.raises(ValueError, match="4 x 2 shards"):
        resolve_seed_shards(ExecPlan(row_shards=2), 8, device_count=4)


def test_shard_seeds_matches_plain(mc):
    """`shard_seeds=True` takes every visible device (four list entries),
    places the seeds and reproduces the plain path bit for bit; on one
    CPU device it places nothing; seeds that do not divide raise."""
    args = (mc, [_ch()], "gbma", [0.01], STEPS, SEEDS)
    plain = run_mc(*args, shard_seeds=False, device="cpu")
    sharded = run_mc(*args, shard_seeds=True, device=CPU4)
    assert sharded.plan.n_shards == 4
    np.testing.assert_array_equal(plain.risks, sharded.risks)
    np.testing.assert_array_equal(plain.cum_energy, sharded.cum_energy)
    assert run_mc(*args, shard_seeds=True, device="cpu").plan.n_shards == 0
    with pytest.raises(ValueError, match="divisible"):
        run_mc(mc, [_ch()], "gbma", [0.01], STEPS, 6, shard_seeds=True,
               device=CPU4)


def test_the_cost_model_prices_a_placed_plan_as_the_reference():
    """`_live_bytes` and `predict_run_us` divide by the mesh; both equal
    the reference's for the same model at four devices."""
    model = analytic_cost_model()
    jmodel = JCostModel(coeffs=model.coeffs, dispatch_us=model.dispatch_us,
                        compile_s=model.compile_s,
                        chunk_profile=model.chunk_profile,
                        peaks=model.peaks)
    wl = Workload(n_rows=2, seeds=64, steps=100, n_max=512, dim=16,
                  algo_set=("gbma",))
    jwl = JWorkload(n_rows=2, seeds=64, steps=100, n_max=512, dim=16,
                    algo_set=("gbma",))
    unplaced = ExecPlan(seed_chunk=16, n_shards=0, keep_seed_curves=False)
    for plan in (unplaced, ExecPlan(seed_chunk=16, n_shards=2, row_shards=2,
                                    keep_seed_curves=False),
                 ExecPlan(n_shards=4, keep_seed_curves=False)):
        jp = jplan.ExecPlan(**{k: v for k, v in plan.asdict().items()
                               if k != "retry"})
        assert model.predict_run_us(plan, wl, 4) == pytest.approx(
            jmodel.predict_run_us(jp, jwl, 4), rel=1e-12)
        assert model._live_bytes(plan, wl, 4) == jmodel._live_bytes(jp, jwl,
                                                                    4)
    placed = ExecPlan(seed_chunk=16, n_shards=2, row_shards=2,
                      keep_seed_curves=False)
    assert model._live_bytes(placed, wl, 4) * 4 >= model._live_bytes(
        unplaced, wl, 4)
    with pytest.raises(ValueError, match="device"):
        model.predict_run_us(placed, wl, 1)
    assert isinstance(model, CostModel)


# --------------------------------------------------------------------------
# resume
# --------------------------------------------------------------------------
def _chunked(mesh_k):
    return ExecPlan(seed_chunk=4, n_shards=mesh_k, keep_seed_curves=False)


def test_placed_resume_is_bit_identical_under_its_own_mesh(mc, tmp_path,
                                                           monkeypatch):
    args = (mc, [_ch()], "gbma", [0.01], STEPS, 16)
    clean = run_mc(*args, plan=_chunked(4), device=CPU4)
    real_save, calls = ckpt.save, {"n": 0}

    def dying_save(path, tree):
        real_save(path, tree)
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("simulated preemption")

    monkeypatch.setattr(ckpt, "save", dying_save)
    with pytest.raises(RuntimeError, match="preemption"):
        run_mc(*args, plan=_chunked(4), device=CPU4,
               resume_dir=str(tmp_path))
    monkeypatch.setattr(ckpt, "save", real_save)
    resumed = run_mc(*args, plan=_chunked(4), device=CPU4,
                     resume_dir=str(tmp_path))
    np.testing.assert_array_equal(resumed.mean, clean.mean)
    np.testing.assert_array_equal(resumed.ci95, clean.ci95)


def test_resume_under_another_mesh_starts_over(mc, tmp_path, monkeypatch):
    """The mesh is part of the workload's fingerprint, as in the
    reference: a checkpoint of the 4-shard sweep is refused under 2
    shards (the reference's fingerprint error, nothing resumed), and the
    2-shard sweep starts over from its first chunk."""
    args = (mc, [_ch()], "gbma", [0.01], STEPS, 16)
    run_mc(*args, plan=_chunked(4), device=CPU4, resume_dir=str(tmp_path))
    saved = ckpt.peek(str(tmp_path / exec_mod._RESUME_FILE))
    assert int(saved["next_off"]) == 16  # a finished 4-shard sweep
    with pytest.raises(ValueError, match="fingerprint"):
        run_mc(*args, plan=_chunked(2), device=CPU4,
               resume_dir=str(tmp_path))
    offs = []
    real = exec_mod._mc_moments_merge

    def counting(acc_mean, acc_m2, n_prev, *a, **k):
        offs.append(int(n_prev))
        return real(acc_mean, acc_m2, n_prev, *a, **k)

    monkeypatch.setattr(exec_mod, "_mc_moments_merge", counting)
    fresh = tmp_path / "two"
    two = run_mc(*args, plan=_chunked(2), device=CPU4,
                 resume_dir=str(fresh))
    assert offs == [0, 4, 8, 12]  # every chunk, from the first
    four = run_mc(*args, plan=_chunked(4), device=CPU4)
    np.testing.assert_allclose(two.mean, four.mean, rtol=1e-6)
    np.testing.assert_allclose(two.ci95, four.ci95, rtol=1e-5, atol=1e-9)
