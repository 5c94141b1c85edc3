"""The fused training step over a ("data", "model") or ("pod", "data",
"model") mesh (ROADMAP M12a), on the CPU.

The reference builds its mesh step with `build_train_step` under
`use_mesh(mesh)` and jits it with `params_shardings` in and out
(`launch/dryrun.py:38-74`); GSPMD partitions the one program. The port
runs one local tensor per mesh entry from one process, and a device
list that names the CPU four times is its counterpart of four forced
host devices.

* Layout: `unshard(shard_params(p))` equals `p` bit for bit, every
  local shard equals its block and replicas are equal, at every mesh,
  `fsdp` and `use_dp_over_model` case.
* Noise: `add_tree_noise` over a sharded tree gives each shard the
  slice of the one-device draw, bit for bit (f32 and JAX's bf16 draw).
* The step: reduced olmo-1b in f32, gbma over pod × data nodes, momentum,
  2 steps; the params within 1e-6 + 1e-5·|p| (`test_torch_train.py`'s
  PARAM_BAR) of the unmeshed port step and of the reference's sharded
  step (one subprocess under `XLA_FLAGS=--xla_force_host_platform_
  device_count=4`, `JAX_PLATFORMS=cpu` and `jax.threefry_partitionable
  (False)` runs every case), the losses within 1e-5 relative, every
  shard its block of `unshard`, at (2, 2), (4, 1), (1, 4), (2, 1, 2),
  `use_dp_over_model`, 3 heads over a 2-way model axis (replicated
  heads, or under `opt_pad_heads` padded to 4, 2 a rank, the losses
  within 1e-5 of the unpadded mesh step's) and 2 kv heads over a 4-way
  one (each rank's kv columns gathered). Two runs give the same bits. The collectives' gradients
  equal the global functions'.
* What the mesh path does not take raises: the transport route,
  microbatches and the non-dense families (ROADMAP M12c), and `n_nodes`
  other than the batch ranks.
"""
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import rng, transport  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.gbma import GBMAConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_host_mesh,  # noqa: E402
                                     make_mesh, make_production_mesh)
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.gd import global_norm, momentum  # noqa: E402
from repro_torch.sharding import comm  # noqa: E402
from repro_torch.sharding.placement import (Sharded,  # noqa: E402
                                            shard_params, shard_tensor,
                                            unshard)
from repro_torch.sharding.specs import (use_dp_over_model,  # noqa: E402
                                        use_mesh)
from repro_torch.training.train_step import (TrainConfig,  # noqa: E402
                                             build_train_step)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU4 = ["cpu"] * 4
STEPS, BATCH, SEQ, LR, NOISE, SEED = 2, 8, 16, 0.05, 0.05, 7
PARAM_BAR = (1e-6, 1e-5)  # atol + rtol * |p|
LOSS_RTOL = 1e-5

# name -> (mesh shape, fsdp, use_dp_over_model, config overrides)
CASES = {
    "2x2": ((2, 2), False, False, {}),
    "4x1_fsdp": ((4, 1), True, False, {}),
    "1x4": ((1, 4), False, False, {}),
    "2x1x2_fsdp": ((2, 1, 2), True, False, {}),
    "2x2_dp_fsdp": ((2, 2), True, True, {}),
    "2x2_3heads_fsdp": ((2, 2), True, False,
                        {"n_heads": 3, "n_kv_heads": 3}),
    "2x2_3heads_pad_fsdp": ((2, 2), True, False,
                            {"n_heads": 3, "n_kv_heads": 3,
                             "opt_pad_heads": True}),
    "1x4_2kv_fsdp": ((1, 4), True, False, {"n_kv_heads": 2}),
}
# the cases the reference's subprocess runs (the GQA and padded cases are
# held to the unmeshed step only: each case costs the subprocess a compile)
REFERENCE_CASES = [n for n in CASES
                   if n not in ("1x4_2kv_fsdp", "2x2_3heads_pad_fsdp")]

_REFERENCE = """
import sys
from concurrent.futures import ThreadPoolExecutor
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs.registry import get_config
from repro.core.channel import ChannelConfig
from repro.core.gbma import GBMAConfig
from repro.models.model import build_model
from repro.optim.gd import momentum
from repro.sharding.specs import (batch_shardings, params_shardings,
                                  use_dp_over_model, use_mesh)
from repro.training.train_step import TrainConfig, build_train_step

assert jax.device_count() == 4, jax.devices()
CASES = {cases!r}
tokens = np.load(sys.argv[1])["tokens"]


def run(name, params, state, batches, lowered):
    fn = lowered.compile()
    losses = []
    for i, b in enumerate(batches):
        params, state, met = fn(params, state, b, jnp.int32(i))
        losses.append(float(met["loss"]))
    out = {{name + "/losses": np.asarray(losses, np.float32)}}
    for j, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        out[f"{{name}}/{{j}}"] = np.asarray(leaf, np.float32)
    return out


# each case compiles and runs in a thread while the next one traces (XLA
# releases the GIL)
pool = ThreadPoolExecutor(len(CASES))
parts = []
with jax.threefry_partitionable(False):
    for name, (shape, fsdp, dp, over) in CASES.items():
        cfg = get_config("olmo-1b").reduced().with_(fsdp=fsdp, **over)
        axes = ("pod", "data", "model") if len(shape) == 3 \\
            else ("data", "model")
        mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
                                 axes)
        nodes = 1
        for a in ("pod", "data"):
            nodes *= mesh.shape.get(a, 1)
        model = build_model(cfg)
        params = model.init_params(jax.random.key(0))
        ch = ChannelConfig(fading="rayleigh", noise_std={noise},
                           energy=1.0, phase_error_max=0.3)
        tcfg = TrainConfig(aggregator="gbma",
                           gbma=GBMAConfig(n_nodes=nodes, channel=ch))
        opt = momentum({lr})
        batches = [{{"tokens": jnp.asarray(t)}} for t in tokens]
        with use_mesh(mesh), use_dp_over_model(dp):
            p_sh = params_shardings(params, fsdp, mesh)
            b_sh = batch_shardings(batches[0], mesh)
            step = jax.jit(build_train_step(model, tcfg, opt),
                           in_shardings=(p_sh, p_sh, b_sh, None),
                           out_shardings=(p_sh, p_sh, None))
            state = opt.init(params)
            lowered = step.lower(params, state, batches[0], jnp.int32(0))
        parts.append(pool.submit(run, name, params, state, batches, lowered))
np.savez(sys.argv[2], **{{k: v for part in parts
                         for k, v in part.result().items()}})
print("ok")
"""


def _tokens() -> np.ndarray:
    rs = np.random.default_rng(SEED)
    return rs.integers(0, 512, (STEPS, BATCH, SEQ + 1)).astype(np.int32)


class _Pending:
    """The reference's subprocess, started at the module's first test so
    that it runs beside the port-only tests; `result()` waits for it."""

    def __init__(self, tmp: pathlib.Path):
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH"))
            if p)
        self.out = tmp / "reference.npz"
        np.savez(tmp / "tokens.npz", tokens=_tokens())
        script = _REFERENCE.format(
            cases={n: CASES[n] for n in REFERENCE_CASES}, noise=NOISE, lr=LR)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script, str(tmp / "tokens.npz"),
             str(self.out)], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._data = None

    def result(self) -> dict:
        if self._data is None:
            stdout, stderr = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, stderr[-4000:]
            self._data = dict(np.load(self.out))
        return self._data


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pending = _Pending(tmp_path_factory.mktemp("mesh_reference"))
    yield pending
    if pending.proc.poll() is None:
        pending.proc.kill()
        pending.proc.communicate()


@pytest.fixture(autouse=True, scope="module")
def _start_reference(reference):
    """Starts the reference's run before the first test, and runs the
    port with one torch thread (its ops are small; the subprocess takes
    the other cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(name: str):
    shape, fsdp, dp, over = CASES[name]
    return (get_config("olmo-1b").reduced().with_(fsdp=fsdp, **over),
            jax_get_config("olmo-1b").reduced().with_(fsdp=fsdp, **over))


def _mesh(shape) -> Mesh:
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return make_mesh(shape, axes, CPU4)


_INIT: dict = {}


def _init(name: str) -> dict:
    """The reference's initial parameters of case `name`'s config, as the
    port's tree (cached per config)."""
    _, jcfg = _cfg(name)
    key = repr(CASES[name][3])
    if key not in _INIT:
        with jax_original_layout():
            init = jax_build_model(jcfg).init_params(jax.random.key(0))
            _INIT[key] = jax.tree.map(np.asarray, init)
    return params_from_reference(_INIT[key])


def _tcfg(nodes: int) -> TrainConfig:
    ch = ChannelConfig(fading="rayleigh", noise_std=NOISE, energy=1.0,
                       phase_error_max=0.3)
    return TrainConfig(aggregator="gbma",
                       gbma=GBMAConfig(n_nodes=nodes, channel=ch))


def _nodes(mesh) -> int:
    return mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)


def _batches() -> list:
    return [{"tokens": torch.from_numpy(t)} for t in _tokens()]


def _mesh_run(name: str) -> tuple:
    """(losses, final sharded params, mesh) of the port's mesh step."""
    shape, fsdp, dp, _ = CASES[name]
    cfg, _ = _cfg(name)
    mesh = _mesh(shape)
    model = build_model(cfg)
    with use_mesh(mesh), use_dp_over_model(dp):
        step = build_train_step(model, _tcfg(_nodes(mesh)), momentum(LR))
        params = shard_params(_init(name), cfg.fsdp, mesh)
    state = step.init_state(params)
    losses = []
    for i, b in enumerate(_batches()):
        params, state, met = step(params, state, b, i)
        losses.append(float(met["loss"]))
    return np.asarray(losses, np.float32), params, mesh


def _unmeshed_run(name: str) -> tuple:
    cfg, _ = _cfg(name)
    step = build_train_step(build_model(cfg),
                            _tcfg(_nodes(_mesh(CASES[name][0]))),
                            momentum(LR))
    params = _init(name)
    state = step.init_state(params)
    losses = []
    for i, b in enumerate(_batches()):
        params, state, met = step(params, state, b, i)
        losses.append(float(met["loss"]))
    return np.asarray(losses, np.float32), params


def _hold_shards(tree) -> None:
    """Every shard equals its block of `unshard(tree)`, bit for bit
    (replicas included)."""
    whole = unshard(tree)
    for leaf, full in zip(tree_leaves(tree), tree_leaves(whole)):
        assert isinstance(leaf, Sharded)
        for i, s in enumerate(leaf.shards):
            assert s.device == leaf.mesh.devices[i]
            assert torch.equal(s, full[leaf.box(i)])


def _margin(leaves, ref_leaves) -> float:
    return max(float(np.max(np.abs(a - b) / (PARAM_BAR[0]
                                             + PARAM_BAR[1] * np.abs(b))))
               for a, b in zip(leaves, ref_leaves))


# --------------------------------------------------------------------------
# meshes and layouts
# --------------------------------------------------------------------------
def test_meshes():
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), CPU4)
    assert mesh.shape == {"pod": 2, "data": 1, "model": 2}
    assert mesh.size == 4 and mesh.axis_names == ("pod", "data", "model")
    assert [mesh.coords(i) for i in (0, 1, 3)] == [
        {"pod": 0, "data": 0, "model": 0}, {"pod": 0, "data": 0, "model": 1},
        {"pod": 1, "data": 0, "model": 1}]
    host = make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices == [torch.device("cpu")]
    assert make_production_mesh(devices=["cpu"] * 256).shape == {
        "data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True, devices=["cpu"] * 512) \
        .shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="mesh needs 256 devices but "
                       "only 4 present"):
        make_production_mesh(devices=CPU4)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), ["cpu", "cpu"])


@pytest.mark.parametrize("name", list(CASES))
def test_shard_params_round_trip(name):
    shape, fsdp, dp, _ = CASES[name]
    mesh = _mesh(shape)
    params = _init(name)
    with use_dp_over_model(dp):
        sharded = shard_params(params, fsdp, mesh)
    split = sum(any(e is not None for e in leaf.spec)
                for leaf in tree_leaves(sharded))
    assert split >= 5, "most leaves are split"
    for a, b in zip(tree_leaves(unshard(sharded)), tree_leaves(params)):
        assert torch.equal(a, b)
    _hold_shards(sharded)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["2x2", "4x1_fsdp", "2x1x2_fsdp",
                                  "2x2_dp_fsdp"])
def test_noise_is_the_slice_of_the_one_device_draw(name, dtype):
    shape, fsdp, dp, _ = CASES[name]
    mesh = _mesh(shape)
    grads = tree_map(torch.zeros_like, _init(name))
    with use_dp_over_model(dp):
        sharded = shard_params(grads, fsdp, mesh)
    key = rng.key(11)
    whole = transport.add_tree_noise(grads, key, 0.3, noise_dtype=dtype)
    placed = transport.add_tree_noise(sharded, key, 0.3, noise_dtype=dtype)
    for leaf, full in zip(tree_leaves(placed), tree_leaves(whole)):
        assert full.abs().sum() > 0
        for i, s in enumerate(leaf.shards):
            assert torch.equal(s, full[leaf.box(i)])


def test_global_norm_counts_each_block_once():
    mesh = _mesh((2, 2))
    grads = _init("2x2")
    sharded = shard_params(grads, False, mesh)
    a, b = global_norm(sharded), global_norm(grads)
    assert torch.allclose(a, b, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------
def test_collectives_gradients_equal_the_global_functions():
    """all_gather (reduce-scatter backward), all_reduce with copy_to (the
    tensor-parallel pair) and the vocabulary-split cross-entropy give the
    values and gradients of the functions they split."""
    mesh = _mesh((2, 2))
    g = torch.Generator().manual_seed(0)
    w = torch.randn(6, 8, generator=g, dtype=torch.float64)
    x = torch.randn(4, 6, generator=g, dtype=torch.float64)
    # FSDP over 'data' on dim 0, each data rank its own input rows
    ws = shard_tensor(w, ("data", None), mesh)
    leaves = [s.requires_grad_(True) for s in ws.shards]
    full = comm.all_gather(leaves, mesh, ("data",), 0, True)
    rows = [x[:2], x[:2], x[2:], x[2:]]
    outs = [(r @ f).square().sum() for r, f in zip(rows, full)]
    # the model ranks replicate each data rank's loss: count one of them
    torch.autograd.backward([outs[0], outs[2]])
    w_ = w.clone().requires_grad_(True)
    (x @ w_).square().sum().backward()
    for i, s in enumerate(leaves):
        if i in (0, 2):
            assert torch.allclose(s.grad, w_.grad[ws.box(i)], rtol=1e-12)
    # column- then row-parallel over 'model', replicated input
    a = torch.randn(6, 8, generator=g, dtype=torch.float64)
    b = torch.randn(8, 5, generator=g, dtype=torch.float64)
    a_s, b_s = shard_tensor(a, (None, "model"), mesh), \
        shard_tensor(b, ("model", None), mesh)
    xs = [x.clone().requires_grad_(True) for _ in range(4)]
    la = [s.requires_grad_(True) for s in a_s.shards]
    lb = [s.requires_grad_(True) for s in b_s.shards]
    h = comm.copy_to(xs, mesh, ("model",))
    y = comm.all_reduce([hi @ ai @ bi for hi, ai, bi in zip(h, la, lb)],
                        mesh, ("model",))
    torch.autograd.backward([yi.sin().sum() for yi in y])
    x_, a_, b_ = (t.clone().requires_grad_(True) for t in (x, a, b))
    ref = x_ @ a_ @ b_
    (2 * ref.sin().sum()).backward()  # two data ranks, same input
    for yi in y:
        assert torch.allclose(yi, ref, rtol=1e-12)
    for i in range(4):
        assert torch.allclose(xs[i].grad, x_.grad / 2, rtol=1e-12)
        assert torch.allclose(la[i].grad, a_.grad[a_s.box(i)] / 2,
                              rtol=1e-12)
        assert torch.allclose(lb[i].grad, b_.grad[b_s.box(i)] / 2,
                              rtol=1e-12)
    # the vocabulary-split cross-entropy
    logits = torch.randn(3, 5, 8, generator=g, dtype=torch.float64)
    labels = torch.randint(0, 8, (3, 5), generator=g)
    ls = shard_tensor(logits, (None, None, "model"), mesh)
    loc = [s.requires_grad_(True) for s in ls.shards]
    nll = comm.vocab_parallel_xent(loc, [labels] * 4, mesh, "model")
    torch.autograd.backward([(n * (1 + labels)).sum() for n in nll[:2]])
    lg = logits.clone().requires_grad_(True)
    ref = torch.nn.functional.cross_entropy(
        lg.reshape(-1, 8), labels.reshape(-1), reduction="none") \
        .reshape(3, 5)
    (ref * (1 + labels)).sum().backward()
    for i in range(4):
        assert torch.allclose(nll[i], ref, rtol=1e-12)
    for i in range(2):
        assert torch.allclose(loc[i].grad, lg.grad[ls.box(i)], rtol=1e-10)


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------
_RUNS: dict = {}


def _run(name: str) -> tuple:
    """(mesh losses, the mesh step's params as numpy leaves) of case
    `name`, run once."""
    if name not in _RUNS:
        losses, params, _ = _mesh_run(name)
        _hold_shards(params)
        _RUNS[name] = (losses,
                       [x.numpy() for x in tree_leaves(unshard(params))])
    return _RUNS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_the_unmeshed_step(name):
    losses, leaves = _run(name)
    ref_losses, ref_params = _unmeshed_run(name)
    loss_rel = float(np.max(np.abs(losses - ref_losses)
                            / np.abs(ref_losses)))
    margin = _margin(leaves, [x.numpy() for x in tree_leaves(ref_params)])
    print(f"{name}: vs the unmeshed step losses {loss_rel:.3e} rel, params "
          f"at {margin:.3f} of the bar")
    assert loss_rel <= LOSS_RTOL and margin <= 1.0


def test_padded_heads_step_matches_the_unpadded_mesh_step():
    """`opt_pad_heads` on the 3-head mesh: q / k / v padded to 4 heads,
    each model rank its 2 through the attention, the padded heads dropped
    before `wo`; the same losses (1e-5 relative) and parameters as the
    replicated heads."""
    losses, leaves = _run("2x2_3heads_pad_fsdp")
    ref_losses, ref_leaves = _run("2x2_3heads_fsdp")
    loss_rel = float(np.max(np.abs(losses - ref_losses)
                            / np.abs(ref_losses)))
    margin = _margin(leaves, ref_leaves)
    print(f"padded vs replicated heads: losses {loss_rel:.3e} rel, params "
          f"at {margin:.3f} of the bar")
    assert loss_rel <= LOSS_RTOL and margin <= 1.0


def test_mesh_step_is_repeatable():
    a = _mesh_run("2x1x2_fsdp")
    b = _mesh_run("2x1x2_fsdp")
    assert np.array_equal(a[0], b[0])
    for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])):
        for s, t in zip(x.shards, y.shards):
            assert torch.equal(s, t)


def test_what_the_mesh_path_does_not_take_raises():
    mesh = _mesh((2, 2))
    model = build_model(get_config("olmo-1b").reduced())
    with use_mesh(mesh):
        for tcfg in (
                TrainConfig(aggregator="momentum", gbma=GBMAConfig(2)),
                TrainConfig(aggregator="gbma", gbma=GBMAConfig(2),
                            route="transport"),
                TrainConfig(aggregator="gbma", gbma=GBMAConfig(2),
                            microbatches=2)):
            with pytest.raises(NotImplementedError, match="M12c"):
                build_train_step(model, tcfg, momentum(LR))
        with pytest.raises(NotImplementedError, match="M12c"):
            build_train_step(build_model(get_config("rwkv6-7b").reduced()),
                             _tcfg(2), momentum(LR))
        with pytest.raises(ValueError, match="n_nodes must be 2"):
            build_train_step(model, _tcfg(4), momentum(LR))


# last in the file: the port's runs above overlap the reference's
@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_mesh_step_matches_the_reference_sharded_step(name, reference):
    losses, leaves = _run(name)
    data = reference.result()
    jax_losses = data[f"{name}/losses"]
    jax_leaves = [data[f"{name}/{j}"] for j in range(len(leaves))]
    assert len(jax_leaves) == len(leaves)
    loss_rel = float(np.max(np.abs(losses - jax_losses)
                            / np.abs(jax_losses)))
    margin = _margin(leaves, jax_leaves)
    print(f"{name}: vs the reference's sharded step losses {loss_rel:.3e} "
          f"rel, params at {margin:.3f} of the bar")
    assert loss_rel <= LOSS_RTOL and margin <= 1.0
