"""Serving the dense decoder over a ("data", "model") or ("pod", "data",
"model") mesh (ROADMAP M12b), on the CPU.

The reference serves on a mesh by jitting `Model.prefill` and
`Model.decode_step` under `use_mesh(mesh)` with `params_shardings`,
`cache_shardings` and `batch_shardings` (`launch/dryrun.py:64-85`). The
port runs one local tensor per mesh entry from one process, on a device
list that names the CPU four times, with the reference's parameters
carried across by `repro_torch.models.convert`.

* Layout: `unshard(shard_cache(c))` equals c bit for bit, every cache
  shard is its block and replicas are equal; the spec of every cache
  leaf and of the prompt is the reference's `cache_spec` and
  `batch_shardings`' (B = 1 over two data ranks replicated).
* Against the unmeshed port: prefill logits, the cache and 4 decode
  steps' logits and cache within atol 1e-4 + rtol 1e-4 (the bar of
  `test_torch_serve.py`; measured ~1e-6), `pos_ids` and an int8 cache's
  values exactly, every shard its block after the steps; greedy and
  temperature tokens of `Engine.generate` equal the unmeshed engine's
  bit for bit. Cases: (2, 2), (1, 4), (2, 1, 2), `fsdp`,
  `use_dp_over_model`, B = 1, 3 heads on a 2-way axis with and without
  `opt_pad_heads`, 2 kv heads on a 4-way axis (the cache split on
  head_dim), reduced gemma2-9b past its 16-token window, reduced
  gemma-7b with `opt_int8_cache` or qk-norm on a head_dim-split cache,
  and 5 heads padded over a 4-way axis (one rank all pad).
* Against the reference: its sharded prefill and decode (one subprocess
  under `XLA_FLAGS=--xla_force_host_platform_device_count=4` and
  `JAX_PLATFORMS=cpu`, started at the module's first test) at (2, 2),
  the padded 3-head case, the 2-kv head_dim case and gemma2's window:
  logits at the same bar, and each port entry's cache block equal to the
  reference's addressable shard on the device at the same mesh
  coordinates. The reference's prefill keeps a windowed ring's keys in
  slots 0.. in order; its cache is moved to the ring's layout before it
  decodes (ROADMAP §3 F14). Its `use_dp_over_model` cache spec names
  "model" twice, which its `NamedSharding` refuses (ROADMAP §3 R8): that
  case is held to the unmeshed port only, as is the int8 case, whose
  reference decode on a head_dim-split cache differs from its own
  unmeshed decode by ~1e-3 (R8).
* What the mesh path does not serve raises: MoE, MLA, SSM, RWKV, encdec
  and the VLM (ROADMAP M12c), and a mesh larger than the devices given.
"""
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from test_torch_helpers import jax_original_layout  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.sharding.placement import (Sharded,  # noqa: E402
                                            shard_cache, shard_params,
                                            unshard)
from repro_torch.sharding.specs import (use_dp_over_model,  # noqa: E402
                                        use_mesh)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU4 = ["cpu"] * 4
ATOL = RTOL = 1e-4
STEPS, SEED = 4, 5

# name -> (mesh shape, fsdp, use_dp_over_model, arch, config overrides,
#          batch, prompt length)
CASES = {
    "2x2": ((2, 2), False, False, "olmo-1b", {}, 4, 10),
    "1x4": ((1, 4), False, False, "olmo-1b", {}, 4, 10),
    "2x1x2": ((2, 1, 2), False, False, "olmo-1b", {}, 4, 10),
    "2x2_fsdp": ((2, 2), True, False, "olmo-1b", {}, 4, 10),
    "2x2_dp": ((2, 2), False, True, "olmo-1b", {}, 4, 10),
    "2x2_b1": ((2, 2), False, False, "olmo-1b", {}, 1, 10),
    "2x2_3heads": ((2, 2), False, False, "olmo-1b",
                   {"n_heads": 3, "n_kv_heads": 3}, 4, 10),
    "2x2_3heads_pad": ((2, 2), False, False, "olmo-1b",
                       {"n_heads": 3, "n_kv_heads": 3,
                        "opt_pad_heads": True}, 4, 10),
    "1x4_2kv": ((1, 4), False, False, "olmo-1b", {"n_kv_heads": 2}, 4, 10),
    "2x2_gemma2_window": ((2, 2), False, False, "gemma2-9b", {}, 4, 24),
    "1x4_gemma7b_int8": ((1, 4), False, False, "gemma-7b",
                         {"n_kv_heads": 2, "opt_int8_cache": True}, 4, 10),
    "1x4_gemma7b_qk_norm": ((1, 4), False, False, "gemma-7b",
                            {"n_kv_heads": 2, "qk_norm": True}, 4, 10),
    # 5 heads padded to 8 over 4 ranks: the last rank holds pad only
    "1x4_5heads_pad": ((1, 4), False, False, "olmo-1b",
                       {"n_heads": 5, "n_kv_heads": 5,
                        "opt_pad_heads": True}, 4, 10),
}
REFERENCE_CASES = ["2x2", "2x2_3heads_pad", "1x4_2kv", "2x2_gemma2_window"]

_REFERENCE = """
import functools
import sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs.registry import get_config
from repro.models.model import build_model
from repro.sharding.specs import (batch_shardings, cache_shardings,
                                  params_shardings, use_mesh)

assert jax.device_count() == 4, jax.devices()
CASES = {cases!r}
STEPS = {steps}
data = np.load(sys.argv[1])
out = {{}}


def ring_aligned(cache, s):
    # each kept prefill position p moved to slot p mod cache_len, where
    # decode reads and writes the ring
    def one(path, leaf):
        n = leaf.shape[-1] if path[-1].key == "pos_ids" else leaf.shape[-2]
        shift = (s - min(s, n)) % n
        return jnp.roll(leaf, shift, axis=-1 if path[-1].key == "pos_ids"
                        else -2)
    return jax.tree_util.tree_map_with_path(one, cache)


with jax.threefry_partitionable(False):
    for name, (shape, fsdp, arch, over, s) in CASES.items():
        cfg = get_config(arch).reduced().with_(fsdp=fsdp, **over)
        axes = ("pod", "data", "model") if len(shape) == 3 \\
            else ("data", "model")
        mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
                                 axes)
        model = build_model(cfg)
        params = model.init_params(jax.random.key(0))
        tokens = jnp.asarray(data[name + "/prompt"])
        steps = data[name + "/steps"]
        with use_mesh(mesh):
            p_sh = params_shardings(params, fsdp, mesh)
            b_sh = batch_shardings({{"tokens": tokens}}, mesh)
            pre = jax.jit(functools.partial(model.prefill,
                                            max_len=s + STEPS),
                          in_shardings=(p_sh, b_sh))
            logits, cache = pre(params, {{"tokens": tokens}})
            out[name + "/prefill"] = np.asarray(logits)
            c_sh = cache_shardings(cache, mesh)
            t_sh = batch_shardings({{"token": tokens[:, 0]}}, mesh)["token"]
            cache = jax.device_put(ring_aligned(cache, s), c_sh)
            dec = jax.jit(model.decode_step,
                          in_shardings=(p_sh, c_sh, t_sh, None),
                          out_shardings=(None, c_sh))
            for j, tok in enumerate(steps):
                logits, cache = dec(params, cache, jnp.asarray(tok),
                                    jnp.int32(s + j))
                out[f"{{name}}/decode{{j}}"] = np.asarray(logits)
        devices = list(jax.devices())
        for path, leaf in jax.tree_util.tree_leaves_with_path(cache):
            key = "/".join(str(p.key) for p in path)
            for shard in leaf.addressable_shards:
                i = devices.index(shard.device)
                out[f"{{name}}/cache/{{key}}/{{i}}"] = np.asarray(shard.data)
np.savez(sys.argv[2], **out)
print("ok")
"""


def _inputs(name: str) -> tuple:
    """(prompt (B, S), decode tokens (STEPS, B)) of case `name`, int32."""
    _, _, _, _, _, b, s = CASES[name]
    rs = np.random.default_rng(SEED)
    prompt = rs.integers(0, 512, (b, s)).astype(np.int32)
    return prompt, rs.integers(0, 512, (STEPS, b)).astype(np.int32)


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
        arrays = {}
        for n in REFERENCE_CASES:
            arrays[n + "/prompt"], arrays[n + "/steps"] = _inputs(n)
        np.savez(tmp / "inputs.npz", **arrays)
        cases = {n: (CASES[n][0], CASES[n][1], CASES[n][3], CASES[n][4],
                     CASES[n][6]) for n in REFERENCE_CASES}
        script = _REFERENCE.format(cases=cases, steps=STEPS)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script, str(tmp / "inputs.npz"),
             str(self.out)], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._data = None

    def result(self) -> dict:
        if self._data is None:
            _, stderr = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, stderr[-4000:]
            self._data = dict(np.load(self.out))
        return self._data


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pending = _Pending(tmp_path_factory.mktemp("mesh_serve_reference"))
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


def _mesh(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return make_mesh(shape, axes, CPU4)


_MODELS: dict = {}


def _model(name: str) -> tuple:
    """(the port's model, the reference's initial parameters as the port's
    tree) of case `name`'s config, cached per config."""
    _, fsdp, _, arch, over, _, _ = CASES[name]
    key = (arch, repr(over))
    if key not in _MODELS:
        jcfg = jax_get_config(arch).reduced().with_(**over)
        with jax_original_layout():
            init = jax_build_model(jcfg).init_params(jax.random.key(0))
        _MODELS[key] = params_from_reference(jax.tree.map(np.asarray, init))
    cfg = get_config(arch).reduced().with_(fsdp=fsdp, **over)
    return build_model(cfg), _MODELS[key]


def _hold_shards(tree) -> None:
    """Every shard lies on its entry's device and equals its block of
    `unshard(tree)`, bit for bit (replicas included)."""
    whole = unshard(tree)
    for leaf, full in zip(tree_leaves(tree), tree_leaves(whole)):
        assert isinstance(leaf, Sharded)
        for i, s in enumerate(leaf.shards):
            assert s.device == leaf.mesh.devices[i]
            assert torch.equal(s, full[leaf.box(i)])


def _assert_cache(placed, ref) -> None:
    """A placed cache against an unmeshed one: k / v at the bar (an int8
    cache's values exactly), pos_ids exactly."""
    for a, b in zip(tree_leaves(unshard(placed)), tree_leaves(ref)):
        if a.dtype in (torch.int8, torch.int32):
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL,
                                       rtol=RTOL)


def _serve(name: str, meshed: bool) -> tuple:
    """(prefill logits, each decode step's logits, the final cache) of
    case `name`, on its mesh (with the placed parameters) or unmeshed."""
    shape, fsdp, dp, _, _, _, s = CASES[name]
    model, params = _model(name)
    prompt, steps = _inputs(name)
    mesh = _mesh(shape)
    if meshed:
        with use_dp_over_model(dp):
            params = shard_params(params, fsdp, mesh)
    ctx = (use_mesh(mesh) if meshed else use_mesh(None))
    with ctx, use_dp_over_model(dp and meshed):
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(prompt)}, s + STEPS)
        decoded = []
        for j, tok in enumerate(steps):
            out, cache = model.decode_step(params, cache,
                                           torch.from_numpy(tok), s + j)
            decoded.append(out)
    return logits, decoded, cache


_RUNS: dict = {}


def _mesh_serve(name: str) -> tuple:
    if name not in _RUNS:
        _RUNS[name] = _serve(name, True)
    return _RUNS[name]


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_shard_cache_round_trip_and_specs(name):
    """A prefilled cache placed by `shard_cache` comes back bit for bit,
    each shard its block; every leaf's spec and the prompt's are the
    reference's rules (`cache_spec` and `batch_shardings`)."""
    shape, _, dp, _, _, b, s = CASES[name]
    model, params = _model(name)
    prompt, _ = _inputs(name)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)},
                             s + STEPS)
    mesh = _mesh(shape)
    axes = tuple(mesh.axis_names)
    jmesh = AbstractMesh(shape, axes)
    with use_dp_over_model(dp), jspecs.use_dp_over_model(dp):
        placed = shard_cache(cache, mesh)
        for path, leaf in specs.leaf_paths(cache):
            ref = tuple(jspecs.cache_spec("/" + path, leaf.shape, jmesh))
            assert specs.cache_specs(cache, mesh)[path] == ref, path
        ref_batch = jspecs.batch_shardings(
            {"tokens": jax.ShapeDtypeStruct(prompt.shape, "int32")}, jmesh)
        assert specs.batch_spec(prompt.shape, mesh) \
            == tuple(ref_batch["tokens"].spec)
    if b == 1:
        assert specs.batch_spec((b, s), mesh)[0] is None, "replicated rows"
    for a, c in zip(tree_leaves(unshard(placed)), tree_leaves(cache)):
        assert torch.equal(a, c)
    _hold_shards(placed)
    k = tree_leaves(placed)[0]
    assert any(e is not None for e in k.spec), "the cache is split"


# --------------------------------------------------------------------------
# against the unmeshed port
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_serving_matches_the_unmeshed_port(name):
    logits, decoded, cache = _mesh_serve(name)
    ref_logits, ref_decoded, ref_cache = _serve(name, False)
    assert logits.shape == ref_logits.shape
    errs = [float((logits - ref_logits).abs().max())]
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(),
                               atol=ATOL, rtol=RTOL)
    for a, b in zip(decoded, ref_decoded):
        errs.append(float((a - b).abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL,
                                   rtol=RTOL)
    _assert_cache(cache, ref_cache)
    _hold_shards(cache)
    print(f"{name}: largest logit difference {max(errs):.3e}")


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 3)])
@pytest.mark.parametrize("name", ["2x2", "2x1x2", "2x2_b1", "2x2_3heads_pad",
                                  "1x4_2kv", "2x2_gemma2_window",
                                  "1x4_gemma7b_int8"])
def test_generate_tokens_equal_the_unmeshed_engine(name, temperature, seed):
    shape, fsdp, dp, _, _, _, _ = CASES[name]
    model, params = _model(name)
    prompt = torch.from_numpy(_inputs(name)[0])
    scfg = ServeConfig(max_new_tokens=5, temperature=temperature, seed=seed)
    want = Engine(model, params, scfg).generate({"tokens": prompt})
    mesh = _mesh(shape)
    with use_dp_over_model(dp):
        placed = shard_params(params, fsdp, mesh)
        with use_mesh(mesh):
            got = Engine(model, placed, scfg).generate({"tokens": prompt})
    assert got.device == mesh.devices[0]
    assert torch.equal(got, want), (got, want)


# --------------------------------------------------------------------------
# what raises
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "deepseek-v3-671b", "rwkv6-7b",
                                  "hymba-1.5b", "whisper-small",
                                  "pixtral-12b"])
def test_what_the_mesh_path_does_not_serve_raises(arch):
    model = build_model(get_config(arch).reduced())
    tokens = torch.zeros((4, 6), dtype=torch.int64)
    with use_mesh(_mesh((2, 2))):
        for call in (lambda: model.init_cache(4, 8),
                     lambda: model.prefill({}, {"tokens": tokens}, 8),
                     lambda: model.decode_step({}, {}, tokens[:, 0], 6),
                     lambda: Engine(model, {}, ServeConfig(2)).generate(
                         {"tokens": tokens})):
            with pytest.raises(NotImplementedError, match="M12c"):
                call()


def test_a_mesh_larger_than_its_devices_raises():
    with pytest.raises(RuntimeError, match="mesh needs 256 devices but "
                       "only 4 present"):
        make_production_mesh(devices=CPU4)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), ["cpu", "cpu"])


# --------------------------------------------------------------------------
# against the reference (last in the file: the port's runs above overlap
# the reference's)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_mesh_serving_matches_the_reference_sharded_serving(name, reference):
    logits, decoded, cache = _mesh_serve(name)
    data = reference.result()
    np.testing.assert_allclose(logits.numpy(), data[f"{name}/prefill"],
                               atol=ATOL, rtol=RTOL)
    for j, out in enumerate(decoded):
        np.testing.assert_allclose(out.numpy(), data[f"{name}/decode{j}"],
                                   atol=ATOL, rtol=RTOL)
    n = 0
    for path, leaf in specs.leaf_paths(cache):
        for i, shard in enumerate(leaf.shards):
            ref = data[f"{name}/cache/{path}/{i}"]
            assert shard.shape == ref.shape, (path, i)
            if ref.dtype in (np.int8, np.int32):
                np.testing.assert_array_equal(shard.numpy(), ref)
            else:
                np.testing.assert_allclose(shard.numpy(), ref, atol=ATOL,
                                           rtol=RTOL)
            n += 1
    print(f"{name}: {n} cache shards equal the reference's")
