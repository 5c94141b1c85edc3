"""The port's sharding rules (`repro_torch.sharding.specs`) against the
reference's (`repro.sharding.specs`), on the CPU.

For every registered config, every mesh of `MESHES` (the production
(16, 16) and (2, 16, 16) meshes and the small meshes the mesh step runs
on), `fsdp` on and off and `use_dp_over_model` on and off: the spec of
every parameter leaf (`param_spec` over `Model.params_shape()`, whose
paths and shapes the port keeps), of every cache leaf (`cache_spec`
over the decode_32k cache) and of the train batch (`batch_spec`) equals
the reference's. The reference's meshes are device-free
`jax.sharding.AbstractMesh`es; the port's a `launch.mesh.Mesh` over CPU
entries (the rules read only the axes and their sizes).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.model import SHAPES  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

ARCHS = (*ARCH_IDS, "repro-100m")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}


def _paths(tree) -> list:
    """(path, shape) of every leaf of a reference tree, named as the
    reference names them for its rules."""
    out = []
    jax.tree_util.tree_map_with_path(
        lambda path, leaf: out.append((
            "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path).lower(), tuple(leaf.shape))), tree)
    return out


@functools.lru_cache(maxsize=None)
def _leaves(arch: str) -> tuple:
    """(param leaves, cache leaves, train batch shapes) of the reference's
    model, and the port's param and cache leaves, as (path, shape)."""
    model = jax_build_model(jax_get_config(arch))
    dec = SHAPES["decode_32k"]
    clen = model.cache_len_for(dec)
    cache = jax.eval_shape(lambda: model.init_cache(dec.global_batch, clen))
    batch = model.input_specs(SHAPES["train_4k"])
    port = build_model(get_config(arch))
    p_cache = port.init_cache(dec.global_batch, clen, device="meta")
    return (_paths(model.params_shape()), _paths(cache),
            {k: tuple(v.shape) for k, v in batch.items()},
            [(p, tuple(x.shape)) for p, x in
             specs.leaf_paths(port.params_shape())],
            [(p, tuple(x.shape)) for p, x in specs.leaf_paths(p_cache)])


@pytest.mark.parametrize("dp", [False, True], ids=["tp", "dp_over_model"])
@pytest.mark.parametrize("fsdp", [False, True], ids=["nofsdp", "fsdp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, mesh_name, fsdp, dp):
    shape, axes = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, axes)
    n = 1
    for s in shape:
        n *= s
    mesh = Mesh(shape, axes, [torch.device("cpu")] * n)
    params, cache, batch, p_params, p_cache = _leaves(arch)
    assert [p for p, _ in p_params] == [p for p, _ in params]
    assert [s for _, s in p_params] == [s for _, s in params]
    assert p_cache == cache
    with jspecs.use_dp_over_model(dp), specs.use_dp_over_model(dp):
        for path, leaf_shape in params:
            ref = jspecs.param_spec(path, leaf_shape, fsdp, jmesh)
            got = specs.param_spec(path, leaf_shape, fsdp, mesh)
            assert got == tuple(ref), (path, got, ref)
        ported = specs.params_specs(build_params_shape(arch), fsdp, mesh)
        assert list(ported.values()) == [
            tuple(jspecs.param_spec(p, s, fsdp, jmesh)) for p, s in params]
        for path, leaf_shape in cache:
            ref = jspecs.cache_spec("/" + path, leaf_shape, jmesh)
            got = specs.cache_spec("/" + path, leaf_shape, mesh)
            assert got == tuple(ref), (path, got, ref)
        ref_batch = jspecs.batch_shardings(
            {k: jax.ShapeDtypeStruct(s, "int32") for k, s in batch.items()},
            jmesh)
        for k, s in batch.items():
            assert specs.batch_spec(s, mesh) == tuple(ref_batch[k].spec), k
    print(f"{arch} {mesh_name} fsdp={fsdp} dp_over_model={dp}: "
          f"{len(params)} parameter, {len(cache)} cache and {len(batch)} "
          "batch leaves equal")


@functools.lru_cache(maxsize=None)
def build_params_shape(arch: str):
    return build_model(get_config(arch)).params_shape()


def test_rules_without_a_mesh_are_empty():
    assert specs.current_mesh() is None
    assert specs.param_spec("embed", (8, 4), True) == ()
    assert specs.batch_spec((8, 4)) == ()
    assert specs.data_axes() == ("data",)
    assert specs.axis_size("model") == 1
    mesh = Mesh((2, 2), ("data", "model"), [torch.device("cpu")] * 4)
    with specs.use_mesh(mesh):
        assert specs.current_mesh() is mesh
        assert specs.param_spec("segments/seg0/sub0/attn/wq", (2, 8, 4),
                                True) == (None, "data", "model")
        with specs.use_dp_over_model():
            assert specs.tp_axis() is None
            assert specs.data_axes() == ("data", "model")
    assert specs.current_mesh() is None
