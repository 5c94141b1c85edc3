"""Sharding rules: a tensor's role -> the mesh axes each of its dimensions
is split over (port of `repro.sharding.specs`).

A spec is a tuple with one entry a dimension: `None` (whole), an axis
name, or a tuple of two or more axis names (the dimension split over
their product, the first axis major), as the reference's
`PartitionSpec` holds them.
The production mesh is ("pod", "data", "model") or ("data", "model").
Parameters are tensor-parallel over "model" (heads, ffn, vocab) and,
with `fsdp`, split over the batch axes on the reduction dimension of
big matrices; activations split the batch over ("pod", "data").
`fit_spec` drops an axis from a dimension it does not divide, so such a
tensor stays whole on that dimension (heads that do not divide the
model axis are replicated, as in the reference).

The current mesh and the pure data-parallel switch are thread-local, as
the reference's: `use_mesh(mesh)` around `build_train_step` builds the
mesh step (`training.train_step`), and around `Model.prefill`,
`Model.decode_step` or `Engine.generate` serves on the mesh. A mesh is
any object with `.axis_names` and `.shape[axis]` (`launch.mesh.Mesh`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence

_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def dp_over_model() -> bool:
    """Whether `use_dp_over_model` is on."""
    return getattr(_state, "dp_over_model", False)


@contextlib.contextmanager
def use_dp_over_model(enabled: bool = True):
    """Pure data parallelism: no tensor parallelism, the batch (and FSDP)
    over every axis, "model" included."""
    prev = dp_over_model()
    _state.dp_over_model = enabled
    try:
        yield
    finally:
        _state.dp_over_model = prev


def data_axes(mesh=None) -> tuple:
    """The batch axes: ("pod", "data") where the mesh has them, and
    "model" too under `use_dp_over_model`."""
    mesh = mesh or current_mesh()
    if dp_over_model():
        if mesh is None:
            return ("data", "model")
        return tuple(a for a in ("pod", "data", "model")
                     if a in mesh.axis_names)
    if mesh is None:
        return ("data",)
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def tp_axis() -> Optional[str]:
    """The tensor-parallel axis ("model"), or None under pure DP."""
    return None if dp_over_model() else "model"


def axis_size(axis, mesh=None) -> int:
    """An axis's size, or a tuple of axes' product (1 without a mesh or
    for an axis the mesh lacks)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape.get(a, 1)
        return n
    return mesh.shape.get(axis, 1)


def fit_spec(shape: Sequence[int], spec: Sequence, mesh=None) -> tuple:
    """`spec` padded to `shape`'s length, each axis the mesh lacks or its
    dimension does not divide by dropped."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    names = set(mesh.axis_names)
    spec = tuple(spec)
    out = []
    for dim, axis in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if axis is not None and isinstance(axis, (tuple, list)):
            axis = tuple(a for a in axis if a in names) or None
            if axis is not None and len(axis) == 1:
                axis = axis[0]  # one axis is its name, as PartitionSpec
        elif axis is not None and axis not in names:
            axis = None
        if axis is None or dim % axis_size(axis, mesh):
            out.append(None)
        else:
            out.append(axis)
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter partition rules, by leaf path substring
# ---------------------------------------------------------------------------
def param_spec(path: str, shape: Sequence[int], fsdp: bool,
               mesh=None) -> tuple:
    """The spec of a parameter leaf, by its tree path (trailing dims;
    leading layer-stack dims whole):

      embed / lm_head : vocab -> "model"
      wq / wk / wv    : (.., D, H*hd) -> D: fsdp, H*hd: "model"
      wo              : (.., H*hd, D) -> H*hd: "model", D: fsdp
      wi / wg, wo     : (.., D, F), (.., F, D) likewise
      experts         : (.., E, D, F) -> E: "model", D: fsdp, F whole
      router / norms / biases / scalars: replicated
    """
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    dp = dp_over_model()
    tp = None if dp else "model"
    # FSDP spans every batch axis ('pod' included)
    f = (("pod", "data", "model") if dp else ("pod", "data")) if fsdp \
        else None
    nd = len(shape)

    def tail(*tspec):
        return (None,) * (nd - len(tspec)) + tspec

    if "embed" in path and nd >= 2:
        return fit_spec(shape, tail(tp if tp else f, None), mesh)
    if "lm_head" in path or "head_out" in path:
        return fit_spec(shape, tail(None, tp if tp else f), mesh)
    if any(s in path for s in ("router", "norm", "ln", "bias", "scale",
                               "meta", "bonus", "decay", "mix", "a_log",
                               "d_skip", "dt", "pos_embed")):
        return (None,) * nd
    if "experts" in path and nd >= 3:
        return fit_spec(shape, tail(tp, f, None), mesh)
    if "kv_b" in path and nd >= 3:
        return fit_spec(shape, tail(tp, f, None), mesh)
    if any(s in path for s in ("wq", "wk", "wv", "wi", "wg", "in_proj",
                               "w_up", "q_a", "q_b", "kv_a")):
        return fit_spec(shape, tail(f, tp), mesh)
    if any(s in path for s in ("wo", "out_proj", "w_down")):
        return fit_spec(shape, tail(tp, f), mesh)
    if nd >= 2:
        return fit_spec(shape, tail(f, tp), mesh)
    return (None,) * nd


def cache_spec(path: str, shape: Sequence[int], mesh=None) -> tuple:
    """The spec of a KV or state cache leaf (leading dim the layer
    stack): k / v (L, B, H, S, hd) batch over the data axes and heads over
    "model" where they divide (else head_dim over "model"; an int8
    cache's (.., 1) scales then stay whole on it); MLA's latent caches
    the rank over "model"; other states the batch; pos_ids whole.
    `sharding.placement.shard_cache` places a cache by it."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    da = data_axes(mesh)
    nd = len(shape)
    if "pos_ids" in path:
        return (None,) * nd
    msize = axis_size("model", mesh)
    if nd >= 5 and any(s in path for s in ("/k", "/v", "xk", "xv", "wkv")):
        spec = [None] * nd
        spec[-4] = da
        if shape[-3] % msize == 0:
            spec[-3] = "model"
        else:
            spec[-1] = "model"
        return fit_spec(shape, spec, mesh)
    if nd >= 4 and ("/c" in path or "k_rope" in path):
        return fit_spec(shape, (None, da, None, "model"), mesh)
    spec = [None] * nd
    spec[1 if nd >= 3 else 0] = da
    return fit_spec(shape, spec, mesh)


def cache_specs(tree: Any, mesh=None) -> dict:
    """{path: spec} of every cache leaf of `tree`, by `cache_spec` over the
    reference's path of the leaf ("/" and the keys joined, lowercased:
    `/seg{i}/sub{j}/kv/{k,v,k_scale,v_scale,pos_ids}`), the counterpart
    of the reference's `cache_shardings`."""
    return {path: cache_spec("/" + path, tuple(leaf.shape), mesh)
            for path, leaf in leaf_paths(tree)}


def batch_spec(shape: Sequence[int], mesh=None) -> tuple:
    """An input's spec: the leading (batch) dim over the data axes, a
    scalar whole (the reference's `batch_shardings`, one leaf). A batch
    the data axes do not divide (B = 1 over 2 data ranks) is replicated,
    by `fit_spec`'s fallback, as the reference's is."""
    mesh = mesh or current_mesh()
    if not len(shape):
        return ()
    return fit_spec(shape, (data_axes(mesh),) + (None,) * (len(shape) - 1),
                    mesh)


def leaf_paths(tree: Any, prefix: str = "") -> list:
    """(path, leaf) of every leaf of a tree of dicts in JAX's order (sorted
    keys), the path its keys joined by "/" and lowercased, as the
    reference names a leaf for `param_spec`; `None` leaves are skipped."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaf_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    if tree is None:
        return []
    return [(prefix.lower(), tree)]


def params_specs(tree: Any, fsdp: bool, mesh=None) -> dict:
    """{path: spec} of every parameter leaf of `tree` (tensors or meta
    tensors; the port keeps the reference's paths)."""
    return {path: param_spec(path, tuple(leaf.shape), fsdp, mesh)
            for path, leaf in leaf_paths(tree)}
