"""Parameters laid out over a mesh, one local tensor per mesh entry.

`shard_params(params, fsdp, mesh)` turns each leaf into a `Sharded`: its
spec (`specs.param_spec`), its global shape and one tensor per mesh
entry, on that entry's device, holding the block its coordinates select
(`box`). An entry whose coordinate is unused by the spec holds an equal
copy (a replica). `unshard` puts the blocks back together.

A `Sharded` is one leaf of `core.tree`, so the trees keep the
reference's structure and leaf order (the noise keys follow it);
`leafwise` applies an elementwise update to every local tensor, which
is how the optimizers update shards in place of leaves.

Serving places its KV caches the same way (`shard_cache`, `cache_zeros`:
each leaf by `specs.cache_spec`; each entry's block is updated in place
by its own prefill and decode steps) and its inputs' rows by
`specs.batch_spec` (`split_rows`; `gather_rows` puts the rows back).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.sharding import specs


def spec_axes(entry) -> tuple:
    """The axes one spec entry names: () for None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_rank(mesh, axes: Sequence[str], i: int) -> int:
    """Entry i's index over `axes`, row-major (the first axis major)."""
    c = mesh.coords(i)
    r = 0
    for a in axes:
        r = r * mesh.shape[a] + c[a]
    return r


def groups(mesh, axes: Sequence[str]) -> list:
    """The entries that differ only on `axes`, each group ordered by its
    members' index over `axes` (`axes_rank`); groups in mesh order."""
    axes = tuple(axes)
    out: dict = {}
    for i in range(mesh.size):
        c = mesh.coords(i)
        key = tuple(c[a] for a in mesh.axis_names if a not in axes)
        out.setdefault(key, []).append(i)
    return [sorted(g, key=lambda i: axes_rank(mesh, axes, i))
            for g in out.values()]


def leads(mesh, axes: Sequence[str]) -> list:
    """The entries at coordinate 0 on every axis but `axes`: one a block
    of a tensor split over `axes`, by rank over them."""
    out = [i for i in range(mesh.size)
           if all(c == 0 for a, c in mesh.coords(i).items() if a not in axes)]
    return sorted(out, key=lambda i: axes_rank(mesh, axes, i))


def box(shape: Sequence[int], spec: Sequence, mesh, i: int) -> tuple:
    """The slices of a global tensor of `shape` that entry i holds."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = spec_axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        size = n // math.prod(mesh.shape[a] for a in axes)
        r = axes_rank(mesh, axes, i)
        out.append(slice(r * size, (r + 1) * size))
    return tuple(out)


class Sharded:
    """One logical tensor over a mesh: `spec`, global `shape`, and
    `shards[i]` on `mesh.devices[i]` for every entry i."""

    __slots__ = ("spec", "shape", "shards", "mesh")

    def __init__(self, spec: tuple, shape: tuple, shards: list, mesh):
        self.spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        self.shape = tuple(shape)
        self.shards = list(shards)
        self.mesh = mesh

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def with_shards(self, shards: list) -> "Sharded":
        return Sharded(self.spec, self.shape, shards, self.mesh)

    def __getitem__(self, i: int) -> "Sharded":
        """Layer i of a leaf stacked on its (whole) leading dimension:
        views of each shard (so `layers.layer_slice` takes a tree of
        them)."""
        return Sharded(self.spec[1:], self.shape[1:],
                       [s[i] for s in self.shards], self.mesh)

    def box(self, i: int) -> tuple:
        return box(self.shape, self.spec, self.mesh, i)

    def used_axes(self) -> tuple:
        return tuple(a for e in self.spec for a in spec_axes(e))

    def distinct(self) -> list:
        """One entry per distinct block (`leads` over the spec's axes)."""
        return leads(self.mesh, self.used_axes())

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype}, entries={len(self.shards)})")


def shard_tensor(t: torch.Tensor, spec: Sequence, mesh) -> Sharded:
    """`t` laid out by `spec`: each entry's block copied onto its device
    (a tensor of its own, replicas included)."""
    spec = tuple(spec)
    shards = []
    for i, dev in enumerate(mesh.devices):
        block = t[box(t.shape, spec, mesh, i)]
        shards.append(torch.empty(block.shape, dtype=t.dtype,
                                  device=dev).copy_(block))
    return Sharded(spec, tuple(t.shape), shards, mesh)


def shard_params(params: Any, fsdp: bool, mesh) -> Any:
    """The parameter tree with every leaf a `Sharded` laid out by the
    reference's rules (`specs.param_spec` over the leaf's path; call it
    under `specs.use_dp_over_model` for pure DP). `None` leaves stay."""

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in t.items()}
        if t is None:
            return None
        spec = specs.param_spec(path.lower(), tuple(t.shape), fsdp, mesh)
        return shard_tensor(t, spec, mesh)

    return walk(params, "")


def unshard(tree: Any, device: Optional[torch.device] = None) -> Any:
    """Every `Sharded` leaf as its global tensor on `device` (default the
    mesh's first entry's), from one copy of each distinct block."""
    if isinstance(tree, dict):
        return {k: unshard(v, device) for k, v in tree.items()}
    if not isinstance(tree, Sharded):
        return tree
    dev = device if device is not None else tree.mesh.devices[0]
    out = torch.empty(tree.shape, dtype=tree.dtype, device=dev)
    for i in tree.distinct():
        out[tree.box(i)] = tree.shards[i].to(dev)
    return out


def leafwise(fn: Callable, *xs):
    """`fn` over matching leaves; for `Sharded` leaves, over each entry's
    local tensors, giving a `Sharded` of the same layout."""
    if isinstance(xs[0], Sharded):
        return xs[0].with_shards([fn(*ts) for ts in
                                  zip(*(x.shards for x in xs))])
    return fn(*xs)


def split_batch(x: torch.Tensor, mesh, axes: Sequence[str]) -> list:
    """Entry i's rows of a global batch `x` (leading dim over `axes`), on
    its device; raises where the batch does not divide."""
    n = math.prod(mesh.shape[a] for a in axes)
    if x.shape[0] % n:
        raise ValueError(f"a global batch of {x.shape[0]} does not divide "
                         f"over the mesh's batch axes {tuple(axes)} ({n})")
    per = x.shape[0] // n
    out = []
    for i, dev in enumerate(mesh.devices):
        r = axes_rank(mesh, axes, i)
        out.append(x[r * per:(r + 1) * per].to(dev))
    return out


def _distinct(spec: tuple) -> tuple:
    """`spec` with each axis kept at its first dimension only. Under
    `use_dp_over_model` the reference's `cache_spec` names "model" on the
    batch and on the heads, which its `NamedSharding` refuses (ROADMAP
    §3 R8); the batch keeps it and the heads stay whole."""
    seen, out = set(), []
    for entry in spec:
        axes = tuple(a for a in spec_axes(entry) if a not in seen)
        seen.update(axes)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return tuple(out)


def _cache_walk(tree: Any, mesh, place: Callable) -> Any:
    """`place(leaf, spec)` at every leaf of a cache tree, its spec by
    `specs.cache_specs` (the reference's paths), duplicates dropped."""
    by_path = specs.cache_specs(tree, mesh)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in t.items()}
        return place(t, _distinct(by_path[path.lower()]))

    return walk(tree, "")


def shard_cache(cache: Any, mesh) -> Any:
    """A KV cache tree with every leaf a `Sharded` laid out by the
    reference's `cache_spec`: each entry a copy of its block."""
    return _cache_walk(cache, mesh,
                       lambda t, spec: shard_tensor(t, spec, mesh))


def cache_zeros(cache_meta: Any, mesh) -> Any:
    """The empty cache of `cache_meta`'s shapes and dtypes (meta tensors)
    placed by `cache_spec`, each entry's block allocated on its device:
    zeros, and `pos_ids` -1 (empty), as `attention.init_kv_cache`."""

    def place(t, spec):
        shards = []
        for i, dev in enumerate(mesh.devices):
            shape = t[box(t.shape, spec, mesh, i)].shape
            shards.append(torch.full(shape, -1 if t.dtype == torch.int32
                                     else 0, dtype=t.dtype, device=dev))
        return Sharded(spec, tuple(t.shape), shards, mesh)

    return _cache_walk(cache_meta, mesh, place)


def split_rows(x: torch.Tensor, mesh) -> list:
    """Entry i's rows of an input `x` (leading dim the batch) laid out by
    `specs.batch_spec`, on its device: the rows split over the data axes,
    or every row on every entry where they do not divide."""
    spec = specs.batch_spec(tuple(x.shape), mesh)
    return [x[box(x.shape, spec, mesh, i)].to(dev)
            for i, dev in enumerate(mesh.devices)]


def gather_rows(xs: list, mesh, rows: int) -> torch.Tensor:
    """The global batch of `rows` rows from each entry's rows in
    `split_rows`' layout, on the first entry's device."""
    if specs.batch_spec((rows,), mesh)[0] is None:  # replicated rows
        return xs[0]
    dev = mesh.devices[0]
    return torch.cat([xs[i].to(dev)
                      for i in leads(mesh, specs.data_axes(mesh))], 0)
