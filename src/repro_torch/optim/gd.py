"""Optimizers (port of `repro.optim.gd`). The paper's algorithm is
constant-stepsize GD (Eq. 9), stateless; momentum-GD and Adam serve the
beyond-paper experiments.

Parameters, gradients and states are trees of tensors (`core.tree`).
Every update is computed in f32 and cast back to the parameter's dtype,
as the reference's; states are f32 trees on the parameters' device, and
Adam's step count `t` is an int32 device tensor, so an update never
reads a value on the host. Python scalars are rounded to f32 before
they multiply an f32 tensor, as JAX rounds its weakly typed scalars
(`transport.weak_scalar`).

On a mesh the trees' leaves are `sharding.placement.Sharded`: each
update runs on every entry's local tensor (`_map`), so the states are
sharded like the parameters and replicas stay equal. `global_norm` sums
each distinct block's squares once, in a fixed order, on the first
entry's device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.transport import weak_scalar
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.sharding.placement import Sharded, leafwise

PyTree = Any
_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple]
    # update(grads, state, params) -> (new_params, new_state)


def _f32(x: float) -> float:
    return weak_scalar(x, _F32)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=_F32, device=p.device)


def _map(fn, *trees):
    """`tree_map` with each `Sharded` leaf updated entry by entry."""
    return tree_map(lambda *xs: leafwise(fn, *xs), *trees)


def gd(stepsize: float) -> Optimizer:
    """theta <- theta - beta v (paper Eq. 9), stateless."""
    lr = _f32(stepsize)

    def init(params):
        return ()

    def update(grads, state, params):
        new = _map(lambda p, g: (p.to(_F32) - lr * g.to(_F32))
                   .to(p.dtype), params, grads)
        return new, state

    return Optimizer(init, update)


def momentum(stepsize: float, beta: float = 0.9) -> Optimizer:
    lr, b = _f32(stepsize), _f32(beta)

    def init(params):
        return _map(_zeros, params)

    def update(grads, state, params):
        new_m = _map(lambda m, g: b * m + g.to(_F32), state, grads)
        new_p = _map(lambda p, m: (p.to(_F32) - lr * m).to(p.dtype),
                     params, new_m)
        return new_p, new_m

    return Optimizer(init, update)


def adam(stepsize: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    lr, b1_, b2_, eps_ = (_f32(x) for x in (stepsize, b1, b2, eps))
    c1, c2 = _f32(1 - b1), _f32(1 - b2)

    def init(params):
        leaf = tree_leaves(params)[0]
        return {"m": _map(_zeros, params), "v": _map(_zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=leaf.device)}

    def update(grads, state, params):
        t = state["t"] + 1
        m = _map(lambda m_, g: b1_ * m_ + c1 * g.to(_F32), state["m"],
                 grads)
        v = _map(lambda v_, g: b2_ * v_ + c2 * torch.square(g.to(_F32)),
                 state["v"], grads)
        tf = t.to(_F32)
        bc1 = 1 - torch.pow(torch.full_like(tf, b1_), tf)
        bc2 = 1 - torch.pow(torch.full_like(tf, b2_), tf)
        new_p = _map(
            lambda p, m_, v_: (p.to(_F32) - lr * (m_ / bc1.to(p.device))
                               / (torch.sqrt(v_ / bc2.to(p.device)) + eps_)
                               ).to(p.dtype),
            params, m, v)
        return new_p, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def _square_sum(g) -> torch.Tensor:
    """A leaf's f32 sum of squares; a `Sharded` leaf's over its distinct
    blocks in rank order, on its first entry's device."""
    if not isinstance(g, Sharded):
        return torch.sum(torch.square(g.to(_F32)))
    acc = None
    for i in g.distinct():
        part = torch.sum(torch.square(g.shards[i].to(_F32))).to(g.device)
        acc = part if acc is None else acc + part
    return acc


def global_norm(grads: PyTree) -> torch.Tensor:
    """f32 global L2 norm of a gradient tree (a 0-d device tensor)."""
    return torch.sqrt(sum(_square_sum(g) for g in tree_leaves(grads)))


def clip_by_global_norm(grads: PyTree, max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> PyTree:
    """Scale `grads` so the global norm is at most `max_norm`. Pass a
    precomputed `global_norm(grads)` as `norm` to avoid recomputing the
    reduction when the caller also reports it as a metric."""
    if norm is None:
        norm = global_norm(grads)
    # a tensor numerator: `float / tensor` rounds twice in torch
    scale = torch.clamp_max(
        torch.full_like(norm, _f32(max_norm)) / norm.clamp_min(_f32(1e-9)),
        1.0)
    return _map(lambda g: (g * scale.to(g.device)).to(g.dtype), grads)


def get_optimizer(name: str, stepsize: float) -> Optimizer:
    if name == "gd":
        return gd(stepsize)
    if name == "momentum":
        return momentum(stepsize)
    if name == "adam":
        return adam(stepsize)
    raise ValueError(name)
