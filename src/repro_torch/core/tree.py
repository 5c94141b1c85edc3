"""Parameter and gradient trees in JAX's pytree order.

The reference keys per-leaf random streams by leaf position
(`split(key, n_leaves)[i]` in `transport.add_tree_noise` and
`gbma.perturb_gradients`), so the port must visit leaves in the order
`jax.tree_util.tree_flatten` does: a dict's values by SORTED key (not
insertion order, which `torch.utils._pytree` keeps), lists and tuples by
position, `None` as an empty subtree; anything else is a leaf.
Unflattening rebuilds each dict in its original key order.
"""
from __future__ import annotations

from typing import Any, Callable

_LEAF = object()  # a leaf's place in a tree definition


def _walk(t: Any, leaves: list) -> Any:
    """`t`'s tree definition; its leaves appended to `leaves` in JAX's
    order. (A module-level recursion: a nested function that calls
    itself is a reference cycle through its closure, which would hold
    every leaf it saw -- gradient trees of GBs on the card -- until the
    cyclic garbage collector runs.)"""
    if isinstance(t, dict):
        done = {k: _walk(t[k], leaves) for k in sorted(t)}
        return {k: done[k] for k in t}
    if isinstance(t, (list, tuple)):
        out = [_walk(v, leaves) for v in t]
        if isinstance(t, list):
            return out
        return type(t)(*out) if hasattr(t, "_fields") else tuple(out)
    if t is None:
        return None
    leaves.append(t)
    return _LEAF


def _build(t: Any, it) -> Any:
    """The tree of definition `t` with leaves taken from the iterator
    `it` in JAX's order."""
    if isinstance(t, dict):
        done = {k: _build(t[k], it) for k in sorted(t)}
        return {k: done[k] for k in t}
    if isinstance(t, (list, tuple)):
        out = [_build(v, it) for v in t]
        if isinstance(t, list):
            return out
        return type(t)(*out) if hasattr(t, "_fields") else tuple(out)
    if t is None:
        return None
    return next(it)


def tree_flatten(tree: Any) -> tuple:
    """(leaves in JAX's order, treedef): the treedef is the tree with
    every leaf replaced by a placeholder, for `tree_unflatten`."""
    leaves = []
    return leaves, _walk(tree, leaves)


def tree_unflatten(treedef: Any, leaves) -> Any:
    """The tree of `treedef` with `leaves` in JAX's order."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree definition holds")
    return out


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("tree_map needs trees of one structure")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
