"""Collectives over a mesh's entries, for one controlling process.

Each takes one local tensor per mesh entry (a list in mesh order) and
works on the groups of entries that differ only on the given axes
(`placement.groups`). Every sum adds the members' tensors in the group's
rank order, on the device of the entry that owns the result, so a mesh
whose entries share one card gives the bits of one whose entries are
distinct cards, run after run; no sum is left to autograd's per-device
threads.

The autograd functions follow the tensor-parallel convention over the
"model" axis (Shoeybi et al. 2019, "Megatron-LM"): a tensor replicated
over the model ranks carries the whole gradient on every rank.

  * `all_gather(dim, reduce_grad)`: the FSDP gather. Its backward is a
    reduce-scatter (`reduce_grad=True`: the members' gradients are
    partial, as over the batch axes, or over "model" when each rank uses
    the gathered tensor for its own heads), or each member's own slice
    (`reduce_grad=False`: the members compute the same replicated
    function, so each holds the whole gradient already).
  * `all_reduce`: the sum of row-parallel partial outputs; its backward
    passes each member's gradient through.
  * `copy_to`: a replicated tensor entering the model ranks' partial
    computations; the identity forward, the backward sums the members'
    gradients.
  * `vocab_parallel_embedding` / `vocab_parallel_xent`: the embedding
    lookup and the cross-entropy over a vocabulary split over "model":
    each rank's rows, and the ranks' log-sum-exp and gold logit,
    combined.

`reduce` is the plain (no autograd) sum, for the gradients of leaves
replicated over the batch axes: the data-axis sum of gradients that is
the MAC superposition. Serving, under `torch.no_grad`, takes `reduce`
(decode's partial scores over the head_dim columns, the row-parallel
outputs) and `gather` (decode's head_dim columns, the logits'
vocabulary columns).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.sharding.placement import axes_rank, groups


def _sum_in_order(parts, device: torch.device) -> torch.Tensor:
    acc = None
    for p in parts:
        p = p.to(device)
        acc = p if acc is None else acc + p
    return acc


def _per_member(group: list, devices: list, make) -> dict:
    """{member: make(device)} computed once per distinct device of the
    group (the same inputs in the same order give the same bits), each
    member after the first on a device taking a copy."""
    out, done = {}, {}
    for j in group:
        dev = devices[j]
        if dev not in done:
            done[dev] = make(dev)
            out[j] = done[dev]
        else:
            out[j] = done[dev].clone()
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, *xs):
        grps, dim, reduce_grad, devices = plan
        ctx.plan = plan
        ctx.sizes = [x.shape[dim] for x in xs]
        outs = [None] * len(xs)
        for g in grps:
            got = _per_member(g, devices, lambda dev: torch.cat(
                [xs[i].to(dev) for i in g], dim))
            for j, t in got.items():
                outs[j] = t
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        grps, dim, reduce_grad, devices = ctx.plan
        grads = [None] * len(gs)
        for g in grps:
            off = 0
            for i in g:
                n = ctx.sizes[i]
                if reduce_grad:
                    grads[i] = _sum_in_order(
                        (gs[j].narrow(dim, off, n) for j in g), devices[i])
                else:
                    grads[i] = gs[i].narrow(dim, off, n)
                off += n
        return (None, *grads)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, *xs):
        grps, devices = plan
        outs = [None] * len(xs)
        for g in grps:
            got = _per_member(g, devices, lambda dev: _sum_in_order(
                (xs[i] for i in g), dev))
            for j, t in got.items():
                outs[j] = t
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, *xs):
        ctx.plan = plan
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        grps, devices = ctx.plan
        grads = [None] * len(gs)
        for g in grps:
            got = _per_member(g, devices, lambda dev: _sum_in_order(
                (gs[i] for i in g), dev))
            for j, t in got.items():
                grads[j] = t
        return (None, *grads)


def _trivial(mesh, axes: Sequence[str]) -> bool:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n == 1


def all_gather(xs: list, mesh, axes: Sequence[str], dim: int,
               reduce_grad: bool) -> list:
    """Each member's tensor concatenated along `dim` in rank order over
    `axes`, on every member."""
    if _trivial(mesh, axes):
        return list(xs)
    dim = dim % xs[0].dim()
    plan = (groups(mesh, axes), dim, reduce_grad, mesh.devices)
    return list(_AllGather.apply(plan, *xs))


def all_reduce(xs: list, mesh, axes: Sequence[str]) -> list:
    """The members' sum in rank order over `axes`, on every member."""
    if _trivial(mesh, axes):
        return list(xs)
    return list(_AllReduce.apply((groups(mesh, axes), mesh.devices), *xs))


def copy_to(xs: list, mesh, axes: Sequence[str]) -> list:
    """The identity, whose backward sums the members' gradients over
    `axes`."""
    if _trivial(mesh, axes):
        return list(xs)
    return list(_CopyTo.apply((groups(mesh, axes), mesh.devices), *xs))


@torch.no_grad()
def reduce(xs: list, mesh, axes: Sequence[str]) -> list:
    """The members' sum in rank order over `axes`, on every member (no
    autograd)."""
    if _trivial(mesh, axes):
        return list(xs)
    outs = [None] * len(xs)
    for g in groups(mesh, axes):
        got = _per_member(g, mesh.devices, lambda dev: _sum_in_order(
            (xs[i] for i in g), dev))
        for j, t in got.items():
            outs[j] = t
    return outs


@torch.no_grad()
def gather(xs: list, mesh, axes: Sequence[str], dim: int) -> list:
    """Each member's tensor concatenated along `dim` in rank order over
    `axes`, on every member (no autograd)."""
    if _trivial(mesh, axes):
        return list(xs)
    outs = [None] * len(xs)
    for g in groups(mesh, axes):
        got = _per_member(g, mesh.devices, lambda dev: torch.cat(
            [xs[i].to(dev) for i in g], dim))
        for j, t in got.items():
            outs[j] = t
    return outs


def vocab_parallel_embedding(tables: list, tokens: list, mesh,
                             axis: str) -> list:
    """Each member's embedding rows of its tokens from a table split over
    the vocabulary along `axis` (member i holds rows [r·V_l, (r + 1)·V_l),
    r its rank): its own rows looked up, the others zero, summed over the
    members in rank order (`all_reduce`: one nonzero row a token, so the
    rows come out exact). The backward gives each member's rows its
    tokens' gradients."""
    rows = []
    for i, (table, tok) in enumerate(zip(tables, tokens)):
        n = table.shape[0]
        loc = tok.long() - axes_rank(mesh, (axis,), i) * n
        valid = (loc >= 0) & (loc < n)
        x = table[loc.clamp(0, n - 1)]
        rows.append(x * valid[..., None].to(x.dtype))
    return all_reduce(rows, mesh, (axis,))


class _VocabXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, *logits):
        grps, devices, labels, offsets = plan
        lse = [None] * len(logits)
        onehot = [None] * len(logits)
        nll = [None] * len(logits)
        for g in grps:
            amax = [logits[i].amax(-1) for i in g]
            gmax = {}
            for i in g:
                m = amax[0].to(devices[i])
                for a in amax[1:]:
                    m = torch.maximum(m, a.to(devices[i]))
                gmax[i] = m
            sumexp = [torch.exp(logits[i] - gmax[i][..., None]).sum(-1)
                      for i in g]
            gold = []
            for i in g:
                v = logits[i].shape[-1]
                loc = labels[i].long() - offsets[i]
                valid = (loc >= 0) & (loc < v)
                idx = loc.clamp(0, v - 1)[..., None]
                gold.append(torch.where(
                    valid, torch.gather(logits[i], -1, idx)[..., 0],
                    torch.zeros((), dtype=logits[i].dtype,
                                device=devices[i])))
                onehot[i] = torch.zeros_like(logits[i]).scatter_(
                    -1, idx, valid[..., None].to(logits[i].dtype))
            for i in g:
                lse[i] = torch.log(_sum_in_order(sumexp, devices[i])) \
                    + gmax[i]
                nll[i] = lse[i] - _sum_in_order(gold, devices[i])
        ctx.save_for_backward(*logits, *lse, *onehot)
        return tuple(nll)

    @staticmethod
    def backward(ctx, *gs):
        n = len(gs)
        saved = ctx.saved_tensors
        logits, lse, onehot = saved[:n], saved[n:2 * n], saved[2 * n:]
        grads = [(torch.exp(logits[i] - lse[i][..., None]) - onehot[i])
                 * gs[i][..., None] for i in range(n)]
        return (None, *grads)


def vocab_parallel_xent(logits: list, labels: list, mesh,
                        axis: str) -> list:
    """Per-position cross-entropy `lse - gold` (each member's (B, c)) of
    f32 logits split over the vocabulary along `axis`: member i holds
    vocabulary rows [r·V_l, (r + 1)·V_l), r its rank. The maximum, the
    sum of exponentials and the gold logit are combined in rank order;
    the backward gives each member its own columns' softmax minus the
    one-hot, times its incoming gradient."""
    offsets = [axes_rank(mesh, (axis,), i) * logits[i].shape[-1]
               for i in range(len(logits))]
    plan = (groups(mesh, (axis,)), mesh.devices, labels, offsets)
    return list(_VocabXent.apply(plan, *logits))
