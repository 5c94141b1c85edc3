"""Train-step builder: model loss + gradient aggregation over the MAC +
optimizer (port of `repro.training.train_step`).

`TrainConfig.aggregator` resolves through the MAC algorithm registry
(`core/mc/slots.ALGO_REGISTRY`) via the channel-transport layer
(`core.transport`); every registered algorithm trains a real model. Two
routes:

  * **fused** (`gbma` / `fdm` / `centralized`): the MAC is folded into
    the loss. GBMA's fading superposition is the gradient of each node's
    local loss weighted by its detached gain (`gbma.gbma_value_and_grad`
    with `gbma.node_weights`), then the edge noise is added to the
    reduced gradient tree (`gbma.perturb_gradients`); fdm adds its
    per-node-averaged noise the same way. One gradient tree, no per-node
    gradients.
  * **transport** (`blind`, `blind_ec`, `momentum`, `nesterov`,
    `power_control`, or any aggregator with `route='transport'`): node
    n's local gradient is taken explicitly (node n owns the n-th
    contiguous example group of the batch) and the per-node (N, ...)
    gradient tree goes through `transport.aggregate`: the superposition
    through K1 (`kernels.ota`) on the card, one launch a block.

The per-node gradients are taken by one forward and one backward per
node over its own examples (`_node_grads_fn`): N forwards of B / N
examples cost what one forward of B costs, where N backward passes over
one shared graph (`retain_graph`) would each walk the whole batch. So a
transport step launches K2 N times per layer (N x n_layers), a fused
step once per layer.

Keys are the port's `core.rng` keys of `TrainConfig.rng_impl`: threefry
in the original layout, or JAX's rbg or unsafe_rbg keys (their bits XLA's
CPU `RngBitGenerator`'s). `key(seed, impl)`, then `fold_in(base, step)`,
split into `(k_h, k_w)` on the fused route; `transport.step_key` on the
transport route. Every split, fold and draw downstream takes any kind.

**On a mesh** (`build_train_step` under `sharding.specs.use_mesh(mesh)`,
the reference's entry point; `use_dp_over_model` too where it is on):
the fused route runs over parameters laid out by the reference's rules
(`sharding.placement.shard_params(params, cfg.fsdp, mesh)`) and a global
batch, which the step splits over the batch axes. The nodes are the
batch ranks (`n_nodes` = the product of the "pod" and "data" sizes, as
the reference's launcher sets it): each entry's loss weighted by its
node's gain, the gradients summed over the batch ranks in rank order
(the MAC superposition) and landing sharded like the parameters (the
reference's `_constrain_like_params`), then the edge noise (each shard
the slice of the one-device draw), the clip and the optimizer, shard by
shard (`core.gbma.gbma_mesh_value_and_grad`, `models.meshed`). The
transport route and microbatches on a mesh are ROADMAP M12c and raise.

Stateful aggregators (receiver momentum, blind_ec's per-node residual)
carry their transport state inside the opt_state slot:
`train_step.init_state(params)` returns `opt.init(params)` for
stateless runs and `(opt.init(params), transport_state)` for stateful
ones, and `run_training` threads it either way.

A step runs where the parameters live and reads nothing back to the
host: its metrics are device tensors (and the host constant
`noise_std`), which the loop reads at log steps only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.core import rng, transport
from repro_torch.core.channel import edge_noise_std
from repro_torch.core.gbma import (GBMAConfig, gbma_mesh_value_and_grad,
                                   gbma_value_and_grad, node_weights,
                                   perturb_gradients)
from repro_torch.core.transport import weak_scalar
from repro_torch.core.tree import (tree_flatten, tree_leaves, tree_map,
                                   tree_unflatten)
from repro_torch.models import meshed
from repro_torch.optim.gd import Optimizer, clip_by_global_norm, global_norm
from repro_torch.sharding import specs

PyTree = Any

# aggregators whose MAC folds into the loss / reduced tree (no per-node
# gradients); everything else goes through the transport
_FUSED_AGGREGATORS = ("gbma", "fdm", "centralized")
_RNG_IMPLS = ("threefry2x32", "rbg", "unsafe_rbg")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    aggregator: str = "gbma"  # any slots.ALGO_REGISTRY name
    gbma: GBMAConfig = dataclasses.field(default_factory=GBMAConfig)
    seed: int = 0
    clip_norm: Optional[float] = None
    # 'threefry2x32', 'rbg' or 'unsafe_rbg' (JAX's
    # `jax.random.key(seed, impl=...)`)
    rng_impl: str = "threefry2x32"
    # gradient accumulation over microbatches (fused route only): each
    # node still transmits one analog gradient per slot
    microbatches: int = 1
    # 'auto': fused for gbma / fdm / centralized, transport for the rest;
    # 'transport': every aggregator through transport.aggregate
    route: str = "auto"
    # None derives TransportConfig(n_nodes, channel) from `gbma`; an
    # explicit TransportConfig is used as it is
    transport: Optional[transport.TransportConfig] = None


def _check_rng_impl(tcfg: TrainConfig) -> None:
    if tcfg.rng_impl not in _RNG_IMPLS:
        raise ValueError(f"rng_impl must be one of {_RNG_IMPLS}, got "
                         f"{tcfg.rng_impl!r}")


def _base_key_fn(seed: int,
                 impl: str) -> Callable[[torch.device], torch.Tensor]:
    """key(seed) of kind `impl` on a device, made once per device."""
    keys = {}

    def base_key(device: torch.device) -> torch.Tensor:
        if device not in keys:
            keys[device] = rng.key(seed, device=device, impl=impl)
        return keys[device]

    return base_key


def _device_of(tree: PyTree) -> torch.device:
    return tree_leaves(tree)[0].device


def _fdm_noise(grads: PyTree, key: torch.Tensor, gcfg: GBMAConfig) -> PyTree:
    """FDM-GD: each node's dedicated channel adds independent noise at
    energy E_N; the edge averages N received gradients, so the
    per-coordinate std is sigma_w / (sqrt(E_N) sqrt(N)) (host f64, as the
    reference's)."""
    std = (gcfg.channel.noise_std
           / math.sqrt(gcfg.channel.energy * gcfg.n_nodes))
    return transport.add_tree_noise(grads, key, std)


def _accumulated_grads(vg, params, batch, weights, m: int) -> tuple:
    """(mean loss, mean gradient) over m microbatches, the gradient
    accumulated in f32: the per-step activations shrink by m at the cost
    of an f32 accumulator (the reference's scan, as a loop)."""
    mb_batch = tree_map(
        lambda x: x.reshape(m, x.shape[0] // m, *x.shape[1:]), batch)
    mb_w = weights.reshape(m, -1)
    dev = weights.device
    # a device divisor: a Python one may become a reciprocal product
    div = torch.full((), float(m), dtype=torch.float32, device=dev)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(m):
        loss, g = vg(params, tree_map(lambda x: x[i], mb_batch), mb_w[i])
        acc = tree_map(lambda a, x: a + x.to(torch.float32) / div, acc, g)
        loss_sum = loss_sum + loss / div
    return loss_sum, acc


def resolve_route(tcfg: TrainConfig) -> str:
    """'fused' or 'transport' for this config; validates the aggregator
    against the registry either way."""
    transport.resolve(tcfg.aggregator)  # raises on unknown names
    if tcfg.route not in ("auto", "transport"):
        raise ValueError(
            f"route must be 'auto' or 'transport', got {tcfg.route!r}")
    if tcfg.route == "transport":
        return "transport"
    return "fused" if tcfg.aggregator in _FUSED_AGGREGATORS else "transport"


def _transport_config(tcfg: TrainConfig) -> transport.TransportConfig:
    if tcfg.transport is not None:
        return tcfg.transport
    return transport.TransportConfig(n_nodes=tcfg.gbma.n_nodes,
                                     channel=tcfg.gbma.channel)


def _node_grads_fn(model, n_nodes: int) -> Callable:
    """(params, batch) -> (mean clean loss, per-node gradient tree with
    (n_nodes, ...) f32-or-param-dtype leaves). Node n's local objective
    f_n is the mean loss over its contiguous example group (the
    `node_weights` partition), so the transport's (1/N) sum_n
    superposition estimates grad F as the fused route does. One forward
    and one backward per node; each node's gradients are written into
    row n of the stacked leaves."""

    def fn(params, batch):
        bsz = tree_leaves(batch)[0].shape[0]
        if bsz % n_nodes != 0:
            raise ValueError(
                f"global batch {bsz} not divisible by n_nodes {n_nodes}")
        per = bsz // n_nodes
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        stacked = [torch.empty((n_nodes,) + tuple(p.shape), dtype=p.dtype,
                               device=p.device) for p in leaves]
        losses = []
        p_tree = tree_unflatten(treedef, live)
        for n in range(n_nodes):
            b = tree_map(lambda x: x[n * per:(n + 1) * per], batch)
            with torch.enable_grad():
                per_ex, _ = model.train_loss_per_example(p_tree, b)
                loss = torch.mean(per_ex)
                grads = torch.autograd.grad(loss, live, allow_unused=True)
            for dst, g in zip(stacked, grads):
                if g is None:
                    dst[n].zero_()
                else:
                    dst[n].copy_(g)
            losses.append(loss.detach())
        return torch.mean(torch.stack(losses)), \
            tree_unflatten(treedef, stacked)

    return fn


def _mesh_value_and_grad(model, gcfg: GBMAConfig, mesh) -> Callable:
    """The fused route's (params, batch, weights) -> (loss, grads) over
    `mesh`, for the dense decoder (`models.meshed`); the nodes are the
    batch ranks."""
    meshed.check_supported(model.cfg)
    lay = meshed.MeshLayout.of(mesh)
    nodes = 1
    for a in ("pod", "data"):
        nodes *= mesh.shape.get(a, 1)
    if gcfg.n_nodes != nodes:
        raise ValueError(
            f"on a mesh the MAC's nodes are its pod x data ranks: n_nodes "
            f"must be {nodes}, got {gcfg.n_nodes}")
    return gbma_mesh_value_and_grad(
        lambda p, b: meshed.train_losses(model, p, b["tokens"], lay),
        mesh, lay.batch_axes)


def _clip_and_metrics(grads: PyTree, tcfg: TrainConfig) -> tuple:
    """`grad_norm` is the PRE-clip global norm; `clip_frac` marks the
    steps where the clip engaged. The clip reuses the computed norm."""
    gnorm = global_norm(grads)
    if tcfg.clip_norm is not None:
        grads = clip_by_global_norm(grads, tcfg.clip_norm, norm=gnorm)
        clip_frac = (gnorm > weak_scalar(tcfg.clip_norm, torch.float32)) \
            .to(torch.float32)
    else:
        clip_frac = torch.zeros((), dtype=torch.float32, device=gnorm.device)
    return grads, {"grad_norm": gnorm, "clip_frac": clip_frac}


def build_train_step(model, tcfg: TrainConfig, opt: Optimizer) -> Callable:
    """Returns train_step(params, opt_state, batch, step) ->
    (params, opt_state, metrics), running where `params` live (`batch`,
    a dict of tensors, on the same device).

    The returned callable carries `train_step.init_state(params)`: use it
    instead of `opt.init` so stateful aggregators get their transport
    state threaded through the opt_state slot. Metrics: `loss` (clean),
    `grad_norm` (global norm BEFORE clipping), `clip_frac`, `noise_std`,
    and on the transport route `tx_energy` (the slot's transmitted energy
    E_N sum_n ||x_n||^2)."""
    _check_rng_impl(tcfg)
    gcfg = tcfg.gbma
    route = resolve_route(tcfg)
    base_key = _base_key_fn(tcfg.seed, tcfg.rng_impl)
    mesh = specs.current_mesh()

    if mesh is not None and (route == "transport" or tcfg.microbatches > 1):
        raise NotImplementedError(
            "the transport route and microbatches on a mesh are ROADMAP "
            "M12c; the mesh step takes the fused route (gbma, fdm, "
            "centralized) with microbatches=1")
    if route == "transport":
        return _build_transport_step(model, tcfg, opt, base_key)
    if tcfg.transport is not None:
        raise ValueError(
            "TrainConfig.transport is set but the fused route ignores it; "
            "pass route='transport' to use it")

    if mesh is None:
        vg = gbma_value_and_grad(
            lambda p, b: model.train_loss_per_example(p, b)[0])
    else:
        vg = _mesh_value_and_grad(model, gcfg, mesh)
    gbma_on = tcfg.aggregator == "gbma" and gcfg.enabled

    def train_step(params, opt_state, batch, step):
        k_h, k_w = rng.split(rng.fold_in(base_key(_device_of(params)),
                                         step))
        bsz = batch["tokens"].shape[0]
        if gbma_on:
            weights = node_weights(k_h, gcfg, bsz)
        else:
            weights = torch.ones((bsz,), dtype=torch.float32,
                                 device=k_h.device)

        if tcfg.microbatches > 1:
            clean_loss, grads = _accumulated_grads(
                vg, params, batch, weights, tcfg.microbatches)
        else:
            clean_loss, grads = vg(params, batch, weights)

        if gbma_on:
            grads = perturb_gradients(grads, k_w, gcfg)
        elif tcfg.aggregator == "fdm":
            grads = _fdm_noise(grads, k_w, gcfg)

        grads, metrics = _clip_and_metrics(grads, tcfg)
        params, opt_state = opt.update(grads, opt_state, params)
        metrics["loss"] = clean_loss
        metrics["noise_std"] = (edge_noise_std(gcfg.channel, gcfg.n_nodes)
                                if tcfg.aggregator == "gbma" else 0.0)
        return params, opt_state, metrics

    train_step.init_state = opt.init
    return train_step


def _build_transport_step(model, tcfg: TrainConfig, opt: Optimizer,
                          base_key) -> Callable:
    """The transport route: explicit per-node gradients through
    `transport.aggregate`. Slot keys: `transport.step_key`
    (`fold_in(base, step)`, or the engine's `split(key(seed), steps)`
    replay when `transport.mc_steps` is set)."""
    algo = tcfg.aggregator
    tp = _transport_config(tcfg)
    spec = transport.resolve(algo)
    if tcfg.microbatches > 1:
        raise ValueError(
            "the transport route materializes per-node gradients and does "
            "not compose with microbatch accumulation; use microbatches=1")
    stateful = transport.has_state(algo)
    grads_fn = _node_grads_fn(model, tp.n_nodes)

    def train_step(params, opt_state, batch, step):
        if stateful:
            opt_state, agg_state = opt_state
        else:
            agg_state = None
        slot_key = transport.step_key(base_key(_device_of(params)), step,
                                      tp.mc_steps)
        eval_params = transport.lookahead_params(algo, params, agg_state,
                                                 tp) \
            if spec.nesterov else params
        clean_loss, node_g = grads_fn(eval_params, batch)
        update, agg_state, aux = transport.aggregate(
            algo, node_g, slot_key, tp, agg_state)
        del node_g
        update, metrics = _clip_and_metrics(update, tcfg)
        params, opt_state = opt.update(update, opt_state, params)
        if stateful:
            opt_state = (opt_state, agg_state)
        metrics["loss"] = clean_loss
        metrics["noise_std"] = (edge_noise_std(tp.channel, tp.n_nodes)
                                if spec.ota else 0.0)
        metrics["tx_energy"] = aux["tx_energy"]
        return params, opt_state, metrics

    def init_state(params):
        if stateful:
            return (opt.init(params), transport.init_state(algo, params, tp))
        return opt.init(params)

    train_step.init_state = init_state
    return train_step
