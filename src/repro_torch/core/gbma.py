"""GBMA — Gradient-Based Multiple Access (paper §III; port of
`repro.core.gbma`).

Three tiers, all realizing Eq. (8)-(9):

  v_k = (1/N) sum_n h_{n,k} g_n(theta_k) + w_k,
  w_k ~ N(0, sigma_w^2 / (N^2 E_N) I_d),  theta_{k+1} = theta_k - beta v_k

(i)   `ota_aggregate` / `GBMASimulator`: the vectorized N-node simulation
      of the paper's experiments, veneers over `transport.aggregate`, so
      the superposition goes through K1 (`kernels.ota`) on the card.
(ii)  `gbma_value_and_grad` + `perturb_gradients`: each node's local loss
      weighted by its detached gain (grad sum_n h_n f_n / N =
      sum_n h_n g_n / N), then the edge noise added to the gradient tree;
      over a mesh, `gbma_mesh_value_and_grad`, the nodes the batch ranks.
(iii) `shard_map_aggregate`: the explicit per-rank protocol: scale the
      local gradient by the local gain, all-reduce (SUM) over a
      `torch.distributed` process group (the physical superposition),
      divide by N, add the edge noise once from a key every rank shares.

Keys are the port's `core.rng` key data; RNG streams split for split as
the reference's. The veneers take the channel constants in f32 as the
engine does (`transport`), `perturb_gradients` keeps its std in host
f64 as the reference does: each twin rounds as its own reference.
Functions run where their tensors live.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import rng, transport
from repro_torch.core.channel import ChannelConfig, edge_noise_std, \
    sample_gains
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.sharding import comm, placement

PyTree = Any


# --------------------------------------------------------------------------
# tier (i): vectorized N-node simulation (paper experiments)
# --------------------------------------------------------------------------
def ota_aggregate(grads: torch.Tensor, key: torch.Tensor, cfg: ChannelConfig,
                  use_kernel: bool = True) -> torch.Tensor:
    """One MAC slot: `grads (N, d)` -> v_k `(d,)` per Eq. (8), cast back
    to grads' dtype.

    A veneer over `transport.aggregate('gbma', ...)`: the slot key splits
    into (k_h, k_w), gains then edge noise, as the reference's.
    `use_kernel` (default) sends the superposition through K1 where the
    tensors are on the card, and through its plain version on the CPU
    (`ota_impl='auto'`); False takes the plain version everywhere."""
    tcfg = transport.TransportConfig(
        n_nodes=grads.shape[0], channel=cfg,
        ota_impl="auto" if use_kernel else "ref")
    v, _, _ = transport.aggregate("gbma", grads, key, tcfg)
    return v.to(grads.dtype)


@dataclasses.dataclass
class GBMASimulator:
    """Iterates theta_{k+1} = theta_k - beta v_k on an N-node problem.

    `grad_fn(theta) -> (N, d)` gives every node's local gradient (the
    simulator plays the nodes and the edge). `run` returns the trajectory
    `(steps + 1, d)`; one `ota_aggregate` (one K1 launch on the card) a
    step, the keys `split(key, steps)`."""

    grad_fn: Callable[[torch.Tensor], torch.Tensor]
    channel: ChannelConfig
    stepsize: float

    def run(self, theta0: torch.Tensor, steps: int,
            key: torch.Tensor) -> torch.Tensor:
        keys = rng.split(key.to(theta0.device), steps)
        theta, traj = theta0, [theta0]
        for k in range(steps):
            v = ota_aggregate(self.grad_fn(theta), keys[k], self.channel)
            theta = theta - self.stepsize * v
            traj.append(theta)
        return torch.stack(traj)


# --------------------------------------------------------------------------
# tier (ii): the h-weighted loss
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GBMAConfig:
    """GBMA integration config for the training substrate.

    n_nodes: transmitting nodes N; node n owns the n-th contiguous group
      of the global batch (global_batch % n_nodes == 0).
    channel: the fading-MAC model.
    enabled: False degrades the aggregator to the exact (centralized)
      mean: equal gains, no edge noise (Remark 1).
    noise_dtype: the edge noise's draw dtype, 'float32' (the faithful
      baseline) or 'bfloat16' (JAX's bf16 draw, `rng.normal`).
    """

    n_nodes: int = 16
    channel: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    enabled: bool = True
    noise_dtype: str = "float32"


def node_weights(key: torch.Tensor, gcfg: GBMAConfig,
                 global_batch: int) -> torch.Tensor:
    """Per-example fading weights `(global_batch,)`, on the key's device.

    Example i belongs to node floor(i / (B / N)); all of a node's examples
    share its slot gain h_{n,k}. With `enabled=False`, all ones (equal
    gains, noiseless edge: centralized GD, Remark 1)."""
    if not gcfg.enabled:
        return torch.ones((global_batch,), dtype=torch.float32,
                          device=key.device)
    n = gcfg.n_nodes
    if global_batch % n != 0:
        raise ValueError(
            f"global_batch {global_batch} not divisible by n_nodes {n}")
    return sample_gains(key, gcfg.channel, (n,)).repeat_interleave(
        global_batch // n)


def gbma_value_and_grad(loss_fn: Callable[..., torch.Tensor]
                        ) -> Callable[..., Tuple[torch.Tensor, PyTree]]:
    """Wrap a per-example loss into the h-weighted GBMA objective.

    `loss_fn(params, batch) -> (B,)` per-example losses, `params` a tree
    of tensors. Returns `(params, batch, weights) -> (mean_loss, grads)`
    with `grads = (1/N) sum_n h_n grad f_n` (f_n the mean loss of node
    n's examples, h_n folded into per-example weights that sum to B): the
    gradient of mean(weights * losses) by `torch.autograd.grad`, the
    weights detached (the reference's `stop_gradient`), and the clean
    mean loss. The caller's tensors are not modified; a leaf the loss
    does not reach gets a zero gradient."""

    def fn(params, batch, weights):
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            losses = loss_fn(tree_unflatten(treedef, live), batch)
            w = weights.detach().to(losses.dtype)
            grads = torch.autograd.grad(torch.mean(w * losses), live,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, live)]
        return torch.mean(losses.detach()), tree_unflatten(treedef, grads)

    return fn


def gbma_mesh_value_and_grad(losses_fn: Callable[..., list], mesh,
                             batch_axes: tuple
                             ) -> Callable[..., Tuple[torch.Tensor, PyTree]]:
    """`gbma_value_and_grad` over a mesh. `losses_fn(params, local_batch)`
    takes a tree of `sharding.placement.Sharded` leaves and each mesh
    entry's rows of the batch (a dict of per-entry lists) and returns
    each entry's per-example losses.

    Returns `(params, batch, weights) -> (mean_loss, grads)`: the global
    batch and its per-example weights are split over `batch_axes` (batch
    rank r holds rows [r·B/n, (r + 1)·B/n): node r's contiguous examples
    and its gain when the nodes are the batch ranks), each entry's
    objective is sum(w · losses) / B (the global batch's normalisation),
    and the gradients land sharded like the parameters: summed over the
    batch ranks where a leaf is replicated over them, in rank order (the
    data-axis sum that is the MAC superposition; a leaf split over a
    batch axis was reduce-scattered by its gather's backward). The clean
    loss is the mean over the global batch, on the mesh's first
    device."""

    def fn(params, batch, weights):
        leaves, treedef = tree_flatten(params)
        live = [leaf.with_shards([s.detach().requires_grad_(True)
                                  for s in leaf.shards]) for leaf in leaves]
        local = {k: placement.split_batch(v, mesh, batch_axes)
                 for k, v in batch.items()}
        w_local = placement.split_batch(weights.detach(), mesh, batch_axes)
        bsz = weights.shape[0]
        flat = [s for leaf in live for s in leaf.shards]
        with torch.enable_grad():
            losses = losses_fn(tree_unflatten(treedef, live), local)
            objs = [torch.sum(w.to(x.dtype) * x)
                    / torch.full((), float(bsz), dtype=x.dtype,
                                 device=x.device)
                    for w, x in zip(w_local, losses)]
            grads = torch.autograd.grad(objs, flat, allow_unused=True)
        out, k = [], 0
        for leaf in live:
            n = len(leaf.shards)
            shards = [torch.zeros_like(p) if g is None else g
                      for g, p in zip(grads[k:k + n], leaf.shards)]
            k += n
            missing = [a for a in batch_axes if a not in leaf.used_axes()]
            out.append(leaf.with_shards(comm.reduce(shards, mesh, missing)))
        dev = mesh.devices[0]
        clean = torch.mean(torch.cat([
            losses[i].detach().to(dev)
            for i in placement.leads(mesh, batch_axes)]))
        return clean, tree_unflatten(treedef, out)

    return fn


def perturb_gradients(grads: PyTree, key: torch.Tensor, gcfg: GBMAConfig,
                      dtype=None) -> PyTree:
    """Add the edge noise w_k to the superposed gradient tree (Eq. 8).

    Per-leaf independent normals of std sigma_w / (N sqrt(E_N)), leaf i
    (JAX's tree order) drawn from `split(key, n_leaves)[i]`, so the tree
    structure, not memory order, defines the stream; the same key on
    every rank draws the same noise. The draw is
    `transport.add_tree_noise` in `dtype` (default `gcfg.noise_dtype`);
    the std is the reference's host f64 value, rounded to each leaf's
    dtype as its Python scalar is."""
    if not gcfg.enabled:
        return grads
    if dtype is None:
        dtype = gcfg.noise_dtype
    std = edge_noise_std(gcfg.channel, gcfg.n_nodes)
    return transport.add_tree_noise(grads, key, std, noise_dtype=dtype)


# --------------------------------------------------------------------------
# tier (iii): the explicit protocol over torch.distributed
# --------------------------------------------------------------------------
def shard_map_aggregate(local_grad: PyTree, local_gain: torch.Tensor,
                        key: torch.Tensor, gcfg: GBMAConfig,
                        group: Optional[Any] = None) -> PyTree:
    """The explicit OTA protocol, run by every rank of `group` (None: the
    default process group of `torch.distributed.init_process_group`).

    Each rank scales its local gradient tree by its own slot gain (the
    analog amplification after phase correction and matched filtering),
    all-reduces each leaf (SUM: the superposition on the MAC), divides by
    N = `gcfg.n_nodes` and adds the edge noise once (`perturb_gradients`
    from `key`, identical on every rank, so every rank returns the same
    tree). The reference psums over mesh axes inside `shard_map`; here a
    process group stands for them."""
    import torch.distributed as dist

    n = gcfg.n_nodes

    def superpose(g):
        s = g * local_gain.to(device=g.device, dtype=g.dtype)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        return s / n

    return perturb_gradients(tree_map(superpose, local_grad), key, gcfg)


def ota_aggregate_multiantenna(grads: torch.Tensor, key: torch.Tensor,
                               cfg: ChannelConfig,
                               n_antennas: int) -> torch.Tensor:
    """Multi-antenna edge receiver (related work [12], Amiri et al.): each
    of M antennas sees its own fading realization of the superposition;
    the MRC average divides both the gain-distortion variance and the
    noise variance by M. A veneer over `transport.aggregate('gbma', ...,
    n_antennas=M)`: the key splits `split(key, M)` into per-antenna slot
    chains (M = 1 included: its extra split is part of the stream); one
    K1 launch covers all M antennas on the card."""
    tcfg = transport.TransportConfig(n_nodes=grads.shape[0], channel=cfg,
                                     n_antennas=n_antennas)
    v, _, _ = transport.aggregate("gbma", grads, key, tcfg)
    return v.to(grads.dtype)


def blind_ota_aggregate(grads: torch.Tensor, key: torch.Tensor,
                        cfg: ChannelConfig, n_antennas: int) -> torch.Tensor:
    """Blind-transmitter OTA slot (Amiri, Duman & Gündüz,
    arXiv:1907.03909): nodes send sqrt(E_N) g_n with no channel state (no
    inversion, no phase correction); antenna m receives
    y_m = sum_n h~_{n,m} sqrt(E_N) g_n + z~_m with complex gains of full
    uniform phase; the edge (receiver CSI only) MRC-combines

        v = 1/(N M E[h^2]) sum_m Re{(sum_n h~*_{n,m}) y_m} / sqrt(E_N),

    which hardens to the equal-gain update as M grows. A veneer over
    `transport.aggregate('blind', ...)`: slot key -> `split(key, M)` ->
    per antenna (k_h complex gains, k_w stacked real/imag noise). The
    combine is plain PyTorch, as the reference computes it outside any
    kernel."""
    tcfg = transport.TransportConfig(n_nodes=grads.shape[0], channel=cfg,
                                     n_antennas=n_antennas)
    v, _, _ = transport.aggregate("blind", grads, key, tcfg)
    return v.to(grads.dtype)


# --------------------------------------------------------------------------
# energy accounting
# --------------------------------------------------------------------------
def slot_energy(grads: torch.Tensor, cfg: ChannelConfig) -> torch.Tensor:
    """Total transmitted energy of one slot, sum_n E_N ||g_n||^2
    (orthonormal waveforms: node n sends energy E_N ||g_n||^2)."""
    return cfg.energy * grads.to(torch.float32).square().sum()
