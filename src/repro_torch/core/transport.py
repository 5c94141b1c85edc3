"""Channel-transport layer: any registered MAC algorithm on a gradient TREE
(port of `repro.core.transport`).

It applies any `slots.ALGO_REGISTRY` entry to a tree of per-node
gradients (nested dicts, lists and tuples of tensors whose leaves carry
a leading node axis of length N), so the algorithms the Monte Carlo
engine validates also aggregate a real model's gradients. The tree is
flattened in JAX's order (`core.tree`): leaf i keys stream i wherever a
stream is keyed per leaf.

How a slot evaluates:

  * the leaves are viewed as `(N, size)` column panels of one logical
    `(N, D)` transmission (D = total parameter count); the concatenated
    matrix is never built unless `block_d=FULL_CONCAT` asks for it;
  * the slot's random draws are made ONCE for the full D through the
    algorithm's `hoist_draws` twin (the engine's hoisted plan, at one
    step and one trajectory), then column-sliced per block
    (`slots.slice_draws`): each block takes ITS coordinates of THE
    slot's streams, so the draws are bitwise the same under any tiling
    and only the f32 node sum may round differently per block shape
    (tiled and untiled agree to <= 1e-6);
  * each block is a strided view `(1, N, hi - lo)` of its leaf, and the
    single-antenna OTA superposition (gbma, momentum, nesterov,
    power_control) goes through K1 (`kernels.ota`), which reads the view
    in place: one launch per block, f32 accumulation. `ota_impl` picks
    the route: 'auto' (default: the kernel on CUDA tensors, its plain
    version on CPU tensors), 'kernel' or 'ref'; the reference's
    'pallas' reads as 'kernel' and its 'inline' as 'ref';
  * `transmit_dtype='bfloat16'` casts the transmitted blocks to bf16
    while gains, noise and the accumulation stay f32 (the update is
    f32). `centralized` is exempt: it models no channel.

Slot state (`init_state`): 'm', the receiver momentum of the momentum
and nesterov algorithms (m <- gamma m + v, the update); 'e', blind_ec's
per-node residual, with the power-budget truncation
alpha = min(1, sqrt(B / ||g + e||^2)) taken over the FULL per-node
vector, across all leaves, before any block is sent.

Keys are the port's `core.rng` key data, `(2,)` int64 tensors.
`step_key(base, step)` is the training stack's `fold_in` schedule;
`step_key(base, step, mc_steps=T)` replays the engine's
`split(key(seed), T)[step]`, for parity with `run_mc`.

Every function runs where its tensors live: the port's entry points put
them on the card (`make_ctx` alone takes `device`, None = the card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import rng
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.mc.slots import (ALGO_REGISTRY, AlgoSpec, SlotCtx,
                                       slot_update_block, with_antennas)
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.sharding.placement import Sharded

PyTree = Any

# block_d sentinel: one slot call on the concatenated (N, D) matrix, the
# untiled reference the tiled path is held to
FULL_CONCAT = -1
# the transmitted energy's f32 squares are taken this many values at a
# time on a larger leaf: a whole (N, size) leaf widened to f32 and squared
# would hold two f32 copies at once (pixtral-12b's embedding gradient at N
# = 8 is 5.4 G values: 2 x 20 GiB)
ENERGY_CHUNK = 1 << 28

# the port's OTA routes, and the reference's names for them
_OTA_IMPLS = {"auto": "auto", "kernel": "kernel", "ref": "ref",
              "pallas": "kernel", "inline": "ref"}


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """The MAC transport of one training run.

    n_nodes: transmitting nodes N; every gradient leaf carries a leading
      node axis of this length.
    channel: the fading-MAC model (shared with the engine).
    n_antennas: edge antenna count M: required for the blind family, the
      MRC path for the precoded family (None = a single antenna, the
      stream of `GBMASimulator`).
    gamma: receiver momentum of the uses_gamma algorithms.
    stepsize: the optimizer's stepsize beta, read ONLY by the nesterov
      lookahead theta - beta gamma m; keep it equal to the optimizer's.
    power_budget: blind_ec's per-slot per-node budget B (squared norm of
      the transmitted vector; inf = unbounded).
    invert_channel / h_min: fdm gain equalization and the power-control
      silence threshold, as in the engine.
    block_d: column tile width. None = one block per leaf; an int tiles
      leaves into <= block_d columns; FULL_CONCAT builds the whole
      (N, D) matrix for one slot call.
    transmit_dtype: None (f32) or 'bfloat16' (or torch.bfloat16): the
      dtype of the transmitted blocks; gains, noise and accumulation stay
      f32.
    ota_impl: 'auto' | 'kernel' | 'ref' (or the reference's 'pallas' |
      'inline') for the single-antenna OTA superposition.
    mc_steps: when set, `step_key` replays the engine's
      `split(key(seed), mc_steps)` schedule; None = `fold_in`.
    """

    n_nodes: int = 16
    channel: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    n_antennas: Optional[int] = None
    gamma: float = 0.9
    stepsize: float = 0.0
    power_budget: float = math.inf
    invert_channel: bool = False
    h_min: float = 0.3
    block_d: Optional[int] = None
    transmit_dtype: Any = None
    ota_impl: str = "auto"
    mc_steps: Optional[int] = None


def _dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ('bfloat16')."""
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


def weak_scalar(x: float, dtype: torch.dtype) -> float:
    """A Python float rounded to `dtype`, as JAX rounds a Python scalar
    (weakly typed) that multiplies an array of that dtype: the product of
    two values of `dtype` then rounds once, as in the reference."""
    return float(torch.tensor(float(x), dtype=dtype))


def resolve(algo: str) -> AlgoSpec:
    """Registry lookup with the engine's error message."""
    if algo not in ALGO_REGISTRY:
        raise ValueError(
            f"unknown algo {algo!r}; expected one of {tuple(ALGO_REGISTRY)}")
    return ALGO_REGISTRY[algo]


def has_state(algo: str) -> bool:
    """Whether `aggregate` carries state for this algorithm between steps
    (momentum carry and/or error-feedback residual)."""
    spec = resolve(algo)
    return spec.uses_gamma or spec.error_feedback


def init_state(algo: str, params: PyTree, cfg: TransportConfig) -> dict:
    """Zero transport state for `aggregate`, on the params' device: 'm',
    the params-shaped f32 receiver momentum of uses_gamma algorithms;
    'e', blind_ec's (n_nodes, *leaf.shape) f32 per-node residual tree."""
    spec = resolve(algo)
    st = {}
    if spec.uses_gamma:
        st["m"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    if spec.error_feedback:
        st["e"] = tree_map(lambda p: torch.zeros(
            (cfg.n_nodes,) + tuple(p.shape), dtype=torch.float32,
            device=p.device), params)
    return st


def step_key(base_key: torch.Tensor, step: int,
             mc_steps: Optional[int] = None) -> torch.Tensor:
    """This step's slot key. Default: `fold_in(base_key, step)` (the
    training stack's schedule: any horizon, O(1) per step). With
    `mc_steps`, the engine's `split(key(seed), steps)[step]` instead:
    threefry's split streams depend on the TOTAL count, so parity with
    the engine needs its full horizon (a parity-testing mode)."""
    if mc_steps is None:
        return rng.fold_in(base_key, step)
    return rng.split(base_key, mc_steps)[step]


def lookahead_params(algo: str, params: PyTree, state: Optional[dict],
                     cfg: TransportConfig) -> PyTree:
    """Nesterov lookahead theta_eval = theta - beta gamma m (the engine's
    gradient evaluation point); identity for every other algorithm."""
    spec = resolve(algo)
    if not spec.nesterov or not state or "m" not in state:
        return params
    la = cfg.stepsize * cfg.gamma
    return tree_map(
        lambda p, m: (p.to(torch.float32) - la * m).to(p.dtype),
        params, state["m"])


def add_tree_noise(grads: PyTree, key: torch.Tensor, std: float,
                   noise_dtype=torch.float32) -> PyTree:
    """Per-leaf i.i.d. normal noise of scalar std: leaf i (JAX's order)
    draws from `split(key, n_leaves)[i]`, so the tree's structure defines
    the stream (the same key on every rank draws the same noise). Each
    leaf gets `g + std * normal(k, g.shape, noise_dtype).to(g.dtype)`,
    std rounded to the leaf's dtype as the reference's Python scalar is;
    bf16 noise is JAX's own bf16 draw (`rng.normal`). A leaf laid out over
    a mesh (`sharding.placement.Sharded`) is drawn whole, on the key's
    device, and each entry adds its block of the draw: every shard's
    noise is the slice of the one-device draw, bit for bit, and replicas
    get equal copies."""
    leaves, treedef = tree_flatten(grads)
    keys = rng.split(key, len(leaves))
    nd = _dtype(noise_dtype)

    def noisy(g, k):
        z = rng.normal(k, tuple(g.shape), dtype=nd)
        if isinstance(g, Sharded):
            return g.with_shards([
                s + weak_scalar(std, s.dtype)
                * z[g.box(i)].to(device=s.device, dtype=s.dtype)
                for i, s in enumerate(g.shards)])
        return g + weak_scalar(std, g.dtype) * z.to(g.dtype)

    return tree_unflatten(treedef, [noisy(g, k)
                                    for g, k in zip(leaves, keys)])


# --------------------------------------------------------------------------
# internals
# --------------------------------------------------------------------------
def _params_dict(cfg: TransportConfig, device: torch.device) -> dict:
    """The `(1,)` f32 params a slot reads: the one-trajectory counterpart
    of the engine's per-trajectory channel params (the constants rounded
    to f32 before use, as the engine does)."""
    ch = cfg.channel
    f32 = lambda x: torch.full((1,), float(np.float32(x)),
                               dtype=torch.float32, device=device)
    return {"scale": f32(ch.scale), "noise_std": f32(ch.noise_std),
            "energy": f32(ch.energy),
            "phase_error_max": f32(ch.phase_error_max),
            "rician_k": f32(ch.rician_k), "n_nodes": f32(cfg.n_nodes)}


def _resolve_ota_impl(cfg: TransportConfig) -> str:
    if cfg.ota_impl not in _OTA_IMPLS:
        raise ValueError(
            f"ota_impl must be one of {tuple(_OTA_IMPLS)}, got "
            f"{cfg.ota_impl!r}")
    return _OTA_IMPLS[cfg.ota_impl]


def make_ctx(cfg: TransportConfig, spec: AlgoSpec,
             device: DeviceLike = None) -> SlotCtx:
    """The SlotCtx of one transport slot: one trajectory (B = 1) at the
    full node count, mask `(1, N)`, counts `(1,)`, `n_sizes=(N,)` (the
    count-free K1 instantiation), with the config's antennas."""
    if spec.blind and cfg.n_antennas is None:
        raise ValueError(
            f"{spec.name!r} needs TransportConfig.n_antennas (the edge "
            "antenna count M)")
    dev = resolve_device(device)
    n = cfg.n_nodes
    ctx = SlotCtx(
        fading=cfg.channel.fading, p=_params_dict(cfg, dev),
        mask=torch.ones((1, n), dtype=torch.float32, device=dev),
        counts=torch.full((1,), n, dtype=torch.int64, device=dev),
        n_sizes=(n,), invert_channel=cfg.invert_channel, h_min=cfg.h_min,
        ota_impl=_resolve_ota_impl(cfg),
        phase_zero=(cfg.channel.phase_error_max == 0.0))
    return with_antennas(ctx, cfg.n_antennas, ())


def _flat_leaves(grads: PyTree, n: int) -> Tuple[list, list, list, Any]:
    """(the leaves as (N, size) views, their sizes, their shapes, the
    treedef)."""
    leaves, treedef = tree_flatten(grads)
    if not leaves:
        raise ValueError("aggregate() needs a non-empty gradient tree")
    for g in leaves:
        if g.dim() < 1 or g.shape[0] != n:
            raise ValueError(
                f"every gradient leaf needs a leading node axis of length "
                f"n_nodes={n}; got leaf shape {tuple(g.shape)}")
    flat = [g.reshape(n, -1) for g in leaves]
    return flat, [f.shape[1] for f in flat], \
        [tuple(g.shape[1:]) for g in leaves], treedef


def _block_ranges(sizes: list, block_d: Optional[int]) -> list:
    """(leaf_idx, lo, hi, flat_lo) column tiles; flat_lo is the leaf's
    offset in the concatenated D axis (the draw-stream coordinate)."""
    out, off = [], 0
    for li, sz in enumerate(sizes):
        width = sz if block_d is None else max(1, int(block_d))
        for lo in range(0, sz, width):
            out.append((li, lo, min(lo + width, sz), off))
        off += sz
    return out


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x²) in f32, by chunks of ENERGY_CHUNK values of the flattened
    leaf, the chunk sums added in order."""
    flat = x.reshape(-1)
    return sum(flat[i:i + ENERGY_CHUNK].to(torch.float32).square().sum()
               for i in range(0, flat.numel(), ENERGY_CHUNK))


def aggregate(
    algo: str,
    node_grads: PyTree,  # leaves (n_nodes, *shape): per-node local grads
    key: torch.Tensor,  # this slot's (2,) key (one per step: `step_key`)
    cfg: TransportConfig,
    state: Optional[dict] = None,
) -> Tuple[PyTree, Optional[dict], dict]:
    """One MAC slot over a gradient tree: `(update, new_state, aux)`.

    `update` is the received update v (or the momentum carry m for
    uses_gamma algorithms), an f32 tree shaped like one node's gradients,
    on their device. `state` must come from `init_state` for stateful
    algorithms (`has_state`) and comes back updated; stateless ones take
    and return None. `aux['tx_energy']` is the slot's transmitted energy
    E_N sum_n ||x_n||^2 of what the nodes send (after blind_ec's
    truncation, before any transmit-dtype cast), as the engine counts it.

    Any `block_d` gives the untiled values up to the f32 node sum's
    order (<= 1e-6; module docstring). An algorithm registered without a
    `hoist_draws` twin that draws cannot be tiled (its in-slot draws
    would repeat per block), so it runs as one FULL_CONCAT slot;
    `centralized` draws nothing and tiles.
    """
    spec = resolve(algo)
    n = cfg.n_nodes
    flat, sizes, shapes, treedef = _flat_leaves(node_grads, n)
    device = flat[0].device
    ctx = make_ctx(cfg, spec, device)
    key = key.to(device)
    total_d = sum(sizes)

    if spec.uses_gamma or spec.error_feedback:
        if state is None or (spec.uses_gamma and "m" not in state) \
                or (spec.error_feedback and "e" not in state):
            raise ValueError(
                f"{algo!r} carries transport state — pass "
                "transport.init_state(algo, params, cfg) and thread the "
                "returned state")
    new_state = dict(state) if state else None

    # ---- error feedback: residual add + power-budget truncation --------
    # alpha is a per-node GLOBAL norm over the full D vector, the one slot
    # quantity that is not per coordinate, so it is taken here across all
    # leaves before any block is sent (the engine's step: u = g + e;
    # alpha = min(1, sqrt(B / max(||u||^2, 1e-30))); x = alpha u;
    # e <- u - x)
    if spec.error_feedback:
        e_leaves, e_def = tree_flatten(state["e"])
        u = [f.to(torch.float32) + e.reshape(n, -1)
             for f, e in zip(flat, e_leaves)]
        sq = sum((x * x).sum(dim=1) for x in u)  # (n,)
        # a tensor numerator: `float / tensor` is a reciprocal and a
        # product in torch (two roundings), not one division
        budget = torch.full_like(sq, float(np.float32(cfg.power_budget)))
        alpha = torch.sqrt(budget / sq.clamp_min(1e-30)).clamp_max(1.0)
        tx = [alpha[:, None] * x for x in u]
        new_state["e"] = tree_unflatten(e_def, [
            (x - t).reshape(e.shape) for x, t, e in zip(u, tx, e_leaves)])
    else:
        tx = flat

    aux = {"tx_energy": cfg.channel.energy * sum(_square_sum(x)
                                                 for x in tx)}

    if cfg.transmit_dtype is not None and algo != "centralized":
        tx = [x.to(_dtype(cfg.transmit_dtype)) for x in tx]

    # ---- one full-D draw (the tiling enabler) --------------------------
    if spec.hoist_draws is not None:
        draws = spec.hoist_draws(key[None, None], ctx, n, total_d)
        ctx = dataclasses.replace(
            ctx, draws={k: v[0] for k, v in draws.items()})

    # ---- block-tiled slot evaluation -----------------------------------
    block_d = cfg.block_d
    if spec.hoist_draws is None and algo != "centralized":
        block_d = FULL_CONCAT  # random twin-less algo: one slot call
    keys = key[None]
    if block_d == FULL_CONCAT:
        g_full = tx[0] if len(tx) == 1 else torch.cat(tx, dim=1)
        v = slot_update_block(algo, g_full[None], keys, ctx, 0, total_d)
        parts = list(v[0].to(torch.float32).split(sizes))
    else:
        blocks = [[] for _ in sizes]
        for li, lo, hi, flat_lo in _block_ranges(sizes, block_d):
            v_blk = slot_update_block(algo, tx[li][None, :, lo:hi], keys,
                                      ctx, flat_lo + lo, flat_lo + hi)
            blocks[li].append(v_blk[0].to(torch.float32))
        parts = [bs[0] if len(bs) == 1 else torch.cat(bs) for bs in blocks]

    v_tree = tree_unflatten(
        treedef, [p.reshape(s) for p, s in zip(parts, shapes)])

    # ---- receiver momentum carry (engine: m <- gamma m + v, update m) ---
    if spec.uses_gamma:
        m_new = tree_map(lambda m, v_: cfg.gamma * m + v_, state["m"],
                         v_tree)
        new_state["m"] = m_new
        return m_new, new_state, aux
    return v_tree, new_state, aux
