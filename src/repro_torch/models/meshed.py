"""The dense decoder's training loss over a ("data", "model") or ("pod",
"data", "model") mesh: the mesh variant of `transformer.decoder_forward`
and `Model.train_loss_per_example`, with every per-entry loop of the
mesh path in this module (the unmeshed functions keep their code).

Parameters are `sharding.placement.Sharded` leaves laid out by the
reference's rules (`sharding.specs.param_spec`); activations are one
local tensor per mesh entry, the batch split over the batch axes
(`specs.data_axes`) and replicated over "model". Each layer runs on
each entry's shards:

  * the attention's q / k / v projections column-parallel over "model"
    (each model rank its heads: `n_heads / M` of them, and the kv heads
    they read), K2 on each entry's local heads through `attention.sdpa`
    (`flash_attention` with its lse under grad), `wo` row-parallel and
    the partial outputs summed over "model"; heads that do not divide
    the model axis run replicated on every rank, as the reference's
    `head_axis_for`;
  * the MLP's `wi` / `wg` column-parallel and `wo` row-parallel over
    "model" where the ffn dimension divides it, else replicated;
  * the embedding looked up on each rank's vocabulary rows and summed
    over "model", and the loss's log-sum-exp and gold logit combined
    over the vocabulary shards (`comm.vocab_parallel_xent`), as the
    reference's `shard(logits, data_axes(), None, tp_axis())` implies;
    a vocabulary the model axis does not divide stays whole.

A weight split over the batch axes (FSDP) is gathered inside its
layer, under the layer's recompute (`layers.remat`), so only one
layer's gathered weights are alive at a time: the counterpart of the
reference's per-layer `constrain_like_params`. Under
`use_dp_over_model` nothing is tensor-parallel and the batch spans
every axis.

The local per-op functions are the unmeshed ones (`attention.attn_apply`
with the local head counts, `layers.mlp_apply`, `layers.apply_norm`,
`transformer.embed_tokens`, `transformer.chunked_xent`), so windows,
softcaps, qk-norm, sandwich norms, the embedding scale and GQA groups
come along. Other families raise `NotImplementedError` (ROADMAP M12c).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, layer_slice, remat
from repro_torch.sharding import comm
from repro_torch.sharding.placement import Sharded, spec_axes


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh with the axes the step reads: `tp` the tensor-parallel axis
    ("model", or None under pure DP) and `batch_axes` the axes the batch
    and the MAC's nodes split over."""

    mesh: object
    tp: Optional[str]
    batch_axes: tuple

    @property
    def tp_size(self) -> int:
        return self.mesh.shape.get(self.tp, 1) if self.tp else 1

    def tp_rank(self, i: int) -> int:
        return self.mesh.coords(i)[self.tp] if self.tp else 0


def check_supported(cfg: ModelConfig) -> None:
    """The mesh path of this slice is the dense decoder's training loss."""
    if cfg.family != "dense" or cfg.n_experts or cfg.use_mla or cfg.mtp:
        raise NotImplementedError(
            f"training {cfg.arch_id} ({cfg.family}) on a mesh is ROADMAP "
            "M12c; the mesh path runs the dense decoder")


# ---------------------------------------------------------------------------
# weights in their compute layout
# ---------------------------------------------------------------------------
def local_weight(w: Optional[Sharded], lay: MeshLayout, *,
                 keep: Optional[int] = None, tp_region: bool = False):
    """Each entry's tensor of `w` for its computation: gathered over every
    axis of its spec but the model axis on dim `keep`. In a
    tensor-parallel region (`tp_region`: each model rank computes its own
    part) the gathered gradients are summed over the model ranks, and a
    weight replicated over "model" enters through `comm.copy_to`; in a
    replicated computation each model rank's gradient is whole already."""
    if w is None:
        return None
    xs = w.shards
    nd = len(w.shape)
    for d, entry in enumerate(w.spec):
        axes = spec_axes(entry)
        if not axes or (keep is not None and d == keep % nd
                        and entry == lay.tp):
            continue
        reduce_grad = tp_region or lay.tp not in axes
        xs = comm.all_gather(xs, lay.mesh, axes, d, reduce_grad)
    if tp_region and lay.tp and lay.tp not in w.used_axes():
        xs = comm.copy_to(xs, lay.mesh, (lay.tp,))
    return xs


def _kv_heads(cfg: ModelConfig, m: int, rank: int) -> list:
    """The kv head each of model rank `rank`'s q heads reads."""
    hl = cfg.n_heads // m
    group = cfg.n_heads // cfg.n_kv_heads
    return [(rank * hl + j) // group for j in range(hl)]


def _kv_columns(w: torch.Tensor, heads: list, hd: int) -> tuple:
    """(w's columns for the kv heads `heads` reads, their count): the
    contiguous range where the q heads' groups stay regular, else one
    column block per q head (the reference's repeat to q's width)."""
    lo, hi = heads[0], heads[-1] + 1
    n = hi - lo
    per = len(heads) // n
    if len(heads) % n == 0 and heads == [lo + j // per
                                         for j in range(len(heads))]:
        return w[..., lo * hd:hi * hd], n
    return torch.cat([w[..., h * hd:(h + 1) * hd] for h in heads], -1), \
        len(heads)


# ---------------------------------------------------------------------------
# sublayers
# ---------------------------------------------------------------------------
def _attention(hs: list, p: dict, cfg: ModelConfig, lay: MeshLayout, *,
               positions: list, window, impl: str) -> list:
    m = lay.tp_size
    tp = lay.tp is not None and cfg.n_heads % m == 0
    if not tp:  # heads replicated (or pure DP): the whole attention
        w = {k: local_weight(v, lay) for k, v in p.items()}
        return [attn_mod.attn_apply(
            hs[i], {k: v[i] for k, v in w.items()}, cfg,
            positions=positions[i], window=window, impl=impl)[0]
            for i in range(len(hs))]
    hs = comm.copy_to(hs, lay.mesh, (lay.tp,))
    wq = local_weight(p["wq"], lay, keep=-1, tp_region=True)
    wo = local_weight(p["wo"], lay, keep=-2, tp_region=True)
    norms = {k: local_weight(p[k], lay, tp_region=True)
             for k in ("q_norm", "k_norm") if k in p}
    kv_split = cfg.n_kv_heads % m == 0
    kv = {k: local_weight(p[k], lay, keep=-1 if kv_split else None,
                          tp_region=True) for k in ("wk", "wv")}
    outs = []
    for i in range(len(hs)):
        local = {"wq": wq[i], "wo": wo[i], **{k: v[i]
                                              for k, v in norms.items()}}
        if kv_split:
            n_kv = cfg.n_kv_heads // m
            local.update(wk=kv["wk"][i], wv=kv["wv"][i])
        else:
            heads = _kv_heads(cfg, m, lay.tp_rank(i))
            local["wk"], n_kv = _kv_columns(kv["wk"][i], heads, cfg.head_dim)
            local["wv"], _ = _kv_columns(kv["wv"][i], heads, cfg.head_dim)
        lcfg = cfg.with_(n_heads=cfg.n_heads // m, n_kv_heads=n_kv)
        outs.append(attn_mod.attn_apply(hs[i], local, lcfg,
                                        positions=positions[i],
                                        window=window, impl=impl)[0])
    return comm.all_reduce(outs, lay.mesh, (lay.tp,))


def _mlp(hs: list, p: dict, cfg: ModelConfig, lay: MeshLayout) -> list:
    tp = lay.tp is not None and p["wi"].spec[-1] == lay.tp
    if not tp:
        w = {k: local_weight(v, lay) for k, v in p.items()}
        return [layers.mlp_apply(hs[i], {k: v[i] for k, v in w.items()}, cfg)
                for i in range(len(hs))]
    hs = comm.copy_to(hs, lay.mesh, (lay.tp,))
    w = {k: local_weight(v, lay, keep=-2 if k == "wo" else -1,
                         tp_region=True) for k, v in p.items()}
    outs = [layers.mlp_apply(hs[i], {k: v[i] for k, v in w.items()}, cfg)
            for i in range(len(hs))]
    return comm.all_reduce(outs, lay.mesh, (lay.tp,))


def _norm(xs: list, p: Optional[Sharded], cfg: ModelConfig,
          lay: MeshLayout) -> list:
    scale = local_weight(p, lay)
    return [apply_norm(x, None if scale is None else scale[i], cfg)
            for i, x in enumerate(xs)]


def _sublayer(xs: list, sp: dict, window, cfg: ModelConfig,
              lay: MeshLayout, positions: list, impl: str) -> list:
    """One dense decoder layer on every entry (`transformer.
    sublayer_apply`'s dense path)."""
    a = _attention(_norm(xs, sp.get("ln1"), cfg, lay), sp["attn"], cfg, lay,
                   positions=positions, window=window, impl=impl)
    if cfg.norm_style == "sandwich":
        a = _norm(a, sp.get("post_ln1"), cfg, lay)
    xs = [x + y for x, y in zip(xs, a)]
    m = _mlp(_norm(xs, sp.get("ln2"), cfg, lay), sp["mlp"], cfg, lay)
    if cfg.norm_style == "sandwich":
        m = _norm(m, sp.get("post_ln2"), cfg, lay)
    return [x + y for x, y in zip(xs, m)]


def decoder_forward(params: dict, xs: list, cfg: ModelConfig,
                    lay: MeshLayout, *, impl: str = "auto") -> list:
    """Embedded inputs (one (B_l, S, D) tensor an entry) -> the final-normed
    hidden states, each layer under `layers.remat` with its FSDP gathers
    inside."""
    positions = [torch.arange(x.shape[1], device=x.device) for x in xs]

    def seg_step(xs, sp, subs):
        for j, sub in enumerate(subs):
            xs = _sublayer(xs, sp[f"sub{j}"], sub.window, cfg, lay,
                           positions, impl)
        return xs

    for i, seg in enumerate(tfm.build_segments(cfg)):
        seg_params = params["segments"][f"seg{i}"]
        for step in range(seg.n_steps):
            xs = remat(cfg, seg_step, xs, layer_slice(seg_params, step),
                       seg.subs)
    return _norm(xs, params.get("final_norm"), cfg, lay)


# ---------------------------------------------------------------------------
# embedding and loss
# ---------------------------------------------------------------------------
def _embedding_dtype(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """`transformer.embed_tokens` after its lookup: the activation dtype,
    times the embedding scale rounded to it first."""
    x = x.to(layers.dtype_of(cfg))
    if cfg.embed_scale:
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def embed_tokens(params: dict, tokens: list, cfg: ModelConfig,
                 lay: MeshLayout) -> list:
    """Each entry's embedded tokens: on each model rank's vocabulary rows
    (the others zero) summed over "model" when the embedding is split
    over the vocabulary, else through the whole table."""
    e = params["embed"]
    if lay.tp is not None and e.spec[0] == lay.tp:
        return [_embedding_dtype(x, cfg) for x in
                comm.vocab_parallel_embedding(e.shards, tokens, lay.mesh,
                                              lay.tp)]
    table = local_weight(e, lay)
    return [tfm.embed_tokens({"embed": table[i]}, tok, cfg)
            for i, tok in enumerate(tokens)]


def _vocab_parallel_xent(w: list, hs: list, labels: list, cfg: ModelConfig,
                         lay: MeshLayout, tied: bool) -> list:
    """`transformer.chunked_xent` over vocabulary shards: each chunk's
    local logits, their cross-entropy combined over "model", each chunk
    recomputed in the backward."""
    hs = comm.copy_to(hs, lay.mesh, (lay.tp,))
    b, s, _ = hs[0].shape
    chunk = min(cfg.logit_chunk, s)

    def step(w, hc, lc):
        logits = []
        for i, h in enumerate(hc):
            wi = w[i].T if tied else w[i]
            z = layers.matmul(h, wi).float()
            if cfg.final_softcap is not None:
                z = cfg.final_softcap * torch.tanh(z / cfg.final_softcap)
            logits.append(z)
        nll = comm.vocab_parallel_xent(logits, lc, lay.mesh, lay.tp)
        return [torch.sum(x, dim=-1) for x in nll]

    tot = [torch.zeros((b,), dtype=torch.float32, device=h.device)
           for h in hs]
    for lo in range(0, s, chunk):
        cols = slice(lo, lo + chunk)
        part = checkpoint(step, w, [h[:, cols] for h in hs],
                          [lab[:, cols] for lab in labels],
                          use_reentrant=False)
        tot = [t + p for t, p in zip(tot, part)]
    return [t / torch.full_like(t, float(s)) for t in tot]


def train_losses(model, params: dict, tokens: list,
                 lay: MeshLayout) -> list:
    """Each entry's per-example losses (B_l,) of next-token prediction on
    its tokens (B_l, S + 1): `Model.train_loss_per_example` on a mesh."""
    cfg = model.cfg
    check_supported(cfg)
    inputs = [t[:, :-1] for t in tokens]
    labels = [t[:, 1:] for t in tokens]
    hs = decoder_forward(params, embed_tokens(params, inputs, cfg, lay),
                         cfg, lay, impl=model.impl)
    key = "embed" if cfg.tie_embeddings else "lm_head"
    w = params[key]
    vocab_dim = 0 if cfg.tie_embeddings else -1
    if lay.tp is not None and w.spec[vocab_dim] == lay.tp:
        return _vocab_parallel_xent(w.shards, hs, labels, cfg, lay,
                                    cfg.tie_embeddings)
    table = local_weight(w, lay)
    return [tfm.chunked_xent({key: table[i]}, h, lab,
                             torch.ones_like(lab), cfg)
            for i, (h, lab) in enumerate(zip(hs, labels))]
