"""The dense decoder over a ("data", "model") or ("pod", "data",
"model") mesh: its training loss (ROADMAP M12a) and its serving,
prefill and decode on placed KV caches (M12b); the mesh variant of
`transformer.decoder_forward`, `Model.train_loss_per_example`,
`Model.prefill` and `Model.decode_step`, with every per-entry loop of
the mesh path in this module (the unmeshed functions keep their code).

Parameters are `sharding.placement.Sharded` leaves laid out by the
reference's rules (`sharding.specs.param_spec`); activations are one
local tensor per mesh entry, the batch split over the batch axes
(`specs.data_axes`; replicated where it does not divide, in serving)
and replicated over "model". Each layer runs on each entry's shards:

  * the attention (`head_layout`): where the heads divide the model
    axis, q / k / v projected column-parallel (each model rank its
    `n_heads / M` heads and the kv heads they read), K2 on each entry's
    local heads through `attention.sdpa` (`flash_attention` with its lse
    under grad), `wo` row-parallel and the partial outputs summed over
    "model". Heads that do not divide it run replicated on every rank,
    as the reference's `head_axis_for`, or under `opt_pad_heads` are
    padded as the reference pads them (`attention.py:346-362`): k and v
    repeated to q's width, q / k / v zero-padded to the next multiple of
    M, each rank K2 on its (H + pad) / M heads, the padded heads dropped
    before `wo` and the ranks' partial outputs summed;
  * the MLP's `wi` / `wg` column-parallel and `wo` row-parallel over
    "model" where the ffn dimension divides it, else replicated;
  * the embedding looked up on each rank's vocabulary rows and summed
    over "model", and the loss's log-sum-exp and gold logit combined
    over the vocabulary shards (`comm.vocab_parallel_xent`), as the
    reference's `shard(logits, data_axes(), None, tp_axis())` implies;
    serving's last-position logits computed on each rank's vocabulary
    columns and gathered; a vocabulary the model axis does not divide
    stays whole.

A weight split over the batch axes (FSDP) is gathered inside its
layer (under the layer's recompute, `layers.remat`, in training), so
only one layer's gathered weights are alive at a time: the counterpart
of the reference's per-layer `constrain_like_params`. Under
`use_dp_over_model` nothing is tensor-parallel and the batch spans
every axis.

Serving keeps each KV cache leaf placed by the reference's
`cache_spec` (`placement.cache_zeros`): each entry's block, updated in
place. A prefill writes each entry's keys and values into its block
(key p in slot p mod cache_len, F14). A decode step on a cache whose
heads lie over "model" runs each entry's heads column-parallel, as the
prefill. On a cache split on head_dim (kv heads that do not divide M,
the reference's "decode scores contract it with a psum") every entry
computes the whole token's q, k and v (RoPE and qk-norm read the whole
head; an int8 scale is the max over the whole head), writes its
columns, takes its partial scores on them, and the scores are summed
over "model" in rank order, then scaled, softcapped, masked and
softmaxed; each entry's p·v on its columns is gathered over "model"
before `wo`. Where q's heads divide M but the cache is split on
head_dim (2 kv heads over 4 ranks) decode takes this layout too: the
cache decides which keys each entry holds, and moving a token's q
(B × H × d values) costs less than moving the cache's keys.

The local per-op functions are the unmeshed ones
(`attention.project_qkv`, `sdpa`, `write_prefill`, `cache_write`,
`decode_scores`, `decode_probs`, `layers.mlp_apply`,
`layers.apply_norm`, `transformer.embed_tokens`,
`transformer.chunked_xent`), so windows, softcaps, qk-norm, sandwich
norms, the embedding scale, GQA groups and the int8 cache come along.
Other families raise `NotImplementedError` (ROADMAP M12c).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, layer_slice, remat
from repro_torch.sharding import comm, placement, specs
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

    @staticmethod
    def of(mesh) -> "MeshLayout":
        """The layout the current switches give `mesh`."""
        return MeshLayout(mesh, specs.tp_axis(), specs.data_axes(mesh))


def check_supported(cfg: ModelConfig, what: str = "training") -> None:
    """The mesh path runs the dense decoder (`what`: "training" or
    "serving", for the message)."""
    if cfg.family != "dense" or cfg.n_experts or cfg.use_mla or cfg.mtp:
        raise NotImplementedError(
            f"{what} {cfg.arch_id} ({cfg.family}) on a mesh is ROADMAP "
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


def _select_kv(k: torch.Tensor, v: torch.Tensor, heads: list) -> tuple:
    """(k, v (B, Hkv, S, d) at the kv heads `heads` reads, their count):
    the contiguous range where the q heads' groups stay regular, else one
    head per q head (the reference's repeat to q's width)."""
    lo, hi = heads[0], heads[-1] + 1
    n = hi - lo
    per = len(heads) // n
    if len(heads) % n == 0 and heads == [lo + j // per
                                         for j in range(len(heads))]:
        return k[:, lo:hi], v[:, lo:hi], n
    idx = torch.tensor(heads, device=k.device)
    return k.index_select(1, idx), v.index_select(1, idx), len(heads)


def head_layout(cfg: ModelConfig, lay: MeshLayout) -> str:
    """How the attention's heads lie over the model axis: "split" (each
    rank n_heads / M of them), "pad" (they do not divide it and
    `opt_pad_heads` pads them) or "whole" (every rank all of them: they
    do not divide it, or pure DP)."""
    if lay.tp is None:
        return "whole"
    if cfg.n_heads % lay.tp_size == 0:
        return "split"
    return "pad" if cfg.opt_pad_heads else "whole"


def _cache_blocks(kv: dict) -> list:
    """Each entry's (block of one layer's placed cache, the head_dim
    columns it holds). Its kv heads are the ones the entry computes: its
    own where the cache's heads lie over "model" (they then divide it, as
    the q heads and the k / v weights' columns do), else all of them (the
    cache's heads whole)."""
    return [({n: x.shards[i] for n, x in kv.items()}, kv["k"].box(i)[3])
            for i in range(kv["k"].mesh.size)]


# ---------------------------------------------------------------------------
# sublayers
# ---------------------------------------------------------------------------
def _attention(hs: list, p: dict, cfg: ModelConfig, lay: MeshLayout, *,
               positions: list, window, impl: str,
               kv: Optional[dict] = None) -> list:
    """The attention sublayer of a training forward or a prefill on every
    entry (`head_layout`); a prefill writes each entry's keys and values
    into its block of the layer's placed cache `kv`."""
    mode = head_layout(cfg, lay)
    m = lay.tp_size
    tp, split = mode != "whole", mode == "split"
    kv_split = split and cfg.n_kv_heads % m == 0
    if tp:
        hs = comm.copy_to(hs, lay.mesh, (lay.tp,))
    w = {"wq": local_weight(p["wq"], lay, keep=-1 if split else None,
                            tp_region=tp),
         "wo": local_weight(p["wo"], lay, keep=-2 if split else None,
                            tp_region=tp)}
    for k in ("wk", "wv"):
        w[k] = local_weight(p[k], lay, keep=-1 if kv_split else None,
                            tp_region=tp)
    for k in ("q_norm", "k_norm"):
        if k in p:
            w[k] = local_weight(p[k], lay, tp_region=tp)
    lcfg = cfg.with_(
        n_heads=cfg.n_heads // m if split else cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads // m if kv_split else cfg.n_kv_heads)
    blocks = None if kv is None else _cache_blocks(kv)
    outs = []
    for i in range(len(hs)):
        q, k, v = attn_mod.project_qkv(hs[i], {n: t[i] for n, t in w.items()},
                                       lcfg, positions[i])
        if blocks is not None:
            block, cols = blocks[i]
            attn_mod.write_prefill(block, k, v, positions[i], cols)
        wo = w["wo"][i]
        if mode == "pad":
            q, k, v, wo = _padded_heads(q, k, v, wo, cfg, m, lay.tp_rank(i))
            acfg = cfg.with_(n_heads=q.shape[1], n_kv_heads=q.shape[1])
        elif split and not kv_split:
            k, v, n = _select_kv(k, v, _kv_heads(cfg, m, lay.tp_rank(i)))
            acfg = lcfg.with_(n_kv_heads=n)
        else:
            acfg = lcfg
        out = attn_mod.sdpa(q, k, v, acfg, window=window, impl=impl)
        b, s = out.shape[0], out.shape[2]
        real = wo.shape[0] // cfg.head_dim
        out = out[:, :real].transpose(1, 2).reshape(b, s, wo.shape[0])
        outs.append(layers.matmul(out, wo))
    return comm.all_reduce(outs, lay.mesh, (lay.tp,)) if tp else outs


def _padded_heads(q, k, v, wo, cfg: ModelConfig, m: int, rank: int) -> tuple:
    """Model rank `rank`'s heads of the reference's padded attention: of
    the n_heads + pad heads (pad = -n_heads mod m), its (n_heads + pad) /
    m, q and k, v repeated to q's width, the padded ones zero; and the
    rows of the whole `wo` for its real heads, through which only those
    reach the output."""
    per = (cfg.n_heads + (-cfg.n_heads % m)) // m
    lo = rank * per
    hi = min(lo + per, cfg.n_heads)
    group = cfg.n_heads // cfg.n_kv_heads
    idx = torch.tensor([h // group for h in range(lo, hi)], dtype=torch.long,
                       device=k.device)
    pad = (0, 0, 0, 0, 0, per - max(hi - lo, 0))
    q = F.pad(q[:, lo:hi], pad)
    k = F.pad(k.index_select(1, idx), pad)
    v = F.pad(v.index_select(1, idx), pad)
    return q, k, v, wo[lo * cfg.head_dim:max(hi, lo) * cfg.head_dim]


def _decode_attention(hs: list, p: dict, cfg: ModelConfig,
                      lay: MeshLayout, *, positions: list, pos: int,
                      window, kv: dict) -> list:
    """The attention sublayer of a decode step on every entry, on the
    layer's placed cache `kv`: column-parallel where its heads lie over
    "model" (`_decode_attention_by_heads`); otherwise each entry computes
    the token's whole q, k and v, writes its head_dim columns into its
    block, and the partial scores on them are summed over the cache's
    column axes in rank order, each entry's p·v on its columns gathered
    over them before `wo`."""
    kspec = kv["k"].spec  # (B, Hkv, S, d)
    if lay.tp is not None and kspec[1] == lay.tp:
        return _decode_attention_by_heads(hs, p, cfg, lay,
                                          positions=positions, pos=pos,
                                          window=window, kv=kv)
    w = {k: local_weight(t, lay) for k, t in p.items()}
    col_axes = spec_axes(kspec[3])
    blocks = _cache_blocks(kv)
    parts = []
    for i, (block, cols) in enumerate(blocks):
        q, k, v = attn_mod.project_qkv(hs[i], {n: t[i] for n, t in w.items()},
                                       cfg, positions[i])
        attn_mod.cache_write(block, k, v, pos, cols)
        parts.append(attn_mod.decode_scores(q[..., cols], block))
    scores = comm.reduce(parts, lay.mesh, col_axes)
    outs = []
    for i, (block, _) in enumerate(blocks):
        prob = attn_mod.decode_probs(scores[i], block["pos_ids"], pos, cfg,
                                     window)
        outs.append(torch.einsum("bhgs,bhsd->bhgd", prob,
                                 attn_mod.cache_kv(block, "v")))
    outs = comm.gather(outs, lay.mesh, col_axes, -1)
    b = hs[0].shape[0]
    return [layers.matmul(o.reshape(b, 1, cfg.q_dim).to(hs[i].dtype),
                          w["wo"][i]) for i, o in enumerate(outs)]


def _decode_attention_by_heads(hs: list, p: dict, cfg: ModelConfig,
                               lay: MeshLayout, *, positions: list, pos: int,
                               window, kv: dict) -> list:
    """A decode step whose cache's heads lie over "model": each model
    rank's q, k, v heads column-parallel, the token written into its
    block, `attention.decode_attention` on it, `wo` row-parallel and the
    partial outputs summed over "model"."""
    m = lay.tp_size
    w = {"wq": local_weight(p["wq"], lay, keep=-1),
         "wk": local_weight(p["wk"], lay, keep=-1),
         "wv": local_weight(p["wv"], lay, keep=-1),
         "wo": local_weight(p["wo"], lay, keep=-2)}
    for k in ("q_norm", "k_norm"):
        if k in p:
            w[k] = local_weight(p[k], lay)
    lcfg = cfg.with_(n_heads=cfg.n_heads // m,
                     n_kv_heads=cfg.n_kv_heads // m)
    outs = []
    for i, (block, _) in enumerate(_cache_blocks(kv)):
        q, k, v = attn_mod.project_qkv(hs[i], {n: t[i] for n, t in w.items()},
                                       lcfg, positions[i])
        attn_mod.cache_write(block, k, v, pos)
        out = attn_mod.decode_attention(q, block, pos, lcfg, window=window)
        b = out.shape[0]
        outs.append(layers.matmul(out.transpose(1, 2).reshape(b, 1,
                                                              lcfg.q_dim),
                                  w["wo"][i]))
    return comm.reduce(outs, lay.mesh, (lay.tp,))


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
              lay: MeshLayout, positions: list, impl: str,
              kv: Optional[dict] = None,
              decode_pos: Optional[int] = None) -> list:
    """One dense decoder layer on every entry (`transformer.
    sublayer_apply`'s dense path); with the layer's placed cache `kv`, a
    prefill into it or (with `decode_pos`) a decode step on it."""
    h = _norm(xs, sp.get("ln1"), cfg, lay)
    if decode_pos is not None:
        a = _decode_attention(h, sp["attn"], cfg, lay, positions=positions,
                              pos=decode_pos, window=window, kv=kv)
    else:
        a = _attention(h, sp["attn"], cfg, lay, positions=positions,
                       window=window, impl=impl, kv=kv)
    if cfg.norm_style == "sandwich":
        a = _norm(a, sp.get("post_ln1"), cfg, lay)
    xs = [x + y for x, y in zip(xs, a)]
    m = _mlp(_norm(xs, sp.get("ln2"), cfg, lay), sp["mlp"], cfg, lay)
    if cfg.norm_style == "sandwich":
        m = _norm(m, sp.get("post_ln2"), cfg, lay)
    return [x + y for x, y in zip(xs, m)]


def decoder_forward(params: dict, xs: list, cfg: ModelConfig,
                    lay: MeshLayout, *, impl: str = "auto",
                    cache: Optional[dict] = None,
                    decode_pos: Optional[int] = None) -> list:
    """Embedded inputs (one (B_l, S, D) tensor an entry) -> the final-normed
    hidden states, each layer under `layers.remat` with its FSDP gathers
    inside. With a placed cache (`placement.cache_zeros`'s tree) a
    prefill writes it, or with `decode_pos` one token decodes on it, in
    place."""
    if decode_pos is None:
        positions = [torch.arange(x.shape[1], device=x.device) for x in xs]
    else:
        positions = [torch.full((1,), decode_pos, device=x.device)
                     for x in xs]

    def seg_step(xs, sp, sc, subs):
        for j, sub in enumerate(subs):
            xs = _sublayer(xs, sp[f"sub{j}"], sub.window, cfg, lay,
                           positions, impl,
                           None if sc is None else sc[f"sub{j}"]["kv"],
                           decode_pos)
        return xs

    for i, seg in enumerate(tfm.build_segments(cfg)):
        seg_params = params["segments"][f"seg{i}"]
        seg_cache = None if cache is None else cache[f"seg{i}"]
        for step in range(seg.n_steps):
            xs = remat(cfg, seg_step, xs, layer_slice(seg_params, step),
                       layer_slice(seg_cache, step), seg.subs)
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


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _last_logits(params: dict, hs: list, cfg: ModelConfig,
                 lay: MeshLayout) -> list:
    """Each entry's f32 logits (B_l, V) of its last position
    (`transformer.logits_fn`): on its model rank's vocabulary columns,
    gathered over "model", where the unembedding is split over the
    vocabulary; else through the whole table."""
    key = "embed" if cfg.tie_embeddings else "lm_head"
    w = params[key]
    split = lay.tp is not None and \
        w.spec[0 if cfg.tie_embeddings else -1] == lay.tp
    table = w.shards if split else local_weight(w, lay)
    out = [tfm.logits_fn({key: table[i]}, h[:, -1], cfg)
           for i, h in enumerate(hs)]
    return comm.gather(out, lay.mesh, (lay.tp,), -1) if split else out


def init_cache(model, batch: int, cache_len: int, mesh) -> dict:
    """`Model.init_cache` on a mesh: the decoder's KV cache tree, each
    leaf a `Sharded` placed by the reference's `cache_spec`, each
    entry's block allocated on its device."""
    check_supported(model.cfg, "serving")
    meta = tfm.init_decoder_cache(batch, cache_len, model.cfg,
                                  device="meta")
    return placement.cache_zeros(meta, mesh)


@torch.no_grad()
def prefill(model, params: dict, batch: dict, max_len: Optional[int],
            mesh) -> tuple:
    """`Model.prefill` on a mesh: the prompt's rows placed by the batch
    rule (`placement.split_rows`), every layer on each entry's shards
    writing each entry's cache block. Returns (the global last-position
    logits (B, V) f32 on the first entry's device, the placed cache)."""
    cfg = model.cfg
    lay = MeshLayout.of(mesh)
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = init_cache(model, b, max(max_len or 0, s), mesh)
    xs = embed_tokens(params, placement.split_rows(tokens, mesh), cfg, lay)
    hs = decoder_forward(params, xs, cfg, lay, impl=model.impl, cache=cache)
    return placement.gather_rows(_last_logits(params, hs, cfg, lay), mesh,
                                 b), cache


@torch.no_grad()
def decode_step(model, params: dict, cache: dict, token: torch.Tensor,
                pos: int, mesh) -> tuple:
    """`Model.decode_step` on a mesh: token (B,) placed by the batch
    rule, each entry's block of `cache` updated in place. Returns (the
    global logits (B, V) f32 on the first entry's device, the cache)."""
    cfg = model.cfg
    check_supported(cfg, "serving")
    lay = MeshLayout.of(mesh)
    toks = [t[:, None] for t in placement.split_rows(token, mesh)]
    xs = embed_tokens(params, toks, cfg, lay)
    hs = decoder_forward(params, xs, cfg, lay, impl=model.impl, cache=cache,
                         decode_pos=int(pos))
    return placement.gather_rows(_last_logits(params, hs, cfg, lay), mesh,
                                 token.shape[0]), cache
