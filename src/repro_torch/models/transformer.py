"""Dense decoder-only transformer stack (port of the dense part of
`repro.models.transformer`).

Parameters keep the reference's nested layout — `segments/seg0/sub0/...`
with every per-layer leaf stacked on a leading layer dimension — so the
names map one to one (`models.convert`). The reference scans over that
dimension; the port loops over it in Python, slicing each layer's
weights and KV cache as views. A segment's step runs its sublayers in
order: gemma2's `alt_local_global` pattern is one segment of
n_layers // 2 steps whose sub0 attends over the sliding window and sub1
globally, each with its own stacked parameters and KV cache.

The slice is the dense decoder with its windows, softcaps, sandwich
norms, embedding scale and qk-norm (S2), the int8 cache (S3), the VLM
backbone (patch embeddings prepended by `models.model`), whisper's
decoder with its cross-attention over the encoder states (S7), MoE
sublayers (S4: `models.moe`) and MLA attention with deepseek-v3's MTP
block (S5: `models.mla`). The MoE stacks take the reference's three
layouts: deepseek-v3's leading dense segment then an MoE segment,
llama4's (local dense, global MoE) pairs, and all-MoE stacks. An MoE
sublayer returns its router's aux loss, which `decoder_forward` sums
over the stack (0 without MoE layers).

Training (`decoder_forward` under autograd) recomputes each segment
step in the backward when `cfg.remat` is set, as the reference's
`jax.checkpoint` around its scan body (`layers.remat`): the backward
keeps each step's input and runs the step's forward again, so each
layer's kernels launch twice a training step. `chunked_xent` recomputes
each logits chunk, as the reference's does.
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
from repro_torch.models import layers, mla as mla_mod, moe as moe_mod
from repro_torch.models.layers import (apply_norm, dtype_of, embed_init,
                                       layer_slice, norm_param, remat)


@dataclasses.dataclass(frozen=True)
class SubLayer:
    kind: str  # 'dense' | 'moe'
    window: Optional[int]  # sliding window (None = global)


@dataclasses.dataclass(frozen=True)
class Segment:
    n_steps: int
    subs: tuple


def build_segments(cfg: ModelConfig) -> tuple:
    if cfg.n_experts and cfg.first_dense_layers:
        # deepseek-v3: leading dense layers, then a homogeneous MoE stack
        return (Segment(cfg.first_dense_layers, (SubLayer("dense", None),)),
                Segment(cfg.n_layers - cfg.first_dense_layers,
                        (SubLayer("moe", None),)))
    if cfg.n_experts and cfg.moe_layer_step == 2:
        # llama4: alternating (local dense, global MoE) pairs
        return (Segment(cfg.n_layers // 2,
                        (SubLayer("dense", cfg.sliding_window),
                         SubLayer("moe", None))),)
    if cfg.n_experts:
        return (Segment(cfg.n_layers, (SubLayer("moe", None),)),)
    if cfg.layer_pattern == "alt_local_global":
        # gemma2: local, global, local, ...
        return (Segment(cfg.n_layers // 2,
                        (SubLayer("dense", cfg.sliding_window),
                         SubLayer("dense", None))),)
    window = cfg.sliding_window if cfg.layer_pattern == "all_local" \
        else None
    return (Segment(cfg.n_layers, (SubLayer("dense", window),)),)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def sublayer_params(gen: torch.Generator, cfg: ModelConfig, lead=(),
                    cross_attn: bool = False, kind: str = "dense") -> dict:
    p = {"ln1": norm_param(cfg, *lead, device=gen.device),
         "ln2": norm_param(cfg, *lead, device=gen.device),
         "attn": (mla_mod.mla_params if cfg.use_mla
                  else attn_mod.attention_params)(gen, cfg, lead=lead)}
    if kind == "moe":
        p["moe"] = moe_mod.moe_params(gen, cfg, lead=lead)
    else:
        p["mlp"] = layers.mlp_params(gen, cfg, lead=lead)
    if cfg.norm_style == "sandwich":
        p["post_ln1"] = norm_param(cfg, *lead, device=gen.device)
        p["post_ln2"] = norm_param(cfg, *lead, device=gen.device)
    if cross_attn:  # whisper's decoder attends over the encoder states
        p["xattn"] = attn_mod.attention_params(gen, cfg, lead=lead)
        p["ln_x"] = norm_param(cfg, *lead, device=gen.device)
        if cfg.norm_style == "sandwich":
            p["post_ln_x"] = norm_param(cfg, *lead, device=gen.device)
    return p


def init_decoder(gen: torch.Generator, cfg: ModelConfig,
                 cross_attn: bool = False) -> dict:
    """Random parameters on `gen`'s device, in the reference's layout;
    with `cross_attn`, each sublayer also has its cross-attention; with
    `cfg.mtp`, deepseek-v3's MTP head (`mtp`: the projection of [h, e],
    one dense sublayer, two norms), which only the training loss reads."""
    segs = build_segments(cfg)
    dt = dtype_of(cfg)
    params: dict = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt),
        "final_norm": norm_param(cfg, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(
            gen, cfg.d_model, (cfg.d_model, cfg.vocab_size), dt)
    params["segments"] = {
        f"seg{i}": {f"sub{j}": sublayer_params(gen, cfg, lead=(seg.n_steps,),
                                               cross_attn=cross_attn,
                                               kind=sub.kind)
                    for j, sub in enumerate(seg.subs)}
        for i, seg in enumerate(segs)}
    if cfg.mtp:
        params["mtp"] = {
            "proj": layers.dense_init(gen, 2 * cfg.d_model,
                                      (2 * cfg.d_model, cfg.d_model), dt),
            "block": sublayer_params(gen, cfg),
            "norm_h": norm_param(cfg, device=gen.device),
            "norm_e": norm_param(cfg, device=gen.device),
        }
    return params


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------
def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The embedding rows in the activation dtype; with `embed_scale`,
    times sqrt(d_model) rounded to that dtype first, as the reference's
    `jnp.asarray(sqrt(d), x.dtype)` (in bf16, sqrt(3584) = 59.87 becomes
    59.75, and the product rounds once)."""
    x = params["embed"][tokens].to(dtype_of(cfg))
    if cfg.embed_scale:
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def logits_fn(params: dict, h: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """f32 logits, capped by the config's `final_softcap` (in f32)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = layers.matmul(h, w).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def chunked_xent(params: dict, h: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Per-example mean cross-entropy (B,), computed in sequence chunks
    of `cfg.logit_chunk` so the full (B, S, vocab) f32 logits are never
    held. Each chunk runs under `torch.utils.checkpoint`: the backward
    recomputes its logits instead of keeping the (B, chunk, V) softmax
    residuals of every chunk, as the reference's `jax.checkpoint`."""
    b, s, _ = h.shape
    chunk = min(cfg.logit_chunk, s)
    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))

    def step(hs, ls, ms):
        logits = logits_fn(params, hs, cfg)  # (B, chunk, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ls.long()[..., None])[..., 0]
        return torch.sum((lse - gold) * ms, dim=-1)

    tot = torch.zeros((b,), dtype=torch.float32, device=h.device)
    for lo in range(0, s + pad, chunk):
        cols = slice(lo, lo + chunk)
        tot = tot + checkpoint(step, h[:, cols], labels[:, cols],
                               mask[:, cols], use_reentrant=False)
    return tot / torch.clamp_min(torch.sum(mask, dim=-1).float(), 1.0)


# ---------------------------------------------------------------------------
# sublayer / stack forward
# ---------------------------------------------------------------------------
def sublayer_apply(x: torch.Tensor, sp: dict, sub: SubLayer,
                   cfg: ModelConfig, *, positions: torch.Tensor,
                   cache: Optional[dict] = None,
                   decode_pos: Optional[int] = None,
                   enc_out: Optional[torch.Tensor] = None,
                   impl: str = "auto") -> tuple:
    """One decoder layer -> (x, aux): attention over `sub.window` (MLA
    under `cfg.use_mla`); whisper's cross-attention when the layer has
    one; then the MLP, or the MoE layer whose router's aux loss it
    returns (None for a dense layer), each followed by its post norm
    under `norm_style == "sandwich"`. Its KV cache, when given, is
    updated in place."""
    h = apply_norm(x, sp["ln1"], cfg)
    kv = None if cache is None else cache["kv"]
    if cfg.use_mla:
        a, _ = mla_mod.mla_apply(h, sp["attn"], cfg, positions=positions,
                                 cache=kv, decode_pos=decode_pos)
    else:
        a, _ = attn_mod.attn_apply(
            h, sp["attn"], cfg, positions=positions, window=sub.window,
            cache=kv, decode_pos=decode_pos, impl=impl)
    if cfg.norm_style == "sandwich":
        a = apply_norm(a, sp["post_ln1"], cfg)
    x = x + a
    if "xattn" in sp:
        h = apply_norm(x, sp["ln_x"], cfg)
        xa = cross_attn(h, sp["xattn"], cfg, enc_out=enc_out, cache=cache)
        if cfg.norm_style == "sandwich":
            xa = apply_norm(xa, sp["post_ln_x"], cfg)
        x = x + xa
    h = apply_norm(x, sp["ln2"], cfg)
    if sub.kind == "moe":
        m, aux = moe_mod.moe_apply(h, sp["moe"], cfg)
    else:
        m, aux = layers.mlp_apply(h, sp["mlp"], cfg), None
    if cfg.norm_style == "sandwich":
        m = apply_norm(m, sp["post_ln2"], cfg)
    return x + m, aux


def cross_attn(h: torch.Tensor, p: dict, cfg: ModelConfig, *,
               enc_out: Optional[torch.Tensor] = None,
               cache: Optional[dict] = None) -> torch.Tensor:
    """Non-causal attention of h (B, S, D) over the encoder states, by
    the plain `full_attention` as in the reference. With `enc_out` (a
    prefill or a training forward) K and V are projected from it, and
    written into the cache's `xk` / `xv` (B, Hkv, S_enc, hd) when one is
    given; in decode (`enc_out` None) they are read from there. K and V
    are f32 when the encoder ran in f32 (`encdec.encoder_forward`)."""
    b, s, _ = h.shape
    q = layers.matmul(h, p["wq"]).reshape(b, s, cfg.n_heads,
                                          cfg.head_dim).transpose(1, 2)
    if enc_out is None:  # decode: encoder K/V precomputed at prefill
        k, v = cache["xk"], cache["xv"]
    else:
        k, v = (layers.matmul(enc_out, p[w]).reshape(
            b, -1, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
            for w in ("wk", "wv"))
        if cache is not None:
            cache["xk"].copy_(k)
            cache["xv"].copy_(v)
    o = attn_mod.full_attention(q, k, v, scale=cfg.head_dim ** -0.5,
                                causal=False)
    o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return layers.matmul(o, p["wo"])


def decoder_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, cache: Optional[dict] = None,
                    decode_pos: Optional[int] = None,
                    enc_out: Optional[torch.Tensor] = None,
                    impl: str = "auto") -> tuple:
    """x (B, S, D) embedded inputs -> (final-normed hidden, cache, aux:
    the sum of the MoE layers' aux losses, f32). The cache, when given,
    is updated in place and returned. Without a cache
    the forward is differentiable: each layer reads views of the stacked
    leaves (`layer_slice`), so gradients reach the stacked tensors.
    `enc_out` (B, S_enc, D), the encoder states of an encoder-decoder
    model, feeds each layer's cross-attention (not needed in decode).
    Under grad with `cfg.remat`, each segment step runs
    under `layers.remat`, its MoE aux loss going out with its output."""

    def seg_step(x, sp, sc, subs, enc_out):
        aux_sum = None
        for j, sub in enumerate(subs):
            x, aux = sublayer_apply(
                x, sp[f"sub{j}"], sub, cfg, positions=positions,
                cache=None if sc is None else sc[f"sub{j}"],
                decode_pos=decode_pos, enc_out=enc_out, impl=impl)
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
        return x, aux_sum

    aux_total = None
    for i, seg in enumerate(build_segments(cfg)):
        seg_params = params["segments"][f"seg{i}"]
        seg_cache = None if cache is None else cache[f"seg{i}"]
        for step in range(seg.n_steps):
            sp = layer_slice(seg_params, step)
            x, aux = remat(cfg, seg_step, x, sp, layer_slice(seg_cache, step),
                           seg.subs, enc_out)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
    if aux_total is None:  # no MoE layer
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return apply_norm(x, params.get("final_norm"), cfg), cache, aux_total


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------
def init_decoder_cache(batch: int, cache_len: int, cfg: ModelConfig,
                       device=None, cross_attn: bool = False,
                       cross_dtype: Optional[torch.dtype] = None) -> dict:
    """Cache tree matching the parameter layout: per segment and sublayer
    a KV cache stacked on the layer dimension. A windowed sublayer's cache
    is a ring buffer of min(window, cache_len) slots; under `cfg.use_mla`
    each holds the latent cache (`mla.init_mla_cache`). With `cross_attn`,
    each sublayer also holds its cross-attention K and V over the
    `enc_seq` encoder states (`xk`, `xv`), in `cross_dtype` (default the
    model's dtype; the encoder's output dtype when a prefill fills it)."""
    cache: dict = {}
    for i, seg in enumerate(build_segments(cfg)):
        subs: dict = {}
        for j, sub in enumerate(seg.subs):
            clen = cache_len if sub.window is None \
                else min(cache_len, sub.window)
            init = mla_mod.init_mla_cache if cfg.use_mla \
                else attn_mod.init_kv_cache
            sc = {"kv": init(batch, clen, cfg, lead=(seg.n_steps,),
                             device=device)}
            if cross_attn:
                shape = (seg.n_steps, batch, cfg.n_kv_heads, cfg.enc_seq,
                         cfg.head_dim)
                for name in ("xk", "xv"):
                    sc[name] = torch.zeros(shape,
                                           dtype=cross_dtype or dtype_of(cfg),
                                           device=device)
            subs[f"sub{j}"] = sc
        cache[f"seg{i}"] = subs
    return cache
