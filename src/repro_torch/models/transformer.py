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
norms, embedding scale and qk-norm (S2): `check_slice` raises
`NotImplementedError` naming the ROADMAP item of every other structure.

Training (`decoder_forward` under autograd) keeps every layer's
activations for the backward: the reference's `remat=True` (recompute
each scanned layer in the backward) is a memory choice with no effect on
the numbers, and the port does not recompute. Only `chunked_xent`
recomputes, each logits chunk, as the reference's does. At olmo-1b's
training shape (B = 8, S = 256) the kept activations are a few GB.
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
from repro_torch.models.layers import (apply_norm, dtype_of, embed_init,
                                       layer_slice, norm_param)


@dataclasses.dataclass(frozen=True)
class SubLayer:
    kind: str  # 'dense' (the reference also has 'moe', ROADMAP S4)
    window: Optional[int]  # sliding window (None = global)


@dataclasses.dataclass(frozen=True)
class Segment:
    n_steps: int
    subs: tuple


def check_slice(cfg: ModelConfig) -> None:
    """Raise for every structure outside the dense decoder of S2."""
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.arch_id}: MoE layers are not ported yet (ROADMAP S4)")
    if cfg.use_mla or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.arch_id}: MLA attention and the MTP head are not ported "
            "yet (ROADMAP S5)")
    if cfg.n_patches or cfg.n_enc_layers or not cfg.use_rope:
        raise NotImplementedError(
            f"{cfg.arch_id}: encoder-decoder and VLM stacks are not ported "
            "yet (ROADMAP S7)")
    if cfg.layer_pattern == "hymba_global_set":
        raise NotImplementedError(
            f"{cfg.arch_id}: hymba's runtime global-layer set is not ported "
            "yet (ROADMAP S6)")
    if cfg.opt_int8_cache or cfg.opt_pad_heads:
        raise NotImplementedError(
            f"{cfg.arch_id}: the int8 KV cache and head padding "
            "(opt_int8_cache, opt_pad_heads) are not ported yet "
            "(ROADMAP S3)")


def build_segments(cfg: ModelConfig) -> tuple:
    check_slice(cfg)
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
def sublayer_params(gen: torch.Generator, cfg: ModelConfig,
                    lead=()) -> dict:
    p = {"ln1": norm_param(cfg, *lead, device=gen.device),
         "ln2": norm_param(cfg, *lead, device=gen.device),
         "attn": attn_mod.attention_params(gen, cfg, lead=lead),
         "mlp": layers.mlp_params(gen, cfg, lead=lead)}
    if cfg.norm_style == "sandwich":
        p["post_ln1"] = norm_param(cfg, *lead, device=gen.device)
        p["post_ln2"] = norm_param(cfg, *lead, device=gen.device)
    return p


def init_decoder(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on `gen`'s device, in the reference's layout."""
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
        f"seg{i}": {f"sub{j}": sublayer_params(gen, cfg, lead=(seg.n_steps,))
                    for j, _ in enumerate(seg.subs)}
        for i, seg in enumerate(segs)}
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
    logits = (h @ w).float()
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
                   impl: str = "auto") -> torch.Tensor:
    """One decoder layer (attention over `sub.window`, then the MLP, each
    followed by its post norm under `norm_style == "sandwich"`); its KV
    cache, when given, is updated in place."""
    h = apply_norm(x, sp["ln1"], cfg)
    a, _ = attn_mod.attn_apply(
        h, sp["attn"], cfg, positions=positions, window=sub.window,
        cache=None if cache is None else cache["kv"],
        decode_pos=decode_pos, impl=impl)
    if cfg.norm_style == "sandwich":
        a = apply_norm(a, sp["post_ln1"], cfg)
    x = x + a
    h = apply_norm(x, sp["ln2"], cfg)
    m = layers.mlp_apply(h, sp["mlp"], cfg)
    if cfg.norm_style == "sandwich":
        m = apply_norm(m, sp["post_ln2"], cfg)
    return x + m


def decoder_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, cache: Optional[dict] = None,
                    decode_pos: Optional[int] = None,
                    impl: str = "auto") -> tuple:
    """x (B, S, D) embedded inputs -> (final-normed hidden, cache). The
    cache, when given, is updated in place and returned. Without a cache
    the forward is differentiable: each layer reads views of the stacked
    leaves (`layer_slice`), so gradients reach the stacked tensors."""
    for i, seg in enumerate(build_segments(cfg)):
        seg_params = params["segments"][f"seg{i}"]
        seg_cache = None if cache is None else cache[f"seg{i}"]
        for step in range(seg.n_steps):
            for j, sub in enumerate(seg.subs):
                x = sublayer_apply(
                    x, layer_slice(seg_params[f"sub{j}"], step), sub, cfg,
                    positions=positions,
                    cache=None if seg_cache is None
                    else layer_slice(seg_cache[f"sub{j}"], step),
                    decode_pos=decode_pos, impl=impl)
    return apply_norm(x, params.get("final_norm"), cfg), cache


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------
def init_decoder_cache(batch: int, cache_len: int, cfg: ModelConfig,
                       device=None) -> dict:
    """Cache tree matching the parameter layout: per segment and sublayer
    a KV cache stacked on the layer dimension. A windowed sublayer's cache
    is a ring buffer of min(window, cache_len) slots."""
    return {f"seg{i}": {f"sub{j}": {"kv": attn_mod.init_kv_cache(
        batch, cache_len if sub.window is None
        else min(cache_len, sub.window), cfg, lead=(seg.n_steps,),
        device=device)}
        for j, sub in enumerate(seg.subs)}
        for i, seg in enumerate(build_segments(cfg))}
