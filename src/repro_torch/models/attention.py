"""Attention for the dense decoder: projections, RoPE, the flash-attention
kernel for prefill, and the KV cache for decode (port of the dense,
unsharded part of `repro.models.attention`).

`sdpa` is the kernel on CUDA tensors and its plain version on CPU tensors
(`kernels.attention.ops.multi_head_attention`); where autograd records
(training), it is `models.flash_vjp.flash_attention`: the same forward
with the row log-sum-exp, and the flash backward. `full_attention` is
the materializing oracle. The KV cache is a dict of tensors updated IN PLACE
(the reference returns a new pytree): at full width a copy per decoded
token would move the whole cache (1.1 GB for olmo-1b at B = 4 and 2080
positions) once per token.

Sliding windows and the attention-logit softcap reach both routes: K2
and its plain version in prefill (and the flash backward in training),
`decode_attention` in decode, where a windowed layer's cache is a ring
buffer of min(window, cache length) slots. qk-norm is a plain RMS norm of
each head's q and k before RoPE.

The int8 cache (`opt_int8_cache`, S3) keeps k and v as int8 with an f32
scale per (token, head), quantized on write as the reference does, bit
for bit, and dequantized to f32 on read (`cache_kv`). `opt_pad_heads`
changes nothing on one card: without a mesh the reference's pad is 0,
and its other effect, k and v repeated to q's width, is what K2's GQA
does by reading kv head h // group (on a mesh, `models.meshed` pads).

The reference feeds hymba's few global layers a traced `is_global` flag,
which sends its prefill past the Pallas kernel. The port loops over
layers in Python, so a layer's flag is known on the host: a global
layer passes `window=None` (to K2 and to `decode_attention`), which is
the function the flag computes.

This module has no sharding calls: on a mesh, training and serving
run its pieces (`project_qkv`, `sdpa`, `write_prefill`, `cache_write`,
`decode_scores`, `decode_probs`) on each entry's local heads or
head_dim columns (`models.meshed`, ROADMAP M12a, M12b).
`blockwise_attention`, the reference's blockwise attention, serves
MLA's prefill past 1,024 positions (`models.mla`) as in the reference;
this module's own attention takes K2 in serving and the flash backward
in training, whatever `opt_flash_vjp` says.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention.ops import multi_head_attention
from repro_torch.kernels.attention.ref import NEG_INF
from repro_torch.models.flash_vjp import flash_attention
from repro_torch.models.layers import (dense_init, dtype_of, matmul,
                                       rms_norm, rope)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def attention_params(gen: torch.Generator, cfg: ModelConfig,
                     lead=()) -> dict:
    dt = dtype_of(cfg)
    p = {
        "wq": dense_init(gen, cfg.d_model, (*lead, cfg.d_model, cfg.q_dim),
                         dt),
        "wk": dense_init(gen, cfg.d_model, (*lead, cfg.d_model, cfg.kv_dim),
                         dt),
        "wv": dense_init(gen, cfg.d_model, (*lead, cfg.d_model, cfg.kv_dim),
                         dt),
        "wo": dense_init(gen, cfg.q_dim, (*lead, cfg.q_dim, cfg.d_model),
                         dt),
    }
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.ones((*lead, cfg.head_dim), dtype=dt,
                                 device=gen.device)
    return p


# --------------------------------------------------------------------------
# scaled dot-product attention
# --------------------------------------------------------------------------
def _mask(q_idx: torch.Tensor, k_idx: torch.Tensor, *, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    mask = torch.ones((q_idx.shape[0], k_idx.shape[0]), dtype=torch.bool,
                      device=q_idx.device)
    if causal:
        mask &= q_idx[:, None] >= k_idx[None, :]
    if window is not None:
        mask &= (q_idx[:, None] - k_idx[None, :]) < window
    return mask


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, causal: bool = True,
                   window: Optional[int] = None,
                   softcap: Optional[float] = None,
                   q_offset: int = 0) -> torch.Tensor:
    """Materializing oracle over q (B, Hq, Sq, d), k, v (B, Hkv, Skv, d)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(q_offset + torch.arange(sq, device=q.device),
                 torch.arange(skv, device=q.device), causal=causal,
                 window=window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True,
                        block_q: int = 512,
                        block_kv: int = 1024) -> torch.Tensor:
    """The reference's blockwise (flash-style) attention, in plain
    PyTorch: q (B, Hq, Sq, d), k (B, Hkv, Skv, d), v (B, Hkv, Skv, dv)
    -> (B, Hq, Sq, dv) in q's dtype. Each block of `block_q` queries
    walks the key blocks of `block_kv` in order with f32 online-softmax
    accumulators, so at most one (block_q, block_kv) score tile a head is
    held (MLA's prefill at 2,048 tokens and 128 heads would hold 8.6 GB of
    f32 scores a layer in `full_attention`). A key block wholly after the
    query block is skipped under the causal mask: in the reference it adds
    p = 0 and rescales by exp(0) = 1, so skipping it changes no value. A
    ragged last block is cut short where the reference pads and masks the
    padding. (The reference's window, softcap and query offset have no
    caller here and are left out.) Under autograd every key block's f32
    scores and probabilities are kept for the backward: the reference
    rematerializes each block (`jax.checkpoint`); the port recomputes
    the whole layer under `cfg.remat` (`layers.remat`) but not each
    block, so a layer's backward past 1,024 positions holds them all."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    bq, bk = min(block_q, sq), min(block_kv, skv)
    qg = q.reshape(b, hkv, g, sq, d)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hkv, g, sq, dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, bq):
        q1 = min(q0 + bq, sq)
        q_idx = torch.arange(q0, q1, device=q.device)
        q_blk = qg[:, :, :, q0:q1].float()
        m = torch.full((b, hkv, g, q1 - q0, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, q1 - q0, dv), device=q.device)
        for k0 in range(0, skv, bk):
            if causal and k0 > q1 - 1:
                break  # this and every later key block lie after the queries
            k1 = min(k0 + bk, skv)
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk,
                             kf[:, :, k0:k1]) * scale
            mask = _mask(q_idx, torch.arange(k0, k1, device=q.device),
                         causal=causal, window=None)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                             vf[:, :, k0:k1])
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        out[:, :, :, q0:q1] = (acc / l).to(q.dtype)
    return out.reshape(b, hq, sq, dv)


def sdpa(q, k, v, cfg: ModelConfig, *, causal: bool = True,
         window: Optional[int] = None, impl: str = "auto") -> torch.Tensor:
    """Attention for prefill (causal unless `causal=False`, as the whisper
    encoder), over the sliding `window` when one is given and with the
    config's `attn_softcap`: the flash-attention kernel on CUDA tensors,
    its plain version on CPU tensors (`impl` as in
    `multi_head_attention`). Where grad is enabled and an input requires
    it, `flash_attention` at the config's `attn_block_q` /
    `attn_block_kv`: the same forward (K2 writing its log-sum-exp) and
    the flash backward, in f32 and bf16."""
    scale = cfg.head_dim ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_attention(q, k, v, scale=scale, causal=causal,
                               window=window, softcap=cfg.attn_softcap,
                               block_q=cfg.attn_block_q,
                               block_kv=cfg.attn_block_kv, impl=impl)
    return multi_head_attention(q, k, v, scale=scale, causal=causal,
                                window=window, softcap=cfg.attn_softcap,
                                impl=impl)


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------
def init_kv_cache(batch: int, cache_len: int, cfg: ModelConfig, lead=(),
                  device=None) -> dict:
    """Zero k, v in the model's dtype, or int8 with f32 scales of shape
    (..., B, Hkv, L, 1) under `opt_int8_cache`; `pos_ids` -1 (empty)."""
    shape = (*lead, batch, cfg.n_kv_heads, cache_len, cfg.head_dim)
    cache = {"pos_ids": torch.full((*lead, cache_len), -1, dtype=torch.int32,
                                   device=device)}
    dt = torch.int8 if cfg.opt_int8_cache else dtype_of(cfg)
    for name in ("k", "v"):
        cache[name] = torch.zeros(shape, dtype=dt, device=device)
        if cfg.opt_int8_cache:
            cache[f"{name}_scale"] = torch.zeros((*shape[:-1], 1),
                                                 dtype=torch.float32,
                                                 device=device)
    return cache


def quantize(x: torch.Tensor) -> tuple:
    """Per-(token, head) symmetric int8 quantization over head_dim: the
    scale max|x| / 127 (at least 1e-8), the values rounded half to even
    and clipped to ±127, as the reference's `_quantize` (both round half
    to even), so both are its bits."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0,
                            1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def cache_kv(cache: dict, which: str) -> torch.Tensor:
    """The cached K or V in f32, dequantized when the cache is int8."""
    x = cache[which].float()
    if f"{which}_scale" in cache:
        x = x * cache[f"{which}_scale"]
    return x


def _store(cache: dict, name: str, new: torch.Tensor, slots,
           cols: slice = slice(None)) -> None:
    """Write `new` (B, Hkv, n, d) into `cache[name]` at `slots` of the
    position axis, quantized first when the cache is int8; a cache that
    holds only the head_dim columns `cols` (a mesh entry's block) takes
    those, each scale still over the whole head."""
    if f"{name}_scale" in cache:
        new, scale = quantize(new)
        cache[f"{name}_scale"][:, :, slots] = scale
    cache[name][:, :, slots] = new[..., cols]


def cache_write(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: int, cols: slice = slice(None)) -> dict:
    """Write one token (B, Hkv, 1, d) at absolute position `pos` into its
    ring-buffer slot, in place (head_dim columns `cols` as in `_store`)."""
    slot = pos % cache["k"].shape[-2]
    _store(cache, "k", k_new, slice(slot, slot + 1), cols)
    _store(cache, "v", v_new, slice(slot, slot + 1), cols)
    # a fill on a one-element slice: `pos_ids[slot] = pos` would copy a
    # host scalar to the card and synchronize, once per layer and token
    cache["pos_ids"][slot:slot + 1].fill_(pos)
    return cache


def write_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, cols: slice = slice(None)) -> None:
    """Write a prefill's last min(S, cache_len) keys and values (B, Hkv,
    S, d) into the cache, in place, position p in slot p mod cache_len,
    where decode's ring buffer (`cache_write`) keeps it; an int8 cache
    takes each key quantized, then rolled into its slot (head_dim
    columns `cols` as in `_store`)."""
    s = k.shape[2]
    cache_len = cache["k"].shape[-2]
    take = min(s, cache_len)
    # prefill's positions are 0..S-1: the first one kept, S - take,
    # belongs in slot (S - take) mod cache_len
    shift = (s - take) % cache_len

    def ring(t: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.roll(t, shift, dim) if shift else t

    _store(cache, "k", ring(k[:, :, s - take:], 2), slice(0, take), cols)
    _store(cache, "v", ring(v[:, :, s - take:], 2), slice(0, take), cols)
    cache["pos_ids"][:take] = ring(positions[s - take:], 0)
    cache["pos_ids"][take:] = -1


def decode_scores(q: torch.Tensor, cache: dict) -> torch.Tensor:
    """One query token's unscaled f32 scores (B, Hkv, group, L) against
    the cached keys (an int8 cache dequantized); on a mesh entry holding
    head_dim columns, q's same columns give a partial sum."""
    b, hq, _, d = q.shape
    hkv = cache["k"].shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    return torch.einsum("bhgd,bhsd->bhgs", qg, cache_kv(cache, "k"))


def decode_probs(s: torch.Tensor, pos_ids: torch.Tensor, pos: int,
                 cfg: ModelConfig, window: Optional[int]) -> torch.Tensor:
    """Scores -> probabilities: scaled, the config's softcap, only the
    filled keys at or before `pos` (and less than `window` positions back
    when a window is given), softmax."""
    s = s * cfg.head_dim ** -0.5
    if cfg.attn_softcap is not None:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    valid = (pos_ids >= 0) & (pos_ids <= pos)
    if window is not None:
        valid &= (pos - pos_ids) < window
    s = torch.where(valid, s, NEG_INF)
    return torch.softmax(s, dim=-1)


def decode_attention(q: torch.Tensor, cache: dict, pos: int,
                     cfg: ModelConfig, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One query token (B, Hq, 1, d) against the cache, in f32 (an int8
    cache dequantized): the config's softcap on the scaled logits, and
    only the keys less than `window` positions back when a window is
    given."""
    b, hq, _, d = q.shape
    p = decode_probs(decode_scores(q, cache), cache["pos_ids"], pos, cfg,
                     window)
    out = torch.einsum("bhgs,bhsd->bhgd", p, cache_kv(cache, "v"))
    return out.reshape(b, hq, 1, d).to(q.dtype)


# --------------------------------------------------------------------------
# attention sub-layer (projections + rope + sdpa / decode)
# --------------------------------------------------------------------------
def project_qkv(x: torch.Tensor, p: dict, cfg: ModelConfig,
                positions: torch.Tensor) -> tuple:
    """x (B, S, D) -> q (B, Hq, S, d), k, v (B, Hkv, S, d) views: the
    projections, qk-norm (a plain RMS norm of each head) and RoPE under
    `cfg.use_rope`. An f32 `x` against bf16 weights computes in f32
    (`layers.matmul`)."""
    b, s, _ = x.shape
    q = matmul(x, p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = matmul(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = matmul(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:  # a plain RMS norm of each head, before RoPE
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return tuple(t.transpose(1, 2) for t in (q, k, v))


def attn_apply(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
               positions: torch.Tensor, causal: bool = True,
               window: Optional[int] = None,
               cache: Optional[dict] = None,
               decode_pos: Optional[int] = None,
               impl: str = "auto") -> tuple:
    """x (B, S, D) -> (out (B, S, D), cache), attending over the sliding
    `window` when one is given (causal unless `causal=False`; RoPE under
    `cfg.use_rope`). With a cache and S == 1 this is a decode step at
    `decode_pos`; otherwise a prefill, which writes its keys and values
    into the cache when one is given (`write_prefill`: key p in slot p
    mod cache_len; the reference writes them into slots 0.. in order,
    which places a windowed ring's keys where decode does not expect
    them when S > window and S mod window != 0). `impl` selects the
    prefill attention as in `sdpa`."""
    b, s, _ = x.shape
    q, k, v = project_qkv(x, p, cfg, positions)
    if cache is not None and s == 1:
        cache = cache_write(cache, k, v, decode_pos)
        out = decode_attention(q, cache, decode_pos, cfg, window=window)
    else:
        out = sdpa(q, k, v, cfg, causal=causal, window=window, impl=impl)
        if cache is not None:  # prefill into the cache
            write_prefill(cache, k, v, positions)
    out = out.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return matmul(out, p["wo"]), cache
