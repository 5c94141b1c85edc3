"""Multi-head Latent Attention (DeepSeek-V3 [arXiv:2412.19437]; port of
`repro.models.mla`).

Queries go through a low-rank latent with its own RMS norm (`q_a`,
`q_a_norm`, `q_b`); keys and values through the kv latent c (kv_lora_rank,
RMS-normed) and a rotary key `k_rope` (qk_rope_dim) shared by every head.
Only c and k_rope are cached, with the cache's `pos_ids`.

Prefill (and training) expands K and V per head: k = [c·W_uk, k_rope] at
head_dim qk_nope + qk_rope (192 at full width), v = c·W_uv at v_head_dim
(128), then causal attention at scale (qk_nope + qk_rope)^-0.5 by the
plain `full_attention` up to 1,024 positions and `blockwise_attention`
above, as the reference (it never calls the Pallas kernel for MLA). Decode
is the absorbed form, all in f32 against the cache whatever its dtype:
q_lat = q_nope·W_uk, scores q_lat·c + q_rope·k_rope over the cache, the
mask from `pos_ids`, ctx = softmax·c, then ctx·W_uv. The cache is updated
in place (the reference returns a new one).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention.ref import NEG_INF
from repro_torch.models.attention import blockwise_attention, full_attention
from repro_torch.models.layers import dense_init, dtype_of, rms_norm, rope

# the longest prefill the materializing `full_attention` takes, as the
# reference's `s <= 1024`
FULL_ATTENTION_MAX = 1024


def mla_params(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    dt = dtype_of(cfg)
    d, h = cfg.d_model, cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    rank = cfg.kv_lora_rank
    p = {}
    if cfg.q_lora_rank:
        p["q_a"] = dense_init(gen, d, (*lead, d, cfg.q_lora_rank), dt)
        p["q_a_norm"] = torch.ones((*lead, cfg.q_lora_rank), dtype=dt,
                                   device=gen.device)
        p["q_b"] = dense_init(gen, cfg.q_lora_rank,
                              (*lead, cfg.q_lora_rank, h * qd), dt)
    else:
        p["q_b"] = dense_init(gen, d, (*lead, d, h * qd), dt)
    p["kv_a"] = dense_init(gen, d, (*lead, d, rank + cfg.qk_rope_dim), dt)
    p["kv_a_norm"] = torch.ones((*lead, rank), dtype=dt, device=gen.device)
    p["kv_b_k"] = dense_init(gen, rank, (*lead, h, rank, cfg.qk_nope_dim),
                             dt)
    p["kv_b_v"] = dense_init(gen, rank, (*lead, h, rank, cfg.v_head_dim), dt)
    p["wo"] = dense_init(gen, h * cfg.v_head_dim,
                         (*lead, h * cfg.v_head_dim, d), dt)
    return p


def _project_q(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple:
    b, s, _ = x.shape
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = rms_norm(x @ p["q_a"], p["q_a_norm"]) @ p["q_b"]
    else:
        q = x @ p["q_b"]
    q = q.reshape(b, s, cfg.n_heads, qd)
    return q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]


def _project_kv_latent(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple:
    ckv = x @ p["kv_a"]
    c = rms_norm(ckv[..., :cfg.kv_lora_rank], p["kv_a_norm"])
    return c, ckv[..., cfg.kv_lora_rank:]  # k_rope (B, S, rope), shared


def init_mla_cache(batch: int, cache_len: int, cfg: ModelConfig, lead=(),
                   device=None) -> dict:
    dt = dtype_of(cfg)
    return {
        "c": torch.zeros((*lead, batch, cache_len, cfg.kv_lora_rank),
                         dtype=dt, device=device),
        "k_rope": torch.zeros((*lead, batch, cache_len, cfg.qk_rope_dim),
                              dtype=dt, device=device),
        "pos_ids": torch.full((*lead, cache_len), -1, dtype=torch.int32,
                              device=device),
    }


def _absorbed_decode(q_nope, q_rope, p, cache, pos: int, scale: float):
    """One query token against the latent cache, in f32: (B, H, v)."""
    f32 = torch.float32
    q_lat = torch.einsum("bshn,hrn->bhr", q_nope.to(f32),
                         p["kv_b_k"].to(f32))
    c = cache["c"].to(f32)
    s_lat = torch.einsum("bhr,btr->bht", q_lat, c)
    s_rope = torch.einsum("bshr,btr->bht", q_rope.to(f32),
                          cache["k_rope"].to(f32))
    scores = (s_lat + s_rope) * scale
    pid = cache["pos_ids"]
    valid = (pid >= 0) & (pid <= pos)
    attn = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    ctx = torch.einsum("bht,btr->bhr", attn, c)
    return torch.einsum("bhr,hrv->bhv", ctx, p["kv_b_v"].to(f32))


def mla_apply(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
              positions: torch.Tensor, cache: Optional[dict] = None,
              decode_pos: Optional[int] = None) -> tuple:
    """x (B, S, D) -> (out (B, S, D), cache). With a cache and S == 1 a
    decode step at `decode_pos` (slot decode_pos mod cache length);
    otherwise a prefill, which writes its last min(S, cache length)
    latents, rotary keys and positions into slots 0.. of the cache when
    one is given (a prefill's cache is at least S long, so position p
    lands in slot p, where decode expects it)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    q_nope, q_rope = _project_q(x, p, cfg)
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c, k_rope = _project_kv_latent(x, p, cfg)
    # RoPE on a singleton head axis: the rotary key is shared over heads
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if cache is not None and s == 1:
        slot = decode_pos % cache["c"].shape[-2]
        cache["c"][:, slot:slot + 1] = c
        cache["k_rope"][:, slot:slot + 1] = k_rope
        # a fill on a one-element slice (no host-to-card copy)
        cache["pos_ids"][slot:slot + 1].fill_(decode_pos)
        out = _absorbed_decode(q_nope, q_rope, p, cache, decode_pos, scale)
        out = out.reshape(b, 1, h * cfg.v_head_dim).to(x.dtype)
    else:
        k_nope = torch.einsum("bsr,hrn->bshn", c, p["kv_b_k"])
        v = torch.einsum("bsr,hrv->bshv", c, p["kv_b_v"])
        k = torch.cat([k_nope, k_rope[:, :, None].expand(
            b, s, h, cfg.qk_rope_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if s <= FULL_ATTENTION_MAX:
            o = full_attention(qt, kt, vt, scale=scale, causal=True)
        else:
            o = blockwise_attention(qt, kt, vt, scale=scale, causal=True,
                                    block_q=cfg.attn_block_q,
                                    block_kv=cfg.attn_block_kv)
        out = o.transpose(1, 2).reshape(b, s, h * cfg.v_head_dim)
        if cache is not None:  # prefill
            take = min(s, cache["c"].shape[-2])
            cache["c"][:, :take] = c[:, s - take:]
            cache["k_rope"][:, :take] = k_rope[:, s - take:]
            cache["pos_ids"][:take] = positions[s - take:]
            cache["pos_ids"][take:] = -1
    return out @ p["wo"], cache
