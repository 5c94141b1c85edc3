"""Selective-SSM (Mamba-style) branch and the Hymba hybrid stack (port of
`repro.models.ssm`) [arXiv:2411.13676]: every layer runs attention heads
and SSM heads in parallel on the same input and averages their
(per-branch-normalized) outputs; 128 learned meta tokens are prepended to
the prompt at prefill. Most layers attend over a sliding window; the
layers in `global_layer_ids` attend globally: the port loops over layers
in Python and passes those layers `window=None`, to K2 in prefill and to
`decode_attention` in decode (the reference's traced `is_global` flag).

Parameters keep the reference's layout: `blocks/...` stacked on the layer
dimension, plus `embed`, `final_norm`, `lm_head` and `meta`. The cache
keeps it too: every layer's KV cache at the full length (not a ring),
the conv state (L, B, W-1, D) in the model's dtype and the SSM state
(L, B, D, N) in f32. Caches and states are updated in place.

The selective scan h_t = a_t·h_{t-1} + bx_t is plain PyTorch, as the
reference's is `jax.lax.associative_scan` and no Pallas kernel: chunks of
SSM_CHUNK steps walked in order, within a chunk a log-step
(Hillis–Steele) doubling scan of (a, b) pairs, 8 passes at 256. No
Python loop runs over the sequence.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_norm, dense_init, dtype_of,
                                       embed_init, layer_slice, matmul,
                                       mlp_apply, mlp_params, norm_param,
                                       remat, rms_norm)

SSM_CHUNK = 256


# ---------------------------------------------------------------------------
# mamba branch
# ---------------------------------------------------------------------------
def mamba_params(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    dt = dtype_of(cfg)
    dev = gen.device
    d = din = cfg.d_model  # hymba: the SSM head width is the model width
    n, r = cfg.ssm_state, max(cfg.dt_rank, 1)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "in_proj": dense_init(gen, d, (*lead, d, 2 * din), dt),
        "conv_w": torch.randn((*lead, cfg.ssm_conv, din), generator=gen,
                              device=dev).mul_(0.1).to(dt),
        "conv_b": torch.zeros((*lead, din), dtype=dt, device=dev),
        "bc_proj": dense_init(gen, din, (*lead, din, 2 * n), dt),
        "dt_lora_a": dense_init(gen, din, (*lead, din, r), dt),
        "dt_lora_b": dense_init(gen, r, (*lead, r, din), dt),
        "dt_bias": torch.zeros((*lead, din), dtype=torch.float32,
                               device=dev),
        "a_log": a_log.expand(*lead, din, n).clone(),
        "d_skip": torch.ones((*lead, din), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, din, (*lead, din, d), dt),
    }


def selective_scan(a: torch.Tensor, bx: torch.Tensor,
                   h0: torch.Tensor) -> tuple:
    """h_t = a_t * h_{t-1} + bx_t over t. a, bx: (B, S, Din, N) f32; h0:
    (B, Din, N). Returns (h for every t (B, S, Din, N), the last h).
    Chunks of SSM_CHUNK steps in order; within each, the (a, b) pairs
    are scanned by doubling, (a1, b1) then (a2, b2) combining to
    (a1·a2, a2·b1 + b2) as the reference's `assoc`; a ragged last chunk
    is scanned at its own length."""
    s = a.shape[1]
    h = h0
    outs = []
    for lo in range(0, s, SSM_CHUNK):
        ac, bc = a[:, lo:lo + SSM_CHUNK], bx[:, lo:lo + SSM_CHUNK]
        off = 1
        while off < ac.shape[1]:
            ac, bc = (torch.cat([ac[:, :off], ac[:, :-off] * ac[:, off:]], 1),
                      torch.cat([bc[:, :off],
                                 ac[:, off:] * bc[:, :-off] + bc[:, off:]],
                                1))
            off *= 2
        h_all = ac * h[:, None] + bc
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.cat(outs, 1), h


def mamba_apply(x: torch.Tensor, p: dict, cfg: ModelConfig,
                state: Optional[dict] = None) -> tuple:
    """x (B, S, D) -> (out (B, S, D), new state {'conv': (B, W-1, Din),
    'ssm': (B, Din, N) f32}); `state` None starts from zeros."""
    b, s, d = x.shape
    xz = matmul(x, p["in_proj"])
    xi_raw, z = torch.chunk(xz, 2, dim=-1)
    w = p["conv_w"]  # (W, Din): a causal depthwise conv
    kw = w.shape[0]
    if state is None:
        xpad = F.pad(xi_raw, (0, 0, kw - 1, 0))
    else:
        xpad = torch.cat([state["conv"], xi_raw], dim=1)
    conv = sum(xpad[:, i:i + s] * w[i][None, None] for i in range(kw))
    xi = F.silu(conv + p["conv_b"])

    bc = matmul(xi, p["bc_proj"])
    b_ssm, c_ssm = torch.chunk(bc.float(), 2, dim=-1)  # (B, S, N)
    dt = matmul(matmul(xi, p["dt_lora_a"]), p["dt_lora_b"]).float()
    dt = dt + p["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))  # jax.nn.softplus
    a = -torch.exp(p["a_log"])  # (Din, N)
    xf = xi.float()
    decay = torch.exp(dt[..., None] * a[None, None])  # (B, S, Din, N)
    bx = (dt * xf)[..., None] * b_ssm[:, :, None, :]
    h0 = (torch.zeros((b, d, cfg.ssm_state), dtype=torch.float32,
                      device=x.device) if state is None else state["ssm"])
    h_all, h_fin = selective_scan(decay, bx, h0)
    y = torch.einsum("bsdn,bsn->bsd", h_all, c_ssm) + p["d_skip"] * xf
    y = y.to(x.dtype) * F.silu(z)
    out = matmul(y, p["out_proj"])
    return out, {"conv": xpad[:, -(kw - 1):], "ssm": h_fin}


# ---------------------------------------------------------------------------
# hymba hybrid stack
# ---------------------------------------------------------------------------
def hymba_block_params(gen: torch.Generator, cfg: ModelConfig,
                       lead=()) -> dict:
    dt = dtype_of(cfg)
    return {
        "ln1": norm_param(cfg, *lead, device=gen.device),
        "ln2": norm_param(cfg, *lead, device=gen.device),
        "attn": attn_mod.attention_params(gen, cfg, lead=lead),
        "mamba": mamba_params(gen, cfg, lead=lead),
        "attn_norm": torch.ones((*lead, cfg.d_model), dtype=dt,
                                device=gen.device),
        "ssm_norm": torch.ones((*lead, cfg.d_model), dtype=dt,
                               device=gen.device),
        "mlp": mlp_params(gen, cfg, lead=lead),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on `gen`'s device, in the reference's layout."""
    dt = dtype_of(cfg)
    p = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt),
        "final_norm": norm_param(cfg, device=gen.device),
        "lm_head": dense_init(gen, cfg.d_model,
                              (cfg.d_model, cfg.vocab_size), dt),
        "blocks": hymba_block_params(gen, cfg, lead=(cfg.n_layers,)),
    }
    if cfg.meta_tokens:
        p["meta"] = embed_init(gen, (cfg.meta_tokens, cfg.d_model), dt)
    return p


def layer_window(cfg: ModelConfig, layer: int) -> Optional[int]:
    """The attention window of `layer`: None on a global layer."""
    return None if layer in cfg.global_layer_ids else cfg.sliding_window


def hymba_block(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
                positions: torch.Tensor, window: Optional[int],
                cache: Optional[dict] = None,
                decode_pos: Optional[int] = None,
                impl: str = "auto") -> torch.Tensor:
    """One hymba layer; its KV cache and SSM state, when given, are
    updated in place."""
    h = apply_norm(x, p["ln1"], cfg)
    a, _ = attn_mod.attn_apply(
        h, p["attn"], cfg, positions=positions, window=window,
        cache=None if cache is None else cache["kv"], decode_pos=decode_pos,
        impl=impl)
    m, state = mamba_apply(h, p["mamba"], cfg,
                           state=None if cache is None else cache["ssm"])
    if cache is not None:
        cache["ssm"]["conv"].copy_(state["conv"])
        cache["ssm"]["ssm"].copy_(state["ssm"])
    # per-branch normalization, then the average (hymba's fusion)
    x = x + 0.5 * (rms_norm(a, p["attn_norm"]) + rms_norm(m, p["ssm_norm"]))
    h = apply_norm(x, p["ln2"], cfg)
    return x + mlp_apply(h, p["mlp"], cfg)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache: Optional[dict] = None, decode_pos: Optional[int] = None,
            prepend_meta: bool = False, impl: str = "auto") -> tuple:
    """tokens (B, S) -> (final-normed hidden (B, S (+ meta), D), cache),
    the cache updated in place. `prepend_meta` puts the meta tokens
    before the prompt (prefill, training); `decode_pos` makes this a
    decode step at that absolute position. Under grad with `cfg.remat`,
    each layer is recomputed in the backward
    (`layers.remat`): the backward holds one layer's scan at a time."""
    x = params["embed"][tokens].to(dtype_of(cfg))
    b, s = tokens.shape
    offset = 0
    if prepend_meta and cfg.meta_tokens:
        meta = params["meta"][None].expand(b, cfg.meta_tokens, cfg.d_model)
        x = torch.cat([meta.to(x.dtype), x], dim=1)
        offset = cfg.meta_tokens
    if decode_pos is not None:
        positions = torch.full((1,), decode_pos, device=tokens.device)
    else:
        positions = torch.arange(s + offset, device=tokens.device)
    for i in range(cfg.n_layers):
        bp = layer_slice(params["blocks"], i)
        x = remat(cfg, hymba_block, x, bp, cfg, positions=positions,
                  window=layer_window(cfg, i), cache=layer_slice(cache, i),
                  decode_pos=decode_pos, impl=impl)
    return apply_norm(x, params.get("final_norm"), cfg), cache


def init_cache(batch: int, cache_len: int, cfg: ModelConfig,
               device=None) -> dict:
    """Every layer's KV cache at `cache_len` positions, and its conv and
    SSM states at zero."""
    return {
        "kv": attn_mod.init_kv_cache(batch, cache_len, cfg,
                                     lead=(cfg.n_layers,), device=device),
        "ssm": {
            "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                                 cfg.d_model), dtype=dtype_of(cfg),
                                device=device),
            "ssm": torch.zeros((cfg.n_layers, batch, cfg.d_model,
                                cfg.ssm_state), dtype=torch.float32,
                               device=device),
        },
    }
