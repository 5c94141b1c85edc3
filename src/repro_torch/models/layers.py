"""Shared model building blocks: initializers, norms, RoPE, MLPs (port of
`repro.models.layers`).

Initializers draw from an explicit `torch.Generator`, on the generator's
device. They give other numbers than `jax.random` from the same seed; the
parity tests carry the reference's parameters across
(`repro_torch.models.convert`) instead.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

# erf(±2/√2): the truncation interval [-2, 2] in the uniform's domain
_TRUNC_LO = math.erf(-2.0 / math.sqrt(2.0))
_TRUNC_HI = math.erf(2.0 / math.sqrt(2.0))


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def truncated_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] in f32 on `gen`'s device, by
    the inverse CDF of a uniform in [Φ(-2), Φ(2)] (as `jax.random`
    draws it). Every step is in place: the draw holds one f32 buffer
    (pixtral-12b's stacked MLP leaf is 2.94 G values, 11.7 GB in f32)."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device)
    u.mul_(_TRUNC_HI - _TRUNC_LO).add_(_TRUNC_LO)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def dense_init(gen: torch.Generator, fan_in: int, shape,
               dtype: torch.dtype) -> torch.Tensor:
    return truncated_normal(gen, shape).div_(math.sqrt(fan_in)).to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype: torch.dtype) -> torch.Tensor:
    return truncated_normal(gen, shape).mul_(0.02).to(dtype)


def remat(cfg: ModelConfig, fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, recomputed in the backward when `cfg.remat`
    is set and grad is enabled: the reference's `jax.checkpoint(...,
    nothing_saveable)` around a layer body. The backward keeps the
    layer's inputs only and runs its forward again (its kernels launch
    twice); the values do not change. Serving passes its cache or state
    through under `torch.no_grad`, where `fn` runs once."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


def layer_slice(tree, i: int):
    """Layer `i`'s slice of a tree whose leaves are stacked on dim 0: views,
    so writes into a sliced cache or state update the stacked tensors."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return None if tree is None else tree[i]


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
             eps: float = 1e-6, plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        s = scale.float()
        y = y * (1.0 + s if plus_one else s)
    return y.to(x.dtype)


def nonparam_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm [arXiv:2402.00838]: no scale, no
    bias. The variance is the population variance, as `jnp.var`."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(x: torch.Tensor, p: Optional[torch.Tensor],
               cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "ln_nonparam":
        return nonparam_layer_norm(x)
    # gemma-family rms norm uses the (1 + scale) parameterization
    return rms_norm(x, p,
                    plus_one=cfg.norm_style == "sandwich" or cfg.embed_scale)


def norm_param(cfg: ModelConfig, *lead,
               device=None) -> Optional[torch.Tensor]:
    if cfg.norm == "ln_nonparam":
        return None
    fill = torch.zeros if (cfg.norm_style == "sandwich"
                           or cfg.embed_scale) else torch.ones
    return fill((*lead, cfg.d_model), dtype=dtype_of(cfg), device=device)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs  # (S, half) or (B, S, half)
    if positions.dim() == 1:
        ang = ang[None]
    ang = ang[:, :, None, :]  # (1 or B, S, 1, half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings, (len(positions), dim) f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(half - 1, 1))
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# mixed dtypes
# --------------------------------------------------------------------------
def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`x @ w` with JAX's promotion of mixed float dtypes: an f32
    activation against bf16 weights is an f32 product (`jnp.einsum`
    promotes where `torch.matmul` refuses). The whisper encoder computes
    so from f32 frames."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


# --------------------------------------------------------------------------
# mlp
# --------------------------------------------------------------------------
def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    if act == "relu2":  # nemotron/minitron squared ReLU [arXiv:2407.14679]
        r = F.relu(x)
        return r * r
    raise ValueError(act)


def mlp_params(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    d_ff = cfg.d_ff
    dt = dtype_of(cfg)
    p = {
        "wi": dense_init(gen, cfg.d_model, (*lead, cfg.d_model, d_ff), dt),
        "wo": dense_init(gen, d_ff, (*lead, d_ff, cfg.d_model), dt),
    }
    if cfg.glu:
        p["wg"] = dense_init(gen, cfg.d_model, (*lead, cfg.d_model, d_ff),
                             dt)
    return p


def mlp_apply(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    h = matmul(x, p["wi"])
    if cfg.glu:
        h = activation(matmul(x, p["wg"]), cfg.act) * h
    else:
        h = activation(h, cfg.act)
    return matmul(h, p["wo"])
