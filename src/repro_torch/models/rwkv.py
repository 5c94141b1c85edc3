"""RWKV6 "Finch" — attention-free RNN with data-dependent decay
[arXiv:2404.05892] (port of `repro.models.rwkv`).

Time-mix interpolates each token with the previous one (token shift),
draws the per-channel decay w_t = exp(-exp(w0 + tanh(x A) B)) from a
rank-64 LoRA, and feeds the WKV recurrence (the CUDA kernel on the card,
its plain version on the CPU: `kernels.wkv.ops.wkv6`). Channel-mix is the
squared-ReLU MLP with token shift. The decode state is O(1) in the
sequence: per layer the two shift tokens and the (H, hd, hd) WKV state.

Parameters keep the reference's tree — `blocks/{ln1, ln2, tm, cm}` with
every leaf stacked on a leading layer dimension, `decay_base` and `bonus`
f32 among model-dtype leaves — so `models.convert` carries them across.
The reference scans over the layer dimension; the port loops over it in
Python, slicing each layer's weights and state as views.

The serving state (`init_state`) is updated IN PLACE, as the dense
decoder's KV cache is: each layer writes its shift tokens and its final
WKV state (the kernel writes it over its own input) into its slice of the
stacked tensors; prefill starts from `init_state`'s zeros, which is what
the reference's `Model.prefill` passes too. Training passes `state=None`,
the reference's stateless forward: zero shift tokens, a zero initial WKV
state, nothing written, and the WKV differentiable (`wkv6` under
autograd: K3 and its hand-written backward on the card). As in the
dense decoder, `cfg.remat` recomputes each block in the backward, as the
reference's `jax.checkpoint` does (`layers.remat`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv.ops import wkv6
from repro_torch.models.layers import (dense_init, dtype_of, embed_init,
                                       layer_slice, remat, rms_norm)

W_LORA_RANK = 64


def _heads(cfg: ModelConfig) -> tuple:
    return cfg.n_heads, cfg.d_model // cfg.n_heads


def block_params(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """One block's parameters with the leading dims `lead` (the stacked
    layer dimension), on `gen`'s device."""
    dt = dtype_of(cfg)
    d, f = cfg.d_model, cfg.d_ff
    h, hd = _heads(cfg)
    rank = min(W_LORA_RANK, d // 2)
    dev = gen.device

    def full(value, dtype=dt):
        return torch.full((*lead, d), value, dtype=dtype, device=dev)

    return {
        "ln1": full(1.0),
        "ln2": full(1.0),
        "tm": {
            "mix_r": full(0.5),
            "mix_k": full(0.5),
            "mix_v": full(0.5),
            "mix_w": full(0.5),
            "mix_g": full(0.5),
            "wr": dense_init(gen, d, (*lead, d, d), dt),
            "wk": dense_init(gen, d, (*lead, d, d), dt),
            "wv": dense_init(gen, d, (*lead, d, d), dt),
            "wg": dense_init(gen, d, (*lead, d, d), dt),
            "wo": dense_init(gen, d, (*lead, d, d), dt),
            "decay_base": full(-1.0, torch.float32),  # w0
            "decay_lora_a": dense_init(gen, d, (*lead, d, rank), dt),
            "decay_lora_b": dense_init(gen, rank, (*lead, rank, d), dt),
            "bonus": 0.5 * torch.randn((*lead, h, hd), generator=gen,
                                       device=dev),
            "head_norm": full(1.0),
        },
        "cm": {
            "mix_k": full(0.5),
            "mix_r": full(0.5),
            "wk": dense_init(gen, d, (*lead, d, f), dt),
            "wv": dense_init(gen, f, (*lead, f, d), dt),
            "wr": dense_init(gen, d, (*lead, d, d), dt),
        },
    }


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on `gen`'s device, in the reference's layout."""
    dt = dtype_of(cfg)
    d = cfg.d_model
    return {
        "embed": embed_init(gen, (cfg.vocab_size, d), dt),
        "ln_in": torch.ones((d,), dtype=dt, device=gen.device),
        "final_norm": torch.ones((d,), dtype=dt, device=gen.device),
        "lm_head": dense_init(gen, d, (d, cfg.vocab_size), dt),
        "blocks": block_params(gen, cfg, lead=(cfg.n_layers,)),
    }


def _shift(x: torch.Tensor, last) -> torch.Tensor:
    """Token shift: x_{t-1}, with `last` (B, D) at position 0 (None:
    zeros)."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last[:, None, :], x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def time_mix(x: torch.Tensor, p: dict, cfg: ModelConfig,
             state: Optional[dict], *, impl: str = "auto") -> torch.Tensor:
    """x (B, S, D), the block's normed input; `state` this layer's
    {'tm_shift': (B, D), 'wkv': (B, H, hd, hd) f32, ...}, read and then
    updated in place, or None (training: zeros, nothing written)."""
    b, s, d = x.shape
    h, hd = _heads(cfg)
    xs = _shift(x, None if state is None else state["tm_shift"])
    r = _mix(x, xs, p["mix_r"]) @ p["wr"]
    k = _mix(x, xs, p["mix_k"]) @ p["wk"]
    v = _mix(x, xs, p["mix_v"]) @ p["wv"]
    g = F.silu(_mix(x, xs, p["mix_g"]) @ p["wg"])
    xw = _mix(x, xs, p["mix_w"])
    w_raw = p["decay_base"] + (torch.tanh(xw @ p["decay_lora_a"])
                               @ p["decay_lora_b"]).float()
    # the decay in (0, 1), rounded to the model dtype as the reference
    # hands it to its kernel
    w = torch.exp(-torch.exp(w_raw)).to(x.dtype)

    def hsplit(t):  # (B, S, H·hd) -> a (B, H, S, hd) view
        return t.view(b, s, h, hd).transpose(1, 2)

    if state is None:
        o, _ = wkv6(hsplit(r), hsplit(k), hsplit(v), hsplit(w), p["bonus"],
                    impl=impl)
    else:
        o, _ = wkv6(hsplit(r), hsplit(k), hsplit(v), hsplit(w), p["bonus"],
                    state["wkv"], impl=impl, s_out=state["wkv"])
    o = o.transpose(1, 2).reshape(b, s, h, hd)
    # per-head group norm
    o = rms_norm(o, None).reshape(b, s, d)
    o = o * p["head_norm"] * g
    if state is not None:
        state["tm_shift"].copy_(x[:, -1])
    return o @ p["wo"]


def channel_mix(x: torch.Tensor, p: dict,
                state: Optional[dict]) -> torch.Tensor:
    """x (B, S, D), the block's second normed input; `state["cm_shift"]`
    is read and then updated in place (None: zeros, nothing written)."""
    xs = _shift(x, None if state is None else state["cm_shift"])
    k = torch.square(F.relu(_mix(x, xs, p["mix_k"]) @ p["wk"]))
    r = torch.sigmoid(_mix(x, xs, p["mix_r"]) @ p["wr"])
    if state is not None:
        state["cm_shift"].copy_(x[:, -1])
    return r * (k @ p["wv"])


def block_apply(x: torch.Tensor, p: dict, cfg: ModelConfig,
                state: Optional[dict], *,
                impl: str = "auto") -> torch.Tensor:
    x = x + time_mix(rms_norm(x, p["ln1"]), p["tm"], cfg, state, impl=impl)
    return x + channel_mix(rms_norm(x, p["ln2"]), p["cm"], state)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            state: Optional[dict] = None, *, impl: str = "auto") -> tuple:
    """tokens (B, S); `state` the stacked decode state (`init_state`),
    updated in place, or None (the training forward: no state read or
    written). Returns (final-normed hidden (B, S, D), state). `impl`
    picks the WKV route ('auto' | 'kernel' | 'ref'). Under grad with
    `cfg.remat`, each block is recomputed in the backward
    (`layers.remat`): K3 launches twice a layer a training step."""
    x = params["embed"][tokens].to(dtype_of(cfg))
    x = rms_norm(x, params["ln_in"])
    for i in range(cfg.n_layers):
        bp = layer_slice(params["blocks"], i)
        x = remat(cfg, block_apply, x, bp, cfg, layer_slice(state, i),
                  impl=impl)
    return rms_norm(x, params["final_norm"]), state


def init_state(batch: int, cfg: ModelConfig, device=None) -> dict:
    h, hd = _heads(cfg)
    dt = dtype_of(cfg)
    return {
        "tm_shift": torch.zeros((cfg.n_layers, batch, cfg.d_model),
                                dtype=dt, device=device),
        "cm_shift": torch.zeros((cfg.n_layers, batch, cfg.d_model),
                                dtype=dt, device=device),
        "wkv": torch.zeros((cfg.n_layers, batch, h, hd, hd),
                           dtype=torch.float32, device=device),
    }
