"""Whisper-style encoder (port of `repro.models.encdec`).

The mel-spectrogram and conv frontend is a stub, as in the reference: the
encoder takes frame embeddings (B, enc_seq, D). Its layers attend without
a causal mask, each through K2 (`attention.sdpa(causal=False)`); its
output feeds the decoder's cross-attention (`transformer.cross_attn`).

The reference adds the sinusoidal positions as
`frames.astype(dtype) + pos.astype(frames.dtype)`, which is f32 when the
frames are f32, as its launcher draws them: the whole encoder then
computes in f32 against bf16 weights, and its attention takes K2's f32
kernel. The port does the same (`layers.matmul` promotes). The decoder
adds no positions of its own: the reference's docstring speaks of
sinusoidal decoder positions, but its code adds none (ROADMAP R6), and
the port follows the code.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_norm, dtype_of, layer_slice,
                                       mlp_apply, mlp_params, norm_param,
                                       remat, sinusoidal_positions)


def encoder_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The encoder's blocks, stacked on the layer dimension, and its final
    norm, in the reference's layout."""
    lead = (cfg.n_enc_layers,)
    return {
        "blocks": {"ln1": norm_param(cfg, *lead, device=gen.device),
                   "ln2": norm_param(cfg, *lead, device=gen.device),
                   "attn": attn_mod.attention_params(gen, cfg, lead=lead),
                   "mlp": mlp_params(gen, cfg, lead=lead)},
        "final_norm": norm_param(cfg, device=gen.device),
    }


def encoder_forward(params: dict, frames: torch.Tensor, cfg: ModelConfig,
                    impl: str = "auto") -> torch.Tensor:
    """frames (B, S_enc, D) -> encoder states (B, S_enc, D), in f32 when
    the frames are f32 (JAX's promotion of bf16 + f32). Under grad with
    `cfg.remat`, each layer is recomputed in the backward
    (`layers.remat`)."""
    s = frames.shape[1]
    positions = torch.arange(s, device=frames.device)
    pos = sinusoidal_positions(positions, cfg.d_model)
    x = frames.to(dtype_of(cfg)) + pos[None].to(frames.dtype)

    def block(x, bp):
        h = apply_norm(x, bp["ln1"], cfg)
        a, _ = attn_mod.attn_apply(h, bp["attn"], cfg, positions=positions,
                                   causal=False, impl=impl)
        x = x + a
        h = apply_norm(x, bp["ln2"], cfg)
        return x + mlp_apply(h, bp["mlp"], cfg)

    for i in range(cfg.n_enc_layers):
        x = remat(cfg, block, x, layer_slice(params["blocks"], i))
    return apply_norm(x, params.get("final_norm"), cfg)
