"""Model API for serving and training (port of `repro.models.model`):

    model = build_model(cfg)                       # raises outside the slice
    params = model.init_params()                   # seed 0, on the card
    logits, cache = model.prefill(params, batch, max_len)
    logits, cache = model.decode_step(params, cache, token, pos)
    losses, metrics = model.train_loss_per_example(params, batch)

Two kinds are ported, both served and trained: "transformer" (the dense
decoder, with gemma2's sliding windows, softcaps and sandwich norms,
gemma's embedding scale and qk-norm) and "rwkv" (the RWKV6 model of
`family == "ssm"`). The cache — the dense decoder's KV cache, one per
sublayer, or RWKV's recurrent state — is updated in place:
`decode_step` writes into the cache it is given and returns that same
object.

`impl` picks the route of the kind's own kernel (prefill attention for
the dense decoder, the WKV recurrence for RWKV): 'auto' (the CUDA kernel
on the card, its plain version on the CPU), 'kernel' or 'ref' (the plain
version, on any device) — the last lets the card compare the two routes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv
from repro_torch.models import transformer as tfm

_IMPLS = ("auto", "kernel", "ref")


class Model:
    """The dense decoder and RWKV6 behind the reference's
    family-dispatching façade; the other families raise naming their
    ROADMAP item."""

    def __init__(self, cfg: ModelConfig, impl: str = "auto"):
        if cfg.family == "hybrid":
            raise NotImplementedError(
                f"{cfg.arch_id}: the hymba hybrid model is not ported yet "
                "(ROADMAP S6)")
        if cfg.family == "encdec":
            raise NotImplementedError(
                f"{cfg.arch_id}: encoder-decoder models are not ported yet "
                "(ROADMAP S7)")
        if impl not in _IMPLS:
            raise ValueError(
                f"impl must be 'auto', 'kernel' or 'ref', got {impl!r}")
        self.kind = "rwkv" if cfg.family == "ssm" else "transformer"
        if self.kind == "transformer":
            tfm.check_slice(cfg)
        self.cfg = cfg
        self.impl = impl

    def init_params(self, generator: Optional[torch.Generator] = None, *,
                    device: DeviceLike = None) -> dict:
        """Random parameters drawn from `generator`, on its device; by
        default from a generator seeded 0 on `device` (None: the CUDA
        card, raising without one)."""
        if generator is None:
            generator = torch.Generator(
                device=resolve_device(device)).manual_seed(0)
        if self.kind == "rwkv":
            return rwkv.init_params(generator, self.cfg)
        return tfm.init_decoder(generator, self.cfg)

    def train_loss_per_example(self, params, batch) -> tuple:
        """Per-example losses (B,) of next-token prediction on
        `batch["tokens"]` (B, S+1), plus metrics {"loss", "aux_loss"}
        (neither kind has a router: aux is 0). Differentiable in
        `params`; the attention's backward is the flash backward, the
        WKV's the hand-written backward (its plain version on the CPU)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        s = inputs.shape[1]
        if self.kind == "rwkv":
            h, _ = rwkv.forward(params, inputs, cfg, impl=self.impl)
        else:
            x = tfm.embed_tokens(params, inputs, cfg)
            h, _ = tfm.decoder_forward(
                params, x, cfg,
                positions=torch.arange(s, device=tokens.device),
                impl=self.impl)
        losses = tfm.chunked_xent(params, h, labels,
                                  torch.ones_like(labels), cfg)
        aux = torch.zeros((), dtype=torch.float32, device=losses.device)
        metrics = {"loss": torch.mean(losses.detach()), "aux_loss": aux}
        return losses + cfg.router_aux_weight * aux, metrics

    def init_cache(self, batch: int, cache_len: int, device=None) -> dict:
        """The KV cache of `cache_len` positions (min(window, cache_len)
        on a windowed sublayer, a ring buffer), or RWKV's O(1) state
        (`cache_len` unused)."""
        if self.kind == "rwkv":
            return rwkv.init_state(batch, self.cfg, device=device)
        return tfm.init_decoder_cache(batch, cache_len, self.cfg,
                                      device=device)

    @torch.no_grad()
    def prefill(self, params: dict, batch: dict,
                max_len: Optional[int] = None) -> tuple:
        """Processes the prompt `batch["tokens"]` (B, S); returns
        (last-position logits (B, V) f32, cache). `max_len` sizes the KV
        cache beyond the prompt for later decode steps (RWKV's state has
        no length)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        if self.kind == "rwkv":
            h, state = rwkv.forward(
                params, tokens, self.cfg,
                rwkv.init_state(b, self.cfg, device=tokens.device),
                impl=self.impl)
            return tfm.logits_fn(params, h[:, -1:], self.cfg)[:, 0], state
        cache = self.init_cache(b, max(max_len or 0, s),
                                device=tokens.device)
        x = tfm.embed_tokens(params, tokens, self.cfg)
        h, cache = tfm.decoder_forward(
            params, x, self.cfg,
            positions=torch.arange(s, device=tokens.device), cache=cache,
            impl=self.impl)
        return tfm.logits_fn(params, h[:, -1:], self.cfg)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    pos: int) -> tuple:
        """One-token decode: token (B,), `pos` the absolute position (an
        int; RWKV reads none). Returns (logits (B, V) f32, the cache,
        updated in place)."""
        if self.kind == "rwkv":
            h, cache = rwkv.forward(params, token[:, None], self.cfg, cache,
                                    impl=self.impl)
            return tfm.logits_fn(params, h, self.cfg)[:, 0], cache
        x = tfm.embed_tokens(params, token[:, None], self.cfg)
        h, cache = tfm.decoder_forward(
            params, x, self.cfg,
            positions=torch.full((1,), pos, device=token.device),
            cache=cache,
            decode_pos=int(pos), impl=self.impl)
        return tfm.logits_fn(params, h, self.cfg)[:, 0], cache


def build_model(cfg: ModelConfig, impl: str = "auto") -> Model:
    return Model(cfg, impl=impl)
