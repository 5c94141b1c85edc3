"""Model API for serving and training (port of `repro.models.model`):

    model = build_model(cfg)                       # raises outside the slice
    params = model.init_params()                   # seed 0, on the card
    logits, cache = model.prefill(params, batch, max_len)
    logits, cache = model.decode_step(params, cache, token, pos)
    losses, metrics = model.train_loss_per_example(params, batch)
    shapes = model.params_shape()                  # meta tensors

Four kinds are ported: "transformer" (the decoder, with gemma2's
sliding windows, softcaps and sandwich norms, gemma's embedding scale and
qk-norm, the int8 cache, the VLM backbone, whose patch embeddings
`batch["patch_embed"]` are prepended to the prompt, and the MoE stacks of
llama4-maverick and deepseek-v3, the latter with MLA attention and an MTP
head that only the training loss reads), "rwkv" (the RWKV6
model of `family == "ssm"`), "hymba" (`family == "hybrid"`: attention and
SSM heads in parallel, meta tokens prepended at prefill) and "encdec"
(whisper: the encoder over `batch["frames"]`, the decoder with its
cross-attention). The cache — the KV caches, one per sublayer, with the
SSM states (hymba) or the cross-attention K and V (encdec), or RWKV's
recurrent state — is updated in place: `decode_step` writes into the
cache it is given and returns that same object.

`impl` picks the route of the kind's own kernel (prefill attention, the
WKV recurrence for RWKV): 'auto' (the CUDA kernel on the card, its plain
version on the CPU), 'kernel' or 'ref' (the plain version, on any
device) — the last lets the card compare the two routes.

Under `sharding.specs.use_mesh(mesh)`, with parameters from
`sharding.placement.shard_params`, `init_cache`, `prefill` and
`decode_step` serve the dense decoder on the mesh (`models.meshed`):
each KV cache leaf a `Sharded` placed by the reference's `cache_spec`,
the logits global, on the mesh's first device. Other families raise
`NotImplementedError` there (ROADMAP M12c).

The VLM prefill sizes its cache at n_patches + max(max_len, S): the
reference's max(max_len, n_patches + S) is too short by n_patches when
max_len counts the new tokens, so its first decode overwrites patch 0's
key (ROADMAP §3 F15).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, meshed, rwkv
from repro_torch.models import ssm as hymba
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, matmul, remat
from repro_torch.sharding import specs

_IMPLS = ("auto", "kernel", "ref")
# the weight of deepseek-v3's multi-token-prediction loss, the reference's
MTP_WEIGHT = 0.3


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# the reference's input shapes (`launch.analytic.model_flops` reads them)
SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# the tensor factories of the initializers, which `_MetaInit` sends to
# the meta device
_FACTORIES = {torch.rand, torch.randn, torch.empty, torch.zeros,
              torch.ones, torch.full, torch.arange}


class _MetaInit(TorchFunctionMode):
    """Runs an initializer on the meta device: every tensor factory makes
    a meta tensor (shape and dtype, no storage) and its generator is
    dropped, so the ops after it compute shapes only."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _FACTORIES:
            kwargs.pop("generator", None)
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


class Model:
    """The reference's family-dispatching façade."""

    def __init__(self, cfg: ModelConfig, impl: str = "auto"):
        if impl not in _IMPLS:
            raise ValueError(
                f"impl must be 'auto', 'kernel' or 'ref', got {impl!r}")
        self.kind = {"ssm": "rwkv", "hybrid": "hymba",
                     "encdec": "encdec"}.get(cfg.family, "transformer")
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
        if self.kind == "hymba":
            return hymba.init_params(generator, self.cfg)
        if self.kind == "encdec":
            p = tfm.init_decoder(generator, self.cfg, cross_attn=True)
            p["encoder"] = encdec.encoder_params(generator, self.cfg)
            return p
        return tfm.init_decoder(generator, self.cfg)

    def params_shape(self) -> dict:
        """The parameter tree as meta tensors: each leaf's shape and dtype,
        nothing allocated or drawn (the reference's `jax.eval_shape` of
        `init_params`), so deepseek-v3's 671 B parameters take a moment
        on any host."""
        with _MetaInit():
            return self.init_params(torch.Generator(device="cpu"))

    def train_loss_per_example(self, params, batch) -> tuple:
        """Per-example losses (B,) of next-token prediction on
        `batch["tokens"]` (B, S+1) plus `router_aux_weight` times the MoE
        layers' summed aux loss, and metrics {"loss": the mean loss before
        the aux term, "aux_loss"}; with `cfg.mtp`, deepseek-v3's
        multi-token prediction loss times MTP_WEIGHT is added to each
        example's (`_mtp_loss`). Hymba prepends its meta
        tokens, the VLM `batch["patch_embed"]`, and neither is predicted;
        whisper's decoder attends over the encoder's states of
        `batch["frames"]`. Differentiable in `params`; the attention's
        backward is the flash backward, the WKV's the hand-written
        backward (its plain version on the CPU)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        if self.kind == "rwkv":
            h, _ = rwkv.forward(params, inputs, cfg, impl=self.impl)
        elif self.kind == "hymba":
            h, _ = hymba.forward(params, inputs, cfg, prepend_meta=True,
                                 impl=self.impl)
            h = h[:, cfg.meta_tokens:]
        else:
            enc = None
            if self.kind == "encdec":
                enc = encdec.encoder_forward(params["encoder"],
                                             batch["frames"], cfg, self.impl)
            x = tfm.embed_tokens(params, inputs, cfg)
            if cfg.n_patches:  # VLM: patches prepended, not predicted
                x = torch.cat([batch["patch_embed"].to(x.dtype), x], dim=1)
            h, _, aux = tfm.decoder_forward(
                params, x, cfg,
                positions=torch.arange(x.shape[1], device=tokens.device),
                enc_out=enc, impl=self.impl)
            h = h[:, cfg.n_patches:]
        losses = tfm.chunked_xent(params, h, labels,
                                  torch.ones_like(labels), cfg)
        if cfg.mtp:  # deepseek-v3 multi-token prediction (k = 1)
            losses = losses + MTP_WEIGHT * self._mtp_loss(params, h, inputs,
                                                          labels)
        metrics = {"loss": torch.mean(losses.detach()),
                   "aux_loss": aux.detach()}
        return losses + cfg.router_aux_weight * aux, metrics

    def _mtp_loss(self, params, h, inputs, labels) -> torch.Tensor:
        """Per-example loss of predicting token t + 2 with the MTP head
        from (h_t, the embedding of token t + 1): both normed, joined,
        projected to d_model, through one dense sublayer, then the shared
        unembedding. Under `cfg.remat` the whole head is recomputed in the
        backward (`layers.remat`), as the reference's `jax.checkpoint`."""
        return remat(self.cfg, self._mtp_loss_inner, params, h, inputs,
                     labels)

    def _mtp_loss_inner(self, params, h, inputs, labels) -> torch.Tensor:
        cfg = self.cfg
        mp = params["mtp"]
        h_in = apply_norm(h[:, :-1], mp["norm_h"], cfg)
        e_in = apply_norm(tfm.embed_tokens(params, inputs[:, 1:], cfg),
                          mp["norm_e"], cfg)
        z = matmul(torch.cat([h_in, e_in], dim=-1), mp["proj"])
        z, _ = tfm.sublayer_apply(
            z, mp["block"], tfm.SubLayer("dense", None), cfg,
            positions=torch.arange(z.shape[1], device=z.device),
            impl=self.impl)
        return tfm.chunked_xent(params, z, labels[:, 1:],
                                torch.ones_like(labels[:, 1:]), cfg)

    def init_cache(self, batch: int, cache_len: int, device=None) -> dict:
        """The KV cache of `cache_len` positions (min(window, cache_len)
        on a windowed sublayer, a ring buffer; every hymba layer at the
        full length, with its SSM states; whisper's with the
        cross-attention K and V), or RWKV's O(1) state (`cache_len`
        unused). Under `use_mesh`, the decoder's cache placed on the
        mesh (`device` unused)."""
        mesh = specs.current_mesh()
        if mesh is not None:
            return meshed.init_cache(self, batch, cache_len, mesh)
        if self.kind == "rwkv":
            return rwkv.init_state(batch, self.cfg, device=device)
        if self.kind == "hymba":
            return hymba.init_cache(batch, cache_len, self.cfg,
                                    device=device)
        return tfm.init_decoder_cache(batch, cache_len, self.cfg,
                                      device=device,
                                      cross_attn=self.kind == "encdec")

    @torch.no_grad()
    def prefill(self, params: dict, batch: dict,
                max_len: Optional[int] = None) -> tuple:
        """Processes the prompt `batch["tokens"]` (B, S) (with
        `batch["frames"]` for whisper, `batch["patch_embed"]` for the
        VLM); returns (last-position logits (B, V) f32, cache). `max_len`
        sizes the KV cache beyond the prompt for later decode steps;
        hymba's meta tokens and the VLM's patches come on top (RWKV's
        state has no length)."""
        mesh = specs.current_mesh()
        if mesh is not None:
            return meshed.prefill(self, params, batch, max_len, mesh)
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        dev = tokens.device
        clen = max(max_len or 0, s)
        if self.kind == "rwkv":
            h, state = rwkv.forward(
                params, tokens, cfg, rwkv.init_state(b, cfg, device=dev),
                impl=self.impl)
            return tfm.logits_fn(params, h[:, -1:], cfg)[:, 0], state
        if self.kind == "hymba":
            cache = hymba.init_cache(b, clen + cfg.meta_tokens, cfg,
                                     device=dev)
            h, cache = hymba.forward(params, tokens, cfg, cache=cache,
                                     prepend_meta=True, impl=self.impl)
            return tfm.logits_fn(params, h[:, -1:], cfg)[:, 0], cache
        enc = None
        if self.kind == "encdec":
            enc = encdec.encoder_forward(params["encoder"], batch["frames"],
                                         cfg, self.impl)
        x = tfm.embed_tokens(params, tokens, cfg)
        if cfg.n_patches and "patch_embed" in batch:
            x = torch.cat([batch["patch_embed"].to(x.dtype), x], dim=1)
            clen += cfg.n_patches
        cache = tfm.init_decoder_cache(
            b, clen, cfg, device=dev, cross_attn=enc is not None,
            cross_dtype=None if enc is None else enc.dtype)
        h, cache, _ = tfm.decoder_forward(
            params, x, cfg, positions=torch.arange(x.shape[1], device=dev),
            cache=cache, enc_out=enc, impl=self.impl)
        return tfm.logits_fn(params, h[:, -1:], cfg)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    pos: int) -> tuple:
        """One-token decode: token (B,), `pos` the absolute position (an
        int, counting hymba's meta tokens and the VLM's patches; RWKV
        reads none). Returns (logits (B, V) f32, the cache, updated in
        place)."""
        mesh = specs.current_mesh()
        if mesh is not None:
            return meshed.decode_step(self, params, cache, token, pos, mesh)
        if self.kind == "rwkv":
            h, cache = rwkv.forward(params, token[:, None], self.cfg, cache,
                                    impl=self.impl)
            return tfm.logits_fn(params, h, self.cfg)[:, 0], cache
        if self.kind == "hymba":
            h, cache = hymba.forward(params, token[:, None], self.cfg,
                                     cache=cache, decode_pos=int(pos),
                                     impl=self.impl)
            return tfm.logits_fn(params, h, self.cfg)[:, 0], cache
        x = tfm.embed_tokens(params, token[:, None], self.cfg)
        h, cache, _ = tfm.decoder_forward(
            params, x, self.cfg,
            positions=torch.full((1,), pos, device=token.device),
            cache=cache,
            decode_pos=int(pos), impl=self.impl)
        return tfm.logits_fn(params, h, self.cfg)[:, 0], cache


def build_model(cfg: ModelConfig, impl: str = "auto") -> Model:
    return Model(cfg, impl=impl)
