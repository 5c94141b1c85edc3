"""Serving engine: batched prefill + greedy/temperature decode (port of
`repro.serving.engine`).

`Engine.generate` runs one prefill over the prompt, then
`max_new_tokens` decode steps at positions p0, p0 + 1, …, p0 =
prompt_len + n_patches + meta_tokens (the VLM's patches and hymba's meta
tokens precede the prompt), exactly as the reference does (its last step's token is drawn and
dropped, so the key schedule matches). Greedy decoding is `argmax`. With
`temperature > 0` a token is `jax.random.categorical(key, logits / T)`
reproduced on the port's threefry (`core.rng`): JAX's default "low"
Gumbel mode, -log(-log(u)) with u uniform in [tiny, 1), added to the
scaled logits, then `argmax`; the key starts at `key(seed)` and is
folded with the step index after every decode step (skipped when
greedy: the key is then never read, and a fold is ~180 launches of the
eager threefry).

Under `sharding.specs.use_mesh(mesh)` (parameters from
`placement.shard_params`) the same loop serves on the mesh: the prompt's
rows placed by the batch rule, the model's mesh prefill and decode
(`models.meshed`) returning global logits on the mesh's first device,
where the tokens are drawn: one draw over the global (B, V) logits, as
the reference's one `categorical`, so the tokens are the unmeshed
engine's at the same key.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.models.model import Model

_F32_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0


class Engine:
    def __init__(self, model: Model, params: dict, serve_cfg: ServeConfig):
        self.model = model
        self.params = params
        self.cfg = serve_cfg

    def generate(self, batch: dict) -> torch.Tensor:
        """batch: {"tokens": (B, S) prompt ids} (with "frames" for
        whisper, "patch_embed" for the VLM). Returns (B, max_new_tokens)
        generated ids (int64, on the logits' device: the prompt's, or
        under a mesh its first entry's)."""
        cfg, m = self.cfg, self.model
        tokens = batch["tokens"]
        prompt_len = tokens.shape[1]
        pos0 = prompt_len + (m.cfg.n_patches or 0) + (m.cfg.meta_tokens or 0)
        logits, cache = m.prefill(self.params, batch,
                                  prompt_len + cfg.max_new_tokens)
        key = rng.key(cfg.seed, device=logits.device)
        out = []
        tok = self._sample(logits, key)
        for i in range(cfg.max_new_tokens):
            out.append(tok)
            logits, cache = m.decode_step(self.params, cache, tok, pos0 + i)
            if cfg.temperature > 0.0:  # greedy decoding reads no key
                key = rng.fold_in(key, i)
            tok = self._sample(logits, key)
        return torch.stack(out, dim=1)

    def _sample(self, logits: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        u = rng.uniform(key, logits.shape, minval=_F32_TINY, maxval=1.0)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(gumbel + logits / self.cfg.temperature, dim=-1)
