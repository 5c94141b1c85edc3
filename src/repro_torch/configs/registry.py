"""Architecture registry: `--arch <id>` resolution (port of
`repro.configs.registry`).

The port knows every architecture of the reference: the dense decoders
olmo-1b, repro-100m, gemma2-9b, gemma-7b and minitron-4b, the RWKV6
model rwkv6-7b, the hybrid hymba-1.5b, the encoder-decoder
whisper-small, the VLM backbone pixtral-12b and the MoE models
llama4-maverick-400b-a17b and deepseek-v3-671b (with MLA). An id in
`PENDING` (none now) raises `NotImplementedError` naming the ROADMAP item
that ports it; an unknown id raises `KeyError`, as in the reference.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "gemma-7b": "gemma_7b",
    "gemma2-9b": "gemma2_9b",
    "hymba-1.5b": "hymba_1p5b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "minitron-4b": "minitron_4b",
    "olmo-1b": "olmo_1b",
    "pixtral-12b": "pixtral_12b",
    "repro-100m": "repro_100m",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-small": "whisper_small",
}

# architectures of the reference not ported yet -> the ROADMAP item that
# ports them (none: S4 and S5 were the last)
PENDING: dict = {}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in PENDING:
        raise NotImplementedError(
            f"arch '{arch_id}' is not ported yet (ROADMAP "
            f"{PENDING[arch_id]}); the port serves {sorted(_MODULES)}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: "
                       f"{sorted({*_MODULES, *PENDING})}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
