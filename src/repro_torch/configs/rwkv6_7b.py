"""rwkv6-7b [ssm] — Finch: attention-free, token-shift + data-dependent
per-channel decay WKV recurrence. [arXiv:2404.05892]

`fsdp=True` is the reference's TPU sharding switch; the port keeps the
field for parity and ignores it: the 7.5 B parameters (15.1 GB in bf16)
fit one card whole.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # wkv heads, head_dim 64
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    citation="arXiv:2404.05892",
    fsdp=True,
)
