"""gemma-7b [dense] — GeGLU, head_dim=256 (q_dim > d_model), MHA (kv=16).
[arXiv:2403.08295]

`fsdp=True` is the reference's TPU sharding switch; the port keeps the
field for parity and ignores it: the 8.54 B parameters (17.1 GB in bf16)
fit one card whole.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    citation="arXiv:2403.08295",
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    fsdp=True,
)
