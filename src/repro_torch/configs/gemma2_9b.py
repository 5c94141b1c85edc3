"""gemma2-9b [dense] — alternating local(4096)/global attention, attn+final
logit softcaps, sandwich norms, GeGLU. [arXiv:2408.00118]

`fsdp=True` is the reference's TPU sharding switch; the port keeps the
field for parity and ignores it: the 9.24 B parameters (18.5 GB in bf16)
fit one card whole.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    citation="arXiv:2408.00118",
    layer_pattern="alt_local_global",
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    norm_style="sandwich",
    embed_scale=True,
    act="gelu",
    tie_embeddings=True,
    fsdp=True,
)
