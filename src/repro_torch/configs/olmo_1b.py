"""olmo-1b [dense] — non-parametric LayerNorm, SwiGLU, tied embeddings.
[arXiv:2402.00838]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    citation="arXiv:2402.00838",
    norm="ln_nonparam",
    tie_embeddings=True,
)
