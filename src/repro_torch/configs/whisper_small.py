"""whisper-small [audio] — encoder-decoder transformer backbone; the
mel+conv frontend is a stub supplying 1500 frame embeddings (assignment
carve-out). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="encdec",
    n_layers=12,          # decoder layers
    n_enc_layers=12,
    enc_seq=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    citation="arXiv:2212.04356",
    act="gelu",
    glu=False,
    use_rope=False,       # sinusoidal absolute positions
    tie_embeddings=True,
)
