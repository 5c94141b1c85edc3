"""repro-100m — ~110M-parameter dense decoder used by the end-to-end GBMA
training example (examples/train_100m.py) and integration tests."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="repro-100m",
    family="dense",
    n_layers=14,
    d_model=640,
    n_heads=10,
    n_kv_heads=10,
    head_dim=64,
    d_ff=2560,
    vocab_size=32000,
    citation="this repo",
    tie_embeddings=True,
    dtype="float32",
    remat=False,
    logit_chunk=256,
    attn_block_q=128,
    attn_block_kv=256,
)
