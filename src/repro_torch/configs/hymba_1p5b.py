"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer,
128 meta tokens, sliding-window attention with 3 global layers, ssm_state=16.
[arXiv:2411.13676]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    citation="arXiv:2411.13676",
    layer_pattern="hymba_global_set",
    global_layer_ids=(0, 15, 31),
    sliding_window=1024,
    ssm_state=16,
    ssm_conv=4,
    dt_rank=100,
    meta_tokens=128,
)
