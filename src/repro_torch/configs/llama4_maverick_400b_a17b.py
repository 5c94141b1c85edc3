"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, interleaved dense/MoE
layers with chunked local attention, early-fusion backbone.
[hf:meta-llama/Llama-4-Scout-17B-16E / Llama-4-Maverick-17B-128E]

`fsdp=True` is the reference's TPU sharding switch; the port keeps the
field for parity and ignores it. The 48 layers' weights (400 B
parameters) do not fit one card: `chip_smoke.py` serves the first
(local dense, global MoE) pair, `with_(n_layers=2)`, at full width.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    rope_theta=500000.0,
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
    moe_layer_step=2,          # MoE every other layer
    sliding_window=8192,       # chunked local attention on dense layers
    capacity_factor=1.25,
    fsdp=True,
)
