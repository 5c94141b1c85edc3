"""minitron-4b [dense] — width/depth-pruned Nemotron-4: squared-ReLU MLP,
GQA. [arXiv:2407.14679]

`fsdp=True` is the reference's TPU sharding switch; the port keeps the
field for parity and ignores it: the 4.19 B parameters (8.4 GB in bf16)
fit one card whole.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    citation="arXiv:2407.14679",
    act="relu2",
    fsdp=True,
    glu=False,
    rope_theta=10000.0,
)
