"""pixtral-12b [vlm] — mistral-nemo-style decoder consuming Pixtral-ViT
patch embeddings; the vision encoder + projector is a stub supplying patch
embeddings (assignment carve-out). [hf:mistralai/Pixtral-12B-2409]

`fsdp=True` is the reference's TPU sharding switch; the port keeps the
field for parity and ignores it: the weights fit one card whole.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    citation="hf:mistralai/Pixtral-12B-2409",
    rope_theta=1000000.0,
    n_patches=1024,        # stub: e.g. 4 images x 256 patches
    fsdp=True,
)
