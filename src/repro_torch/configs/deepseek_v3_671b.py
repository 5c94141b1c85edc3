"""deepseek-v3-671b [moe] — MLA attention (latent kv cache), 1 shared + 256
routed experts top-8 (sigmoid scoring), first 3 layers dense, MTP head.
[arXiv:2412.19437]

`fsdp=True` is the reference's TPU sharding switch; the port keeps the
field for parity and ignores it. The 61 layers' weights (671 B
parameters) do not fit one card: `chip_smoke.py` serves the three dense
layers and one MoE layer, `with_(n_layers=4)`, at full width.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,          # qk_nope + qk_rope
    d_ff=2048,             # per-expert hidden (fine-grained experts)
    vocab_size=129280,
    citation="arXiv:2412.19437",
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    first_dense_layers=3,
    router_scoring="sigmoid",
    capacity_factor=1.0,
    mtp=True,
    fsdp=True,
)
