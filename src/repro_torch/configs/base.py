"""ModelConfig — the single config dataclass all architectures instantiate."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    # --- attention variants -------------------------------------------------
    rope_theta: float = 10000.0
    use_rope: bool = True  # whisper uses sinusoidal absolute positions instead
    attn_softcap: Optional[float] = None  # gemma2 attn logit softcap (50.0)
    final_softcap: Optional[float] = None  # gemma2 final logit softcap (30.0)
    sliding_window: Optional[int] = None  # window for 'local' layers
    layer_pattern: str = "global"  # global | alt_local_global | hymba_global_set
    global_layer_ids: Tuple[int, ...] = ()  # for hymba_global_set
    qk_norm: bool = False

    # --- norm & mlp ----------------------------------------------------------
    norm: str = "rms"  # rms | ln_nonparam
    act: str = "silu"  # silu | gelu | relu2
    glu: bool = True
    norm_style: str = "pre"  # pre | sandwich (gemma2 pre+post norms)
    embed_scale: bool = False  # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = False

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    moe_layer_step: int = 1  # MoE every k-th layer within the stack
    first_dense_layers: int = 0  # deepseek-v3: first 3 layers dense
    moe_d_ff: Optional[int] = None  # expert hidden dim if != d_ff
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_scoring: str = "softmax"  # softmax | sigmoid (deepseek-v3)

    # --- MLA (deepseek-v3) ---------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False  # multi-token prediction block (train loss only)

    # --- SSM / RWKV / hybrid ---------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    dt_rank: int = 0
    meta_tokens: int = 0  # hymba learned prefix tokens

    # --- encoder-decoder (whisper) --------------------------------------------
    n_enc_layers: int = 0
    enc_seq: int = 0  # stub frame count (1500)

    # --- VLM (pixtral) ---------------------------------------------------------
    n_patches: int = 0  # stub patch-embedding count prepended in train/prefill

    # --- compute / distribution ------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    fsdp: bool = False
    # --- §Perf hillclimb switches (default False = paper-faithful baseline) --
    opt_bf16_dispatch: bool = False  # MoE combine/dispatch in bf16 not f32
    opt_pad_heads: bool = False  # pad attention heads to the model-axis size
    opt_shardmap_moe: bool = False  # explicit all_to_all for the MoE reshard
    # (GSPMD falls back to replicate-then-repartition on the 3-axis mesh)
    opt_flash_vjp: bool = False  # flash custom-VJP attention backward
    # (saves (out, lse) instead of remat-recomputing the whole forward)
    opt_int8_cache: bool = False  # int8 KV cache (per-token-per-head scales)
    # — halves the decode memory roofline term
    logit_chunk: int = 1024
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    scan_layers: bool = True

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests
        (<=2 layers, d_model<=512, <=4 experts)."""
        d_model = min(self.d_model, 256)
        head_dim = min(self.head_dim, 32)
        n_heads = max(1, min(self.n_heads, 4))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        if n_heads % n_kv:
            n_kv = 1
        kw = dict(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            sliding_window=(min(self.sliding_window, 16)
                            if self.sliding_window else None),
            logit_chunk=64,
            attn_block_q=32,
            attn_block_kv=32,
            dtype="float32",
            fsdp=False,
            remat=False,
        )
        if self.n_experts:
            kw.update(
                n_experts=4,
                top_k=min(self.top_k, 2),
                first_dense_layers=min(self.first_dense_layers, 1),
                moe_d_ff=min(self.expert_ff, 256),
            )
        if self.use_mla:
            kw.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                      qk_rope_dim=16, v_head_dim=32, head_dim=48)
        if self.ssm_state:
            kw.update(dt_rank=max(8, d_model // 16))
        if self.n_enc_layers:
            kw.update(n_enc_layers=2, enc_seq=16)
        if self.n_patches:
            kw.update(n_patches=8)
        if self.meta_tokens:
            kw.update(meta_tokens=8)
        if self.global_layer_ids:
            kw.update(global_layer_ids=(0,))
        return self.with_(**kw)
