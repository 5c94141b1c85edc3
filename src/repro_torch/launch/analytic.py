"""Analytic model FLOPs (port of `repro.launch.analytic`): 6·N·D a
training step and 2·N·D an inference pass over the active parameters
(MoE experts at top_k / n_experts), plus the attention term with
windowed layers at their window, MLA's head widths and hymba's SSM
branch. The useful compute a measured step is set against
(`launch.analysis.RooflineTerms`).

Pure arithmetic on the config and the parameter shapes
(`Model.params_shape`: meta tensors, nothing allocated), in the
reference's order of operations, so the numbers equal its numbers.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import InputShape, Model
from repro_torch.models.transformer import build_segments


def _named_leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, paths joined by '/' as the
    reference names them; None leaves (parameter-free norms) are no
    leaves, as in a JAX tree."""
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _named_leaves(v, name)
        elif v is not None:
            yield name, v


def param_counts(model: Model) -> tuple:
    """(total parameters, active parameters a token): the leaves named
    `experts_*` count at top_k / n_experts."""
    cfg = model.cfg
    total = 0
    expert = 0
    for name, leaf in _named_leaves(model.params_shape()):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
        if "experts_" in name:
            expert += n
    if cfg.n_experts:
        active = total - expert + expert * cfg.top_k // cfg.n_experts
    else:
        active = total
    return total, active


def _attention_flops(cfg: ModelConfig, batch: int, sq: int, skv: int,
                     causal: bool) -> float:
    """q·kᵀ and p·v FLOPs over the layers, windowed layers at their
    window (half the pairs under a causal mask); RWKV's recurrence at
    ~3·H·hd² MACs a token a layer; hymba's SSM branch on top."""
    if cfg.family == "ssm":
        h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
        return 2.0 * 3 * cfg.n_layers * batch * sq * h * hd * hd
    total = 0.0
    layers = []
    if cfg.family == "hybrid":  # hymba: every layer attention + SSM
        for i in range(cfg.n_layers):
            w = None if i in cfg.global_layer_ids else cfg.sliding_window
            layers.append(w)
    else:
        for seg in build_segments(cfg):
            for _ in range(seg.n_steps):
                for sub in seg.subs:
                    layers.append(sub.window)
    hd = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.use_mla else cfg.head_dim
    hv = cfg.v_head_dim if cfg.use_mla else cfg.head_dim
    for w in layers:
        eff = min(w, skv) if w else skv
        kv_per_q = eff * (0.5 if (causal and sq > 1) else 1.0)
        total += 2.0 * batch * sq * kv_per_q * cfg.n_heads * (hd + hv)
    if cfg.family == "hybrid":  # the SSM branch
        total += (2.0 * 3 * cfg.n_layers * batch * sq * cfg.d_model
                  * cfg.ssm_state)
    return total


def model_flops(model: Model, shape: InputShape, chips: int) -> float:
    """Analytic FLOPs a device for one step of `shape`: training 6·N·D
    plus 3× the attention term, prefill 2·N·D plus it, decode one token
    a sequence against a seq_len cache."""
    cfg = model.cfg
    _, active = param_counts(model)
    b = shape.global_batch
    if shape.kind == "train":
        tokens = b * shape.seq_len
        f = 6.0 * active * tokens
        f += 3.0 * _attention_flops(cfg, b, shape.seq_len, shape.seq_len,
                                    True)
    elif shape.kind == "prefill":
        tokens = b * shape.seq_len
        f = 2.0 * active * tokens
        f += _attention_flops(cfg, b, shape.seq_len, shape.seq_len, True)
    else:  # decode: one token against a seq_len cache
        f = 2.0 * active * b
        f += _attention_flops(cfg, b, 1, shape.seq_len, False)
    return f / chips
