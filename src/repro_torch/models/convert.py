"""Carry the reference's parameters into the port.

`params_from_reference` turns the JAX package's parameter tree, with
numpy leaves (e.g. `jax.tree.map(np.asarray, params)`), into the port's:
the same nested dicts and names, the same stacked leading layer
dimension, torch tensors on `device`. `None` leaves (the non-parametric
norms) stay `None`. Every leaf keeps its shape and dtype: the MoE
layers' f32 router and `router_bias` and stacked (layers, experts, ·, ·)
expert weights, MLA's `kv_b_k` and `kv_b_v` as (layers, H, rank, ·), and
deepseek-v3's unstacked `mtp` head.

bf16 arrays come out of JAX as `ml_dtypes.bfloat16`, which
`torch.from_numpy` refuses; their bits go through a 16-bit integer view
(`int16`, which every torch build takes) and are reinterpreted as
`torch.bfloat16`.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy that torch may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(tree, device="cpu"):
    """The reference's parameter tree (numpy leaves) as the port's."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return _tensor(tree, device)
