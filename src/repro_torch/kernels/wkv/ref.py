"""Plain PyTorch version of the RWKV6 WKV recurrence (port of
`repro.kernels.wkv.ref.wkv6_ref_naive`).

Per (batch·head), with the (D, D) state S (rows k-channels, columns
v-channels):

    o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

A Python loop over t on the f32 state, step for step as the reference's
per-step oracle. The reference's default `wkv6_ref` scans the same steps
in checkpointed chunks only so that its backward pass stores one state
per chunk instead of one per step; serving takes no gradient, so the port
has no use for it. The CPU tests use this version; on the card
`chip_smoke.py` compares the CUDA kernel with it, and nothing on the main
path calls it.
"""
from __future__ import annotations

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: torch.Tensor) -> tuple:
    """r, k, v, w (BH, T, D); u (BH, D); s0 (BH, D, D). Returns (o in r's
    dtype (BH, T, D), final state f32 (BH, D, D)); computed in f32."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[:, :, None]
    s = s0.float().clone()
    out = torch.empty(rf.shape, dtype=torch.float32, device=r.device)
    for t in range(r.shape[1]):
        kv = kf[:, t, :, None] * vf[:, t, None, :]  # (BH, D, D)
        out[:, t] = torch.einsum("bi,bij->bj", rf[:, t], s + uf * kv)
        s = wf[:, t, :, None] * s + kv
    return out.to(r.dtype), s
