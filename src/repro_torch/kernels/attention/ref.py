"""Plain PyTorch version of the flash-attention kernel (port of
`repro.kernels.attention.ref.attention_ref`).

Full-softmax attention that materializes the (Sq, Skv) score matrix, with
the kernel's masking and softcap semantics. Masked logits are set to
`NEG_INF = -1e30`, as in the reference, not to `-inf`: a row with no live
key then gets a uniform softmax instead of NaNs, the same values the
reference gives. The CPU tests compare it with the JAX oracle and the
Pallas kernel in interpret mode; on the card `chip_smoke.py` compares the
CUDA kernel with it.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  q_offset: int = 0, return_lse: bool = False):
    """q (BH, Sq, d), k and v (BH, Skv, d) -> (BH, Sq, d) in q's dtype,
    computed in f32. With `return_lse`, (out, lse): lse (BH, Sq) f32, the
    natural log-sum-exp of each row's masked (capped) scaled logits — a
    row with no live key gives NEG_INF + ln Skv, as the reference's."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    sq, skv = q.shape[1], k.shape[1]
    q_idx = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_idx = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_idx >= k_idx
    if window is not None:
        mask &= (q_idx - k_idx) < window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out
