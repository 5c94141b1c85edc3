"""Plain PyTorch version of the OTA edge aggregation (paper Eq. 8).

The counterpart of `repro.kernels.ota.ref.ota_edge_aggregate_ref`, batched:
`grads (B, N, d)`, `gains (B, N)`, `noise (B, d)` and optional counts
`n_true (B,)` -> `(B, d)`; the unbatched `(N, d)` form is B = 1. With an
antenna axis, `gains (B, M, N)` and `noise (B, M, d)` -> `(B, M, d)`: M
aggregations of one trajectory's gradients, each divided by its count.
The CPU tests compare it with the JAX oracle and the Pallas kernel; on the
card `chip_smoke.py` compares the CUDA kernel with it.
"""
from __future__ import annotations

from typing import Optional

import torch


def ota_edge_aggregate_ref(grads: torch.Tensor, gains: torch.Tensor,
                           noise: torch.Tensor, *, noise_scale,
                           out_dtype=None,
                           n_true: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """v = (Σ_n h_n g_n) / N + noise_scale · w, accumulated in f32 (f64
    for f64 grads) and cast to `out_dtype` (default: grads.dtype). N is
    `n_true`, one count per trajectory (`(B,)` for batched grads), or the
    node-axis length when None. Gains of `grads.dim()` dimensions carry an
    antenna axis (`(B, M, N)`). `noise_scale` is a float or a tensor
    broadcasting against `noise`."""
    if out_dtype is None:
        out_dtype = grads.dtype
    acc = torch.promote_types(grads.dtype, torch.float32)
    g, h = grads.to(acc), gains.to(acc)
    antennas = h.dim() == g.dim()
    if antennas:
        v = torch.einsum("bmn,bnd->bmd", h, g)
    else:
        v = torch.einsum("...n,...nd->...d", h, g)
    if n_true is None:
        v = v / grads.shape[-2]
    else:
        n = n_true.to(acc)[..., None]
        v = v / (n[..., None] if antennas else n)
    return (v + noise_scale * noise.to(acc)).to(out_dtype)
