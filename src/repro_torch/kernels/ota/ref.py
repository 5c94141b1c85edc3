"""Plain PyTorch version of the OTA edge aggregation (paper Eq. 8).

The counterpart of `repro.kernels.ota.ref.ota_edge_aggregate_ref`, batched:
`grads (B, N, d)`, `gains (B, N)`, `noise (B, d)` -> `(B, d)`; the
unbatched `(N, d)` form is B = 1. The CPU tests compare it with the JAX
oracle and the Pallas kernel; on the card `chip_smoke.py` compares the
CUDA kernel with it.
"""
from __future__ import annotations

import torch


def ota_edge_aggregate_ref(grads: torch.Tensor, gains: torch.Tensor,
                           noise: torch.Tensor, *, noise_scale,
                           out_dtype=None) -> torch.Tensor:
    """v = (Σ_n h_n g_n) / N + noise_scale · w, accumulated in f32 and
    cast to `out_dtype` (default: grads.dtype); N is the node-axis length.
    `noise_scale` is a float or a tensor broadcasting against `noise`."""
    if out_dtype is None:
        out_dtype = grads.dtype
    n = grads.shape[-2]
    v = torch.einsum("...n,...nd->...d", gains.to(torch.float32),
                     grads.to(torch.float32)) / n
    return (v + noise_scale * noise.to(torch.float32)).to(out_dtype)
