"""Public wrapper for the OTA edge aggregation (port of
`repro.kernels.ota.ops`).

`ota_edge_aggregate` dispatches on where the tensors live: a CUDA tensor
goes to the hand-written kernel (`kernel.py`) — or raises — and a CPU
tensor to the plain PyTorch version (`ref.py`). There is no fallback from
the kernel to the plain version on the card. `impl="ref"` asks for the
plain version explicitly on any device.

`launch_count` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ota import kernel
from repro_torch.kernels.ota.ref import ota_edge_aggregate_ref

launch_count = 0

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _launch(g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
            n_true, out_dtype) -> torch.Tensor:
    global launch_count
    if g.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the OTA kernel takes f32/bf16 grads and output, "
                         f"got grads {g.dtype}, out {out_dtype}")
    batch, _, d = g.shape
    if d > 1 and g.stride(2) != 1:
        raise ValueError("the OTA kernel reads (B, N, d) grads with "
                         f"contiguous columns, got strides {g.stride()}")
    if h.device != g.device or w.device != g.device or (
            n_true is not None and n_true.device != g.device):
        raise ValueError("grads, gains, noise and counts must share one "
                         "device")
    n_ant = h.shape[1]
    if batch * n_ant >= 2**31 or d >= 2**31:
        raise ValueError(f"the OTA kernel takes B*M < 2^31 and d < 2^31, "
                         f"got B={batch}, M={n_ant}, d={d}")
    out = torch.empty((batch, n_ant, d), dtype=out_dtype, device=g.device)
    if out.numel() == 0:
        return out
    counts = None if n_true is None \
        else n_true.to(torch.float32).contiguous()
    kernel.launch(g, h.to(torch.float32).contiguous(), w.contiguous(), out,
                  counts)
    launch_count += 1
    return out


def ota_edge_aggregate(grads: torch.Tensor, gains: torch.Tensor,
                       noise: torch.Tensor, *, noise_scale,
                       impl: str = "auto", out_dtype=None,
                       n_true: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """One OTA edge aggregation v = (1/N) Σ h_n g_n + noise_scale·w.

    Unbatched `grads (N, d)`, `gains (N,)`, `noise (d,)` -> `(d,)`;
    batched over trajectories: `(B, N, d)`, `(B, N)`, `(B, d)` -> `(B, d)`;
    or with an antenna axis: `(B, N, d)`, `(B, M, N)`, `(B, M, d)` ->
    `(B, M, d)`, the M receive antennas of trajectory b each aggregating
    its one copy of grads[b] with their own gains and noise. Each form is
    one kernel launch, and takes grads with contiguous columns and any
    row and batch strides (a column block of a wider matrix, as the
    channel-transport layer tiles a leaf) without a copy. N is `n_true`,
    each trajectory's own count as a `(B,)` tensor (a 0-d tensor
    unbatched) on the grads' device, or the node-axis length for every
    trajectory when None. A node-count sweep pads its node axis with zero
    gains and zero gradients and passes the true counts. `noise_scale` is
    a float or a tensor broadcasting against `noise`; it folds into the
    f32 noise operand.
    `out_dtype` (default grads.dtype) is the emission dtype of the f32
    accumulation.

    impl: 'auto' — the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; 'kernel' — the CUDA kernel (CUDA tensors only); 'ref' —
    the plain version.
    """
    if impl not in ("auto", "kernel", "ref"):
        raise ValueError(
            f"impl must be 'auto', 'kernel' or 'ref', got {impl!r}")
    if out_dtype is None:
        out_dtype = grads.dtype
    batched = grads.dim() == 3
    g = grads if batched else grads.unsqueeze(0)
    antennas = batched and gains.dim() == 3
    n_ant = gains.shape[1] if antennas else 1
    # the kernel's (B, M, N) / (B, M, d) operands; M = 1 without antennas
    h = gains if antennas else gains.unsqueeze(-2) if batched \
        else gains.reshape(1, 1, -1)
    counts = n_true if n_true is None or batched else n_true.reshape(1)
    noise_shape = (g.shape[0], n_ant, g.shape[2]) if antennas \
        else grads.shape[:-2] + grads.shape[-1:]
    if g.dim() != 3 or h.shape != (g.shape[0], n_ant, g.shape[1]) \
            or noise.shape != noise_shape \
            or (counts is not None and counts.shape != g.shape[:1]):
        raise ValueError(f"shape mismatch: grads {tuple(grads.shape)}, "
                         f"gains {tuple(gains.shape)}, noise "
                         f"{tuple(noise.shape)}, counts "
                         f"{None if n_true is None else tuple(n_true.shape)}")
    # the noise scale folds into the noise operand in f32 (as the TPU
    # wrapper does), so the kernel adds an already-scaled w
    w32 = noise_scale * noise.to(torch.float32)
    device = g.device.type
    if impl == "ref" or (impl == "auto" and device == "cpu"):
        return ota_edge_aggregate_ref(grads, gains, w32, noise_scale=1.0,
                                      out_dtype=out_dtype, n_true=n_true)
    if device != "cuda":
        raise ValueError(f"impl={impl!r}: the OTA kernel runs on CUDA "
                         f"tensors, got a {device} tensor (use impl='ref' "
                         "for the plain version)")
    out = _launch(g, h, w32.reshape(g.shape[0], n_ant, g.shape[2]), counts,
                  out_dtype)
    if antennas:
        return out
    return out[:, 0] if batched else out[0, 0]
