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

import torch

from repro_torch.kernels.ota import kernel
from repro_torch.kernels.ota.ref import ota_edge_aggregate_ref

launch_count = 0

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _launch(g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
            out_dtype) -> torch.Tensor:
    global launch_count
    if g.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the OTA kernel takes f32/bf16 grads and output, "
                         f"got grads {g.dtype}, out {out_dtype}")
    if not g.is_contiguous():
        raise ValueError("the OTA kernel needs contiguous (B, N, d) grads")
    if h.device != g.device or w.device != g.device:
        raise ValueError("grads, gains and noise must share one device")
    batch, n, d = g.shape
    out = torch.empty((batch, d), dtype=out_dtype, device=g.device)
    if out.numel() == 0:
        return out
    kernel.launch(g, h.to(torch.float32).contiguous(), w.contiguous(), out,
                  n)
    launch_count += 1
    return out


def ota_edge_aggregate(grads: torch.Tensor, gains: torch.Tensor,
                       noise: torch.Tensor, *, noise_scale,
                       impl: str = "auto", out_dtype=None) -> torch.Tensor:
    """One OTA edge aggregation v = (1/N) Σ h_n g_n + noise_scale·w.

    Unbatched `grads (N, d)`, `gains (N,)`, `noise (d,)` -> `(d,)`, or
    batched over trajectories: `(B, N, d)`, `(B, N)`, `(B, d)` ->
    `(B, d)` in one kernel launch. N is the node-axis length (the caller's
    true N: nothing is padded). `noise_scale` is a float or a tensor
    broadcasting against `noise`; it folds into the f32 noise operand.
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
    h = gains if batched else gains.unsqueeze(0)
    w = noise if batched else noise.unsqueeze(0)
    if g.dim() != 3 or h.shape != g.shape[:2] \
            or w.shape != (g.shape[0], g.shape[2]):
        raise ValueError(f"shape mismatch: grads {tuple(grads.shape)}, "
                         f"gains {tuple(gains.shape)}, noise "
                         f"{tuple(noise.shape)}")
    # the noise scale folds into the noise operand in f32 (as the TPU
    # wrapper does), so the kernel adds an already-scaled w
    w32 = noise_scale * w.to(torch.float32)
    device = g.device.type
    if impl == "ref" or (impl == "auto" and device == "cpu"):
        out = ota_edge_aggregate_ref(g, h, w32, noise_scale=1.0,
                                     out_dtype=out_dtype)
    elif device == "cuda":
        out = _launch(g, h, w32, out_dtype)
    else:
        raise ValueError(f"impl={impl!r}: the OTA kernel runs on CUDA "
                         f"tensors, got a {device} tensor (use impl='ref' "
                         "for the plain version)")
    return out if batched else out[0]
