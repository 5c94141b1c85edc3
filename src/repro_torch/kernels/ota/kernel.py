"""Launcher for the hand-written CUDA OTA-aggregation kernel.

The kernel (`csrc/ota_aggregate.cu`) replaces the Pallas TPU kernel
`repro.kernels.ota.kernel._ota_kernel`; its source note gives the bound
and the design. This module builds it at first use (`kernels._build`),
binds its C interface with `ctypes`, and launches it on PyTorch's current
stream. Validation and the launch count live in `ops.py`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ota_aggregate.cu"
NAME = "ota_aggregate"

_fn = None
_err = None


def build() -> _build.BuildInfo:
    """Compile the kernel (or find an up-to-date build)."""
    return _build.build(SOURCE, NAME)


def _bind():
    global _fn, _err
    if _fn is None:
        lib = _build.load(SOURCE, NAME)
        fn = lib.ota_aggregate
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.ota_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn, _err = fn, err
    return _fn


def launch(grads: torch.Tensor, gains: torch.Tensor, noise: torch.Tensor,
           out: torch.Tensor, n_true: Optional[torch.Tensor] = None) -> None:
    """out[b] = (gains[b] @ grads[b]) / n_true[b] + noise[b], on the
    current stream of the tensors' device. Expects validated, contiguous
    CUDA tensors: grads (B, N, d) f32/bf16, gains (B, N) f32, noise (B, d)
    f32, n_true (B,) f32 or None (N for every trajectory), out (B, d)
    f32/bf16. Raises if the launch is refused."""
    fn = _bind()
    batch, n_nodes, dim = grads.shape
    counts = None if n_true is None else n_true.data_ptr()
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream(grads.device).cuda_stream
        code = fn(grads.data_ptr(), gains.data_ptr(), noise.data_ptr(),
                  counts, out.data_ptr(), batch, n_nodes, dim,
                  int(grads.dtype == torch.bfloat16),
                  int(out.dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(f"ota_aggregate launch failed: CUDA error {code} "
                           f"({_err(code).decode()})")
