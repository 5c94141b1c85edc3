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
        fn = lib.ota_aggregate_strided
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.ota_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn, _err = fn, err
    return _fn


def strides(grads: torch.Tensor) -> tuple:
    """(batch, row) element strides of a `(B, N, d)` grads view, as the
    kernel reads it: the stride of a length-1 axis never matters, so it is
    given as if the view were contiguous."""
    batch, n_nodes, dim = grads.shape
    row = grads.stride(1) if n_nodes > 1 else dim
    return (grads.stride(0) if batch > 1 else n_nodes * row), row


def launch(grads: torch.Tensor, gains: torch.Tensor, noise: torch.Tensor,
           out: torch.Tensor, n_true: Optional[torch.Tensor] = None) -> None:
    """out[b, m] = (gains[b, m] @ grads[b]) / n_true[b] + noise[b, m], on
    the current stream of the tensors' device. Expects validated CUDA
    tensors: grads (B, N, d) f32/bf16 with contiguous columns and any
    row and batch strides (`strides`; a column block of a wider matrix
    goes in as it is), gains (B, M, N) f32, noise (B, M, d) f32, n_true
    (B,) f32 or None (N for every trajectory), out (B, M, d) f32/bf16, all
    but grads contiguous; gains (B, N), noise and out (B, d) are M = 1.
    Raises if the launch is refused."""
    fn = _bind()
    batch, n_nodes, dim = grads.shape
    n_ant = gains.shape[1] if gains.dim() == 3 else 1
    counts = None if n_true is None else n_true.data_ptr()
    batch_stride, row_stride = strides(grads)
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream(grads.device).cuda_stream
        code = fn(grads.data_ptr(), gains.data_ptr(), noise.data_ptr(),
                  counts, out.data_ptr(), batch, n_ant, n_nodes, dim,
                  batch_stride, row_stride,
                  int(grads.dtype == torch.bfloat16),
                  int(out.dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(f"ota_aggregate launch failed: CUDA error {code} "
                           f"({_err(code).decode()})")
