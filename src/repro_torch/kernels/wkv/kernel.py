"""Launcher for the hand-written CUDA WKV6 kernel.

The kernel (`csrc/wkv6.cu`) replaces the Pallas TPU kernel
`repro.kernels.wkv.kernel._wkv_kernel`; its source note gives the bound
and the design. r, k, v and w are staged by 16-byte `cp.async` copies, or
by element copies of the same kernel for a view those cannot read
(`copy_bytes`). This module builds it at first use (`kernels._build`),
binds its C interface with `ctypes`, and launches it on PyTorch's current
stream. Validation and the launch count live in `ops.py`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
NAME = "wkv6"
HEAD_DIMS = (16, 32, 64)

_bound = None
# 16-byte copies, or element copies for a view they cannot read
copy_bytes = _build.copy_bytes


def build() -> _build.BuildInfo:
    """Compile the kernel (or find an up-to-date build)."""
    return _build.build(SOURCE, NAME)


def bind_library(lib: ctypes.CDLL) -> tuple:
    """(launch, error string) of a loaded kernel library."""
    fn = lib.wkv6_forward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    err = lib.wkv6_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _bind():
    """The bound functions of the kernel's library, built and loaded once
    per process."""
    global _bound
    if _bound is None:
        _bound = bind_library(_build.load(SOURCE, NAME))
    return _bound


def smem_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block at `head_dim` for `dtype` inputs
    (builds the kernel if needed)."""
    fn = _build.load(SOURCE, NAME).wkv6_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(head_dim, int(dtype == torch.bfloat16))


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
           s_out: torch.Tensor, o: torch.Tensor) -> None:
    """o and s_out = WKV6(r, k, v, w, u, s0) on the current stream of r's
    device.

    Expects validated CUDA tensors: r, k, v, w and o (B, H, T, D) of one
    dtype (f32 or bf16) with unit stride along D (any other strides); u
    (H, D) f32 contiguous; s0 (or None: zeros) and s_out (B, H, D, D) f32
    contiguous, s_out possibly s0 itself; D in `HEAD_DIMS`. r, k, v and w
    are staged at the width `copy_bytes` picks. Raises if the launch is
    refused."""
    fn, err = _bind()
    batch, heads, steps, head_dim = r.shape
    strides = (ctypes.c_int64 * 15)(*(s for t in (r, k, v, w, o)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), None if s0 is None else s0.data_ptr(),
                  s_out.data_ptr(), o.data_ptr(), ctypes.addressof(strides),
                  batch, heads, steps, head_dim,
                  int(r.dtype == torch.bfloat16), stream,
                  copy_bytes(r, k, v, w))
    if code != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {code} "
                           f"({err(code).decode()})")
