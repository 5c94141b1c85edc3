"""Launcher for the hand-written CUDA flash-attention kernel.

The kernel (`csrc/flash_attention.cu`) replaces the Pallas TPU kernel
`repro.kernels.attention.kernel._attn_kernel`; its source note gives the
bound and the design. This module builds it at first use
(`kernels._build`), binds its C interface with `ctypes`, and launches it
on PyTorch's current stream. Validation and the launch count live in
`ops.py`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NAME = "flash_attention"
HEAD_DIMS = (32, 64, 128, 256)

_fn = None
_err = None
_smem = None


def build() -> _build.BuildInfo:
    """Compile the kernel (or find an up-to-date build)."""
    return _build.build(SOURCE, NAME)


def _bind():
    global _fn, _err, _smem
    if _fn is None:
        lib = _build.load(SOURCE, NAME)
        fn = lib.flash_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.flash_attention_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        smem = lib.flash_attention_smem_bytes
        smem.argtypes = [ctypes.c_int]
        smem.restype = ctypes.c_int
        _fn, _err, _smem = fn, err, smem
    return _fn


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block at `head_dim` (builds the
    kernel if needed)."""
    _bind()
    return _smem(head_dim)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, scale: float, causal: bool,
           window: Optional[int], softcap: Optional[float]) -> None:
    """out = attention(q, k, v) on the current stream of q's device.

    Expects validated CUDA tensors of one dtype (f32 or bf16), each
    (B, H, S, d) with unit stride along d (any other strides): q and out
    (B, Hq, Sq, d), k and v (B, Hkv, Skv, d), Hq a multiple of Hkv, d in
    `HEAD_DIMS`. Raises if the launch is refused."""
    fn = _bind()
    batch, heads, sq, head_dim = q.shape
    skv = k.shape[2]
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  ctypes.addressof(strides), batch, heads,
                  heads // k.shape[1], sq, skv, head_dim, scale,
                  softcap or 0.0, int(causal), window or 0,
                  int(q.dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{code} ({_err(code).decode()})")
