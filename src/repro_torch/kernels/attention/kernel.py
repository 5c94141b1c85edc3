"""Launchers for the hand-written CUDA flash-attention kernels.

Two kernels replace the Pallas TPU kernel
`repro.kernels.attention.kernel._attn_kernel`, one per input dtype; each
source note gives the bound and the design:

* bf16: `csrc/flash_attention_sm90.cu`, both products on the tensor cores
  (`wgmma`), K and V streamed by TMA through an mbarrier ring;
* f32: `csrc/flash_attention.cu`, f32 FMAs on the CUDA cores (TF32 could
  not hold the f32 bar), register tiles fed by 128-bit shared loads, K and
  V staged by `cp.async`: 16-byte copies, or 4-byte copies of the same
  kernel for a view they cannot read (`copy_bytes`).

This module builds each at first use (`kernels._build`), binds its C
interface with `ctypes`, and launches it on PyTorch's current stream.
Validation and the launch count live in `ops.py`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "flash_attention.cu"              # f32
NAME = "flash_attention"
SM90_SOURCE = _CSRC / "flash_attention_sm90.cu"    # bf16
SM90_NAME = "flash_attention_sm90"
HEAD_DIMS = (32, 64, 128, 256)

_libs: dict = {}
# the f32 kernel's copy width: 16 bytes, or 4 for a view 16-byte copies
# cannot read
copy_bytes = _build.copy_bytes


def build() -> _build.BuildInfo:
    """Compile the f32 kernel (or find an up-to-date build)."""
    return _build.build(SOURCE, NAME)


def build_sm90() -> _build.BuildInfo:
    """Compile the bf16 Hopper kernel (or find an up-to-date build)."""
    return _build.build(SM90_SOURCE, SM90_NAME)


def bind_library(lib: ctypes.CDLL, bf16: bool) -> tuple:
    """(launch, error string, shared-memory size) of a loaded kernel
    library; the two launch functions take the same arguments, then the
    f32 one a copy width, and both the row log-sum-exp's pointer (or
    null)."""
    name = SM90_NAME if bf16 else NAME
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] + [ctypes.c_int] * (not bf16) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_int
    return fn, err, smem


def _bind(bf16: bool):
    """The bound functions of one kernel's library, built and loaded once
    per process."""
    name = SM90_NAME if bf16 else NAME
    if name not in _libs:
        _libs[name] = bind_library(
            _build.load(SM90_SOURCE if bf16 else SOURCE, name), bf16)
    return _libs[name]


def smem_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the `dtype` kernel at
    `head_dim` (builds the kernel if needed)."""
    return _bind(dtype == torch.bfloat16)[2](head_dim)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, scale: float, causal: bool,
           window: Optional[int], softcap: Optional[float],
           lse: Optional[torch.Tensor] = None) -> None:
    """out = attention(q, k, v) on the current stream of q's device, and
    with `lse` (a contiguous f32 (B·Hq, Sq) tensor) the row log-sum-exp
    of the (capped) scaled logits written into it.

    Expects validated CUDA tensors of one dtype, each (B, H, S, d) with
    unit stride along d (any other strides): q and out (B, Hq, Sq, d), k
    and v (B, Hkv, Skv, d), Hq a multiple of Hkv, d in `HEAD_DIMS`. bf16
    goes to the Hopper kernel, which reads q, k and v by TMA (16-byte
    aligned bases and strides: `ops.tma_ready` copies other views); f32
    to the CUDA-core kernel, at the copy width `copy_bytes` picks. Raises
    if the launch is refused."""
    bf16 = q.dtype == torch.bfloat16
    fn, err, _ = _bind(bf16)
    batch, heads, sq, head_dim = q.shape
    skv = k.shape[2]
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in t.stride()[:3]))
    if lse is not None and (lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()
                            or lse.numel() != q.shape[0] * q.shape[1]
                            * q.shape[2]):
        raise ValueError("lse: the kernels write a contiguous f32 "
                         "(B·Hq, Sq) tensor on q's device")
    tail = (() if bf16 else (copy_bytes(q, k, v, out),)) \
        + (None if lse is None else lse.data_ptr(),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  ctypes.addressof(strides), batch, heads,
                  heads // k.shape[1], sq, skv, head_dim, scale,
                  softcap or 0.0, int(causal), window or 0, stream, *tail)
    if code != 0:
        raise RuntimeError(f"flash_attention launch failed: error {code} "
                           f"({err(code).decode()})")
