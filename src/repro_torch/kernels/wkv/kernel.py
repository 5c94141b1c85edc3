"""Launchers for the hand-written CUDA WKV6 kernels.

The forward (`csrc/wkv6.cu`) replaces the Pallas TPU kernel
`repro.kernels.wkv.kernel._wkv_kernel`; its source note gives the bound
and the design. r, k, v and w are staged by 16-byte `cp.async` copies, or
by element copies of the same kernel for a view those cannot read
(`copy_bytes`). For training it also writes the state at the start of
every chunk of `CKPT_STEPS` steps (`ckpt`), from which the backward
(`csrc/wkv6_bwd.cu`, hand-written; the JAX package differentiates its
scan instead) recomputes each chunk on chip; it stages r, k, v, w and do
by 16-byte copies only, so the wrapper copies a view off 16 bytes first,
and sums dv's per-row-group partials in a second pass over a buffer the
wrapper allocates. This module builds each at first use
(`kernels._build`), binds its C interface with `ctypes`, and launches it
on PyTorch's current stream. Validation and the launch counts live in
`ops.py`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
NAME = "wkv6"
BWD_SOURCE = SOURCE.with_name("wkv6_bwd.cu")
BWD_NAME = "wkv6_bwd"
HEAD_DIMS = (16, 32, 64)
# steps between two checkpointed states (both sources' kChunk)
CKPT_STEPS = 32

_bound = None
_bwd_bound = None
# 16-byte copies, or element copies for a view they cannot read
copy_bytes = _build.copy_bytes


def build() -> _build.BuildInfo:
    """Compile the forward kernel (or find an up-to-date build)."""
    return _build.build(SOURCE, NAME)


def build_backward() -> _build.BuildInfo:
    """Compile the backward kernel (or find an up-to-date build)."""
    return _build.build(BWD_SOURCE, BWD_NAME)


def _check_ckpt_steps(fn) -> None:
    fn.argtypes = []
    fn.restype = ctypes.c_int
    if fn() != CKPT_STEPS:
        raise RuntimeError(f"the WKV kernel checkpoints every {fn()} "
                           f"steps, the wrapper expects {CKPT_STEPS}")


def bind_library(lib: ctypes.CDLL) -> tuple:
    """(launch, error string) of a loaded forward library; the launch
    takes the checkpoint buffer's pointer (or null) last."""
    fn = lib.wkv6_forward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.wkv6_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _check_ckpt_steps(lib.wkv6_ckpt_steps)
    return fn, err


def bind_backward_library(lib: ctypes.CDLL) -> tuple:
    """(launch, error string, row groups per head dim) of a loaded
    backward library."""
    fn = lib.wkv6_backward
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.wkv6_bwd_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _check_ckpt_steps(lib.wkv6_bwd_ckpt_steps)
    groups = lib.wkv6_bwd_groups
    groups.argtypes = [ctypes.c_int]
    groups.restype = ctypes.c_int
    return fn, err, groups


def _bind():
    """The bound functions of the forward's library, built and loaded
    once per process."""
    global _bound
    if _bound is None:
        _bound = bind_library(_build.load(SOURCE, NAME))
    return _bound


def _bind_backward():
    global _bwd_bound
    if _bwd_bound is None:
        _bwd_bound = bind_backward_library(_build.load(BWD_SOURCE, BWD_NAME))
    return _bwd_bound


def n_ckpt(steps: int) -> int:
    """Checkpointed states of a `steps`-long forward."""
    return -(-steps // CKPT_STEPS)


def smem_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block at `head_dim` for `dtype` inputs
    (builds the kernel if needed)."""
    fn = _build.load(SOURCE, NAME).wkv6_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(head_dim, int(dtype == torch.bfloat16))


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
           s_out: torch.Tensor, o: torch.Tensor,
           ckpt: Optional[torch.Tensor] = None) -> None:
    """o and s_out = WKV6(r, k, v, w, u, s0) on the current stream of r's
    device, and with `ckpt` the state at the start of every chunk of
    `CKPT_STEPS` steps written into it.

    Expects validated CUDA tensors: r, k, v, w and o (B, H, T, D) of one
    dtype (f32 or bf16) with unit stride along D (any other strides); u
    (H, D) f32 contiguous; s0 (or None: zeros) and s_out (B, H, D, D) f32
    contiguous, s_out possibly s0 itself; ckpt (or None) contiguous f32
    (B, H, n_ckpt(T), D, D); D in `HEAD_DIMS`. r, k, v and w are staged
    at the width `copy_bytes` picks. Raises if the launch is refused."""
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
                  copy_bytes(r, k, v, w),
                  None if ckpt is None else ckpt.data_ptr())
    if code != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {code} "
                           f"({err(code).decode()})")


def launch_backward(r, k, v, w, do, u, ckpt, ds_fin, *, dr, dk, dv, dw,
                    du, ds0) -> None:
    """The WKV6 gradients on the current stream of r's device: dr, dk,
    dv and dw (B, H, T, D) written in the inputs' dtype, du (B, H, D) f32
    each (batch, head)'s sum over time, ds0 (or None) (B, H, D, D) f32.

    Expects validated CUDA tensors: r, k, v, w, do and the four
    gradients (B, H, T, D) of one dtype with unit stride along D (any
    other strides), r, k, v, w and do readable by 16-byte copies
    (`copy_bytes` 16); u (H, D) f32 contiguous; ckpt the forward's
    checkpoints of the same inputs; ds_fin (or None: zeros) contiguous
    f32 (B, H, D, D). The kernel keeps every state on chip; it is given
    only the per-row-group dv partials (groups·B·H·T·(D + 1) f32, the
    groups `wkv6_bwd_groups(D)`), which its second pass sums. Raises if
    the launch is refused."""
    fn, err, groups = _bind_backward()
    batch, heads, steps, head_dim = r.shape
    part = torch.empty((groups(head_dim) * batch * heads * steps
                        * (head_dim + 1),), dtype=torch.float32,
                       device=r.device)
    strides = (ctypes.c_int64 * 27)(*(s for t in (r, k, v, w, do, dr, dk,
                                                  dv, dw)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  do.data_ptr(), u.data_ptr(), ckpt.data_ptr(),
                  None if ds_fin is None else ds_fin.data_ptr(),
                  part.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
                  None if ds0 is None else ds0.data_ptr(),
                  ctypes.addressof(strides), batch, heads, steps, head_dim,
                  int(r.dtype == torch.bfloat16), stream)
    if code != 0:
        raise RuntimeError(f"wkv6 backward launch failed: CUDA error "
                           f"{code} ({err(code).decode()})")
