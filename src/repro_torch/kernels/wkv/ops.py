"""Public wrapper for the WKV6 recurrence (port of
`repro.kernels.wkv.ops.wkv6`).

`wkv6` dispatches on where the tensors live: a CUDA tensor goes to the
hand-written kernel (`kernel.py`) — or raises — and a CPU tensor to the
plain PyTorch version (`ref.py`). There is no fallback from the kernel to
the plain version on the card. `impl="ref"` asks for the plain version
explicitly on any device.

Unlike the TPU wrapper, nothing is padded, broadcast or copied for the
kernel: it runs exactly T steps (the TPU wrapper pads T to its chunk with
w = 1), reads u[head] itself (the TPU wrapper broadcasts u over the
batch), and takes (batch, head, time) strides, so r, k, v and w may be
the (B, T, H, D) projections seen as (B, H, T, D), and o is returned as a
(B, H, T, D) view of (B, T, H, D) memory. The final state is written into
`s_out` when the caller gives it, which may be `s0` itself: decode
updates its state in place.

`launch_count` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.wkv import kernel
from repro_torch.kernels.wkv.ref import wkv6_ref

launch_count = 0

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _launch(r, k, v, w, u, s0, s_out) -> torch.Tensor:
    global launch_count
    if r.dtype not in _KERNEL_DTYPES or any(t.dtype != r.dtype
                                            for t in (k, v, w)):
        raise ValueError(f"the WKV kernel takes f32 or bf16 r, k, v, w of "
                         f"one dtype, got {r.dtype}, {k.dtype}, {v.dtype}, "
                         f"{w.dtype}")
    if r.shape[-1] not in kernel.HEAD_DIMS:
        raise ValueError(f"the WKV kernel takes head_dim in "
                         f"{kernel.HEAD_DIMS}, got {r.shape[-1]}")
    if any(t.stride(-1) != 1 for t in (r, k, v, w)):
        raise ValueError("the WKV kernel needs unit stride along head_dim")
    states = (u, s_out) if s0 is None else (u, s0, s_out)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in states):
        raise ValueError("the WKV kernel takes u, s0 and s_out as "
                         "contiguous f32 tensors")
    if any(t.device != r.device for t in (k, v, w, *states)):
        raise ValueError("all WKV operands must share one device")
    b, h, t, d = r.shape
    # (B, T, H, D) memory, so the caller's swap back to (B, T, H·D) is a
    # view
    o = torch.empty((b, t, h, d), dtype=r.dtype,
                    device=r.device).transpose(1, 2)
    if b * h == 0:
        return o
    kernel.launch(r, k, v, w, u, s0, s_out, o)
    launch_count += 1
    return o


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None, *, impl: str = "auto",
         s_out: Optional[torch.Tensor] = None) -> tuple:
    """The WKV6 recurrence over r, k, v, w (B, H, T, D) (w the decay in
    (0, 1)), the bonus u (H, D) and the initial state s0 (B, H, D, D)
    (None: zeros). Returns (o (B, H, T, D) in r's dtype, the final state
    (B, H, D, D) f32), computed in f32. The final state goes into `s_out`
    when given (it may be `s0`), and `s_out` is returned.

    impl: 'auto' — the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; 'kernel' — the CUDA kernel (CUDA tensors only); 'ref' —
    the plain version.
    """
    if impl not in ("auto", "kernel", "ref"):
        raise ValueError(
            f"impl must be 'auto', 'kernel' or 'ref', got {impl!r}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r, k, v, w must share one (B, H, T, D) shape, "
                         f"got {[tuple(t.shape) for t in (r, k, v, w)]}")
    b, h, t, d = r.shape
    if u.shape != (h, d):
        raise ValueError(f"u must be (H, D) = {(h, d)}, got "
                         f"{tuple(u.shape)}")
    for name, s in (("s0", s0), ("s_out", s_out)):
        if s is not None and s.shape != (b, h, d, d):
            raise ValueError(f"{name} must be (B, H, D, D) = "
                             f"{(b, h, d, d)}, got {tuple(s.shape)}")
    device = r.device.type
    if impl == "ref" or (impl == "auto" and device == "cpu"):
        if s0 is None:
            s0 = torch.zeros((b, h, d, d), dtype=torch.float32,
                             device=r.device)
        o, s_fin = wkv6_ref(*(x.reshape(b * h, *x.shape[2:]) for x in
                              (r, k, v, w, u.expand(b, h, d), s0)))
        s_fin = s_fin.reshape(b, h, d, d)
        if s_out is not None:
            s_fin = s_out.copy_(s_fin)
        return o.reshape(b, h, t, d), s_fin
    if device == "cuda":
        if s_out is None:
            s_out = torch.empty((b, h, d, d), dtype=torch.float32,
                                device=r.device)
        return _launch(r, k, v, w, u, s0, s_out), s_out
    raise ValueError(f"impl={impl!r}: the WKV kernel runs on CUDA tensors, "
                     f"got a {device} tensor (use impl='ref' for the plain "
                     "version)")
