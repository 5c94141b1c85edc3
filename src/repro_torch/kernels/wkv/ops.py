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

Training differentiates it (`_WKV6`, a `torch.autograd.Function`, taken
where grad is enabled and an input requires it): on CUDA tensors the
forward is the kernel writing the state at the start of every chunk
(`kernel.CKPT_STEPS`), and the backward is the hand-written backward
kernel (`csrc/wkv6_bwd.cu`), which recomputes each chunk from them; on
CPU tensors, and with `impl="ref"`, the pair is the plain scan and its
plain backward (`ref.wkv6_ref_backward`). The reference takes `jax.vjp`
of its checkpointed scan instead, which is the bar. u is shared by the
batch, so its gradient is summed over the batch. The in-place `s_out`
path stays for serving and is not differentiable.

`launch_count` counts forward kernel launches and `backward_launch_count`
backward ones (and nothing else), so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.wkv import kernel
from repro_torch.kernels.wkv.ref import wkv6_ref, wkv6_ref_backward

launch_count = 0
backward_launch_count = 0

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_IMPLS = ("auto", "kernel", "ref")


def _validate(rows, states) -> None:
    """Raise ValueError on what the kernels do not take: `rows` the
    (B, H, T, D) operands of one dtype, `states` the f32 ones."""
    r = rows[0]
    if r.dtype not in _KERNEL_DTYPES or any(t.dtype != r.dtype
                                            for t in rows):
        raise ValueError(f"the WKV kernel takes f32 or bf16 r, k, v, w of "
                         f"one dtype, got {[t.dtype for t in rows]}")
    if r.shape[-1] not in kernel.HEAD_DIMS:
        raise ValueError(f"the WKV kernel takes head_dim in "
                         f"{kernel.HEAD_DIMS}, got {r.shape[-1]}")
    if any(t.stride(-1) != 1 for t in rows):
        raise ValueError("the WKV kernel needs unit stride along head_dim")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in states):
        raise ValueError("the WKV kernel takes u, s0 and s_out as "
                         "contiguous f32 tensors")
    if any(t.device != r.device for t in (*rows, *states)):
        raise ValueError("all WKV operands must share one device")


def _like_o(r: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, T, D) tensor in r's dtype over (B, T, H, D) memory,
    so the caller's swap back to (B, T, H·D) is a view."""
    b, h, t, d = r.shape
    return torch.empty((b, t, h, d), dtype=r.dtype,
                       device=r.device).transpose(1, 2)


def _launch(r, k, v, w, u, s0, s_out, ckpt=None) -> torch.Tensor:
    global launch_count
    _validate((r, k, v, w), [x for x in (u, s0, s_out, ckpt)
                             if x is not None])
    o = _like_o(r)
    if r.shape[0] * r.shape[1] == 0:
        return o
    kernel.launch(r, k, v, w, u, s0, s_out, o, ckpt=ckpt)
    launch_count += 1
    return o


def _launch_backward(r, k, v, w, do, u, ckpt, ds_fin, want_ds0) -> tuple:
    """(dr, dk, dv, dw, du (B, H, D) per batch row, ds0 or None) from the
    backward kernel."""
    global backward_launch_count
    if do.stride(-1) != 1:
        do = do.contiguous()
    _validate((r, k, v, w, do), [x for x in (u, ckpt, ds_fin)
                                 if x is not None])
    # the backward stages by 16-byte copies only: a view off 16 bytes
    # (never the model's) is copied first
    r, k, v, w, do = (x if kernel.copy_bytes(x) == 16 else
                      x.clone(memory_format=torch.contiguous_format)
                      for x in (r, k, v, w, do))
    b, h, t, d = r.shape
    grads = [_like_o(r) for _ in range(4)]
    du = torch.empty((b, h, d), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device) \
        if want_ds0 else None
    if b * h > 0:
        kernel.launch_backward(r, k, v, w, do, u, ckpt, ds_fin,
                               dr=grads[0], dk=grads[1], dv=grads[2],
                               dw=grads[3], du=du, ds0=ds0)
        backward_launch_count += 1
    return (*grads, du, ds0)


def _plain(r, k, v, w, u, s0) -> tuple:
    """The plain forward over (B, H, T, D) operands: (o, final state)."""
    b, h, t, d = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    o, s_fin = wkv6_ref(*(x.reshape(b * h, *x.shape[2:]) for x in
                          (r, k, v, w, u.expand(b, h, d), s0)))
    return o.reshape(b, h, t, d), s_fin.reshape(b, h, d, d)


def _plain_backward(r, k, v, w, u, s0, do, ds_fin) -> tuple:
    b, h, t, d = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    flat = [x.reshape(b * h, *x.shape[2:]) for x in
            (r, k, v, w, u.expand(b, h, d), s0, do)]
    out = wkv6_ref_backward(*flat, None if ds_fin is None
                            else ds_fin.reshape(b * h, d, d))
    grads = [g.reshape(b, h, t, d) for g in out[:4]]
    return (*grads, out[4].reshape(b, h, d), out[5].reshape(b, h, d, d))


class _WKV6(torch.autograd.Function):
    """(o, final state) of the recurrence, differentiable in r, k, v, w,
    u and s0: the kernels on CUDA tensors (unless `use_kernel` is False),
    the plain pair otherwise."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, use_kernel):
        b, h, t, d = r.shape
        ckpt = None
        if use_kernel:
            ckpt = torch.empty((b, h, kernel.n_ckpt(t), d, d),
                               dtype=torch.float32, device=r.device)
            s_fin = torch.empty((b, h, d, d), dtype=torch.float32,
                                device=r.device)
            o = _launch(r, k, v, w, u, s0, s_fin, ckpt=ckpt)
        else:
            o, s_fin = _plain(r, k, v, w, u, s0)
        ctx.use_kernel = use_kernel
        ctx.save_for_backward(r, k, v, w, u, s0, ckpt)
        return o, s_fin

    @staticmethod
    def backward(ctx, do, ds_fin):
        r, k, v, w, u, s0, ckpt = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        want_ds0 = s0 is not None and ctx.needs_input_grad[5]
        if ctx.use_kernel:
            dr, dk, dv, dw, du, ds0 = _launch_backward(
                r, k, v, w, do, u, ckpt,
                None if ds_fin is None else ds_fin.contiguous(), want_ds0)
        else:
            dr, dk, dv, dw, du, ds0 = _plain_backward(r, k, v, w, u, s0, do,
                                                      ds_fin)
        return (dr, dk, dv, dw, du.sum(dim=0),
                ds0 if want_ds0 else None, None)


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

    Where grad is enabled and r, k, v, w, u or s0 requires it, the result
    is differentiable (`_WKV6`: the backward kernel on the kernel route,
    the plain backward otherwise); `s_out` is then refused.
    """
    if impl not in _IMPLS:
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
    plain = impl == "ref" or (impl == "auto" and device == "cpu")
    if not plain and device != "cuda":
        raise ValueError(f"impl={impl!r}: the WKV kernel runs on CUDA "
                         f"tensors, got a {device} tensor (use impl='ref' "
                         "for the plain version)")
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (r, k, v, w, u, s0)):
        if s_out is not None:
            raise ValueError("s_out (the in-place state of serving) is not "
                             "differentiable")
        return _WKV6.apply(r, k, v, w, u, s0, not plain)
    if plain:
        o, s_fin = _plain(r, k, v, w, u, s0)
        if s_out is not None:
            s_fin = s_out.copy_(s_fin)
        return o, s_fin
    if s_out is None:
        s_out = torch.empty((b, h, d, d), dtype=torch.float32,
                            device=r.device)
    return _launch(r, k, v, w, u, s0, s_out), s_out
