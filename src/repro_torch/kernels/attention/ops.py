"""Public wrapper for the flash-attention kernel (port of
`repro.kernels.attention.ops`).

`multi_head_attention` dispatches on where the tensors live: a CUDA tensor
goes to the hand-written kernel (`kernel.py`) — or raises — and a CPU
tensor to the plain PyTorch version (`ref.py`). There is no fallback from
the kernel to the plain version on the card. `impl="ref"` asks for the
plain version explicitly on any device.

Unlike the TPU wrapper, nothing is repeated, padded or copied here: the
kernels read kv head h // group for GQA, mask ragged sequence lengths
themselves (the non-causal padded-kv case included, which the TPU wrapper
hands to the oracle), and take (batch, head, seq) strides, so q, k and v
may be transposed views of the projections. bf16 goes to the Hopper
kernel, f32 to the CUDA-core kernel (`kernel.py`). The bf16 kernel loads
q, k and v by TMA, which needs 16-byte-aligned base addresses and
(batch, head, seq) strides that are multiples of 16 bytes: an operand off
either is copied (`tma_ready`) into the contiguous (B, H, S, d) layout,
and the kernel runs on the copy; the views the model path makes need no
copy.

`launch_count` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.attention import kernel
from repro_torch.kernels.attention.ref import attention_ref

launch_count = 0

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _validate(q, k, v, *, window, softcap) -> None:
    """Raise ValueError on what the kernels do not take."""
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"the attention kernel takes f32 or bf16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.shape[-1] not in kernel.HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head_dim in "
                         f"{kernel.HEAD_DIMS}, got {q.shape[-1]}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the attention kernel needs unit stride along "
                         "head_dim")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share one device")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def tma_loadable(t: torch.Tensor) -> bool:
    """Whether TMA can load the (B, H, S, d) view `t` as it is: a
    16-byte-aligned base address and (batch, head, seq) strides of whole
    16 bytes, the condition of 16-byte `cp.async` copies
    (`kernel.copy_bytes`)."""
    return kernel.copy_bytes(t) == 16


def tma_ready(*tensors) -> tuple:
    """The bf16 kernel's operands: each view TMA can load as it is, and
    a contiguous copy of each other one (a fresh allocation, so 16-byte
    aligned, with strides of whole rows of d in `kernel.HEAD_DIMS`)."""
    return tuple(t if tma_loadable(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in tensors)


def _launch(q, k, v, *, scale, causal, window, softcap) -> torch.Tensor:
    global launch_count
    _validate(q, k, v, window=window, softcap=softcap)
    if q.dtype == torch.bfloat16:
        q, k, v = tma_ready(q, k, v)
    b, hq, sq, d = q.shape
    # (B, Sq, Hq, d) memory, so the caller's swap back to (B, S, H·d)
    # for the output projection is a view
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    kernel.launch(q, k, v, out, scale=scale, causal=causal, window=window,
                  softcap=softcap)
    launch_count += 1
    return out


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         impl: str = "auto") -> torch.Tensor:
    """Attention over q (B, Hq, Sq, d) and k, v (B, Hkv, Skv, d), Hq a
    multiple of Hkv (GQA) -> (B, Hq, Sq, d) in q's dtype, accumulated in
    f32.

    impl: 'auto' — the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; 'kernel' — the CUDA kernel (CUDA tensors only); 'ref' —
    the plain version.
    """
    if impl not in ("auto", "kernel", "ref"):
        raise ValueError(
            f"impl must be 'auto', 'kernel' or 'ref', got {impl!r}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} must be a multiple of kv heads "
                         f"{hkv}")
    device = q.device.type
    if impl == "ref" or (impl == "auto" and device == "cpu"):
        group = hq // hkv
        if group > 1:
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
        out = attention_ref(q.reshape(b * hq, sq, d),
                            k.reshape(b * hq, skv, d),
                            v.reshape(b * hq, skv, d), scale=scale,
                            causal=causal, window=window, softcap=softcap)
        return out.reshape(b, hq, sq, d)
    if device == "cuda":
        return _launch(q, k, v, scale=scale, causal=causal, window=window,
                       softcap=softcap)
    _validate(q, k, v, window=window, softcap=softcap)
    raise ValueError(f"impl={impl!r}: the attention kernel runs on CUDA "
                     f"tensors, got a {device} tensor (use impl='ref' for "
                     "the plain version)")
