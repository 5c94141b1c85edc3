"""Flash attention with a hand-written backward (port of
`repro.models.flash_vjp`).

The forward saves only (out, lse) per row; the backward (Dao et al.)
recomputes the score tiles in two passes over `block_q x block_kv` tiles:

  pass 1 (kv-major):  dk_j = sum_i ds_ij^T q_i * scale,  dv_j = sum_i p_ij^T do_i
  pass 2 (q-major):   dq_i = sum_j ds_ij k_j * scale
  with  p = exp(s_cap - lse),  ds_cap = p * (do v^T - D),  D = rowsum(do * out)
  and the softcap chain rule  ds = ds_cap * (1 - (s_cap / cap)^2).

The forward is K2 (`kernels.attention`) on CUDA tensors: both its
kernels, f32 and bf16, write `lse` in the same launch
(`multi_head_attention(..., return_lse=True)`).
With `impl='ref'`, and on CPU tensors, the forward is K2's plain version
(`kernels/attention/ref.py`), which returns the same `lse`. The backward
is plain PyTorch on any device, in f32 from operands of any dtype (bf16
ones widened exactly), returning each gradient in its input's dtype, as
the reference's jnp backward (it has no Pallas backward either).

GQA goes through the grouped (B, Hkv, G, S, d) layout; Sq and Skv are
padded to the block sizes (padded rows get lse = +1e30, so p = 0 there);
causal masks, windows and softcaps follow the reference. A tile that the
causal mask or the window masks for all of its rows is skipped: its
terms are exact zeros.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention.ops import multi_head_attention
from repro_torch.kernels.attention.ref import NEG_INF, attention_ref

_IMPLS = ("auto", "kernel", "ref")


def _mask(q_idx, k_idx, causal, window, skv) -> torch.Tensor:
    m = (k_idx < skv)[None, :]
    if causal:
        m = m & (q_idx[:, None] >= k_idx[None, :])
    if window is not None:
        m = m & ((q_idx[:, None] - k_idx[None, :]) < window)
    return m  # (bq, bk)


def _scores(q_blk, k_blk, scale, softcap) -> torch.Tensor:
    s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s  # post-cap scores, f32


def _tile_live(q0, bq, k0, bk, causal, window) -> bool:
    """Whether any (query, key) pair of the tile survives the causal mask
    and the window (decided from indices alone, on the host)."""
    if causal and q0 + bq - 1 < k0:
        return False
    if window is not None and q0 - (k0 + bk - 1) >= window:
        return False
    return True


def _forward(q, k, v, *, scale, causal, window, softcap, q_offset, impl):
    """(out (B, Hq, Sq, d) in q's dtype, lse (B, Hq, Sq) f32)."""
    if impl == "ref" or (impl == "auto" and q.device.type == "cpu"):
        b, hq, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        g = hq // hkv
        kr = k.repeat_interleave(g, dim=1) if g > 1 else k
        vr = v.repeat_interleave(g, dim=1) if g > 1 else v
        out, lse = attention_ref(
            q.reshape(b * hq, sq, d), kr.reshape(b * hq, skv, d),
            vr.reshape(b * hq, skv, v.shape[-1]), scale=scale, causal=causal,
            window=window, softcap=softcap, q_offset=q_offset,
            return_lse=True)
        return out.reshape(b, hq, sq, -1), lse.reshape(b, hq, sq)
    if q_offset:
        raise ValueError("the attention kernel takes no q_offset; use "
                         "impl='ref' for the plain version")
    return multi_head_attention(q, k, v, scale=scale, causal=causal,
                                window=window, softcap=softcap, impl=impl,
                                return_lse=True)


def flash_backward(q, k, v, out, lse, d_out, *, scale, causal, window,
                   softcap, q_offset, block_q, block_kv) -> tuple:
    """(dq, dk, dv) of attention at (q, k, v) from the forward's `out` and
    `lse` and the output cotangent `d_out`, in the inputs' dtypes."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    dv_dim = v.shape[-1]
    bq, bk = min(block_q, sq), min(block_kv, skv)
    pad_q, pad_k = (-sq) % bq, (-skv) % bk
    f32 = torch.float32
    qp = F.pad(q.reshape(b, hkv, g, sq, d).to(f32), (0, 0, 0, pad_q))
    kp = F.pad(k.to(f32), (0, 0, 0, pad_k))
    vp = F.pad(v.to(f32), (0, 0, 0, pad_k))
    do = d_out.reshape(b, hkv, g, sq, dv_dim).to(f32)
    # D_i = rowsum(do * out); padded lse rows -> +1e30 so p = 0 there
    dvec = F.pad(torch.sum(do * out.reshape(b, hkv, g, sq, dv_dim).to(f32),
                           dim=-1, keepdim=True), (0, 0, 0, pad_q))
    do = F.pad(do, (0, 0, 0, pad_q))
    lsep = F.pad(lse.reshape(b, hkv, g, sq, 1).to(f32), (0, 0, 0, pad_q),
                 value=-NEG_INF)
    nq, nk = (sq + pad_q) // bq, (skv + pad_k) // bk
    dev = q.device
    ar_q = torch.arange(bq, device=dev)
    ar_k = torch.arange(bk, device=dev)

    def live(qi, kj):
        return _tile_live(q_offset + qi * bq, bq, kj * bk, bk, causal,
                          window)

    def block_grads(qi, kj):
        """Recompute p and ds for tile (qi, kj); shared by both passes."""
        qs, ks = slice(qi * bq, (qi + 1) * bq), slice(kj * bk, (kj + 1) * bk)
        q_blk, k_blk, v_blk = qp[:, :, :, qs], kp[:, :, ks], vp[:, :, ks]
        do_blk = do[:, :, :, qs]
        s_cap = _scores(q_blk, k_blk, scale, softcap)
        msk = _mask(q_offset + qi * bq + ar_q, kj * bk + ar_k, causal,
                    window, skv)
        p = torch.where(msk, torch.exp(s_cap - lsep[:, :, :, qs]), 0.0)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", do_blk, v_blk)
        ds = p * (dp - dvec[:, :, :, qs])
        if softcap is not None:
            ds = ds * (1.0 - torch.square(s_cap / softcap))
        return q_blk, k_blk, do_blk, p, ds

    # ---- pass 1: kv-major -> dk, dv ---------------------------------------
    dk_blocks, dv_blocks = [], []
    for kj in range(nk):
        dk_acc = torch.zeros((b, hkv, bk, d), dtype=f32, device=dev)
        dv_acc = torch.zeros((b, hkv, bk, dv_dim), dtype=f32, device=dev)
        for qi in range(nq):
            if not live(qi, kj):
                continue
            q_blk, _, do_blk, p, ds = block_grads(qi, kj)
            dk_acc = dk_acc + torch.einsum("bhgqk,bhgqd->bhkd", ds,
                                           q_blk) * scale
            dv_acc = dv_acc + torch.einsum("bhgqk,bhgqd->bhkd", p, do_blk)
        dk_blocks.append(dk_acc)
        dv_blocks.append(dv_acc)
    dk = torch.cat(dk_blocks, dim=2)[:, :, :skv]
    dv = torch.cat(dv_blocks, dim=2)[:, :, :skv]

    # ---- pass 2: q-major -> dq --------------------------------------------
    dq_blocks = []
    for qi in range(nq):
        dq_acc = torch.zeros((b, hkv, g, bq, d), dtype=f32, device=dev)
        for kj in range(nk):
            if not live(qi, kj):
                continue
            _, k_blk, _, _, ds = block_grads(qi, kj)
            dq_acc = dq_acc + torch.einsum("bhgqk,bhkd->bhgqd", ds,
                                           k_blk) * scale
        dq_blocks.append(dq_acc)
    dq = torch.cat(dq_blocks, dim=3)[:, :, :, :sq].reshape(b, hq, sq, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, opts):
        out, lse = _forward(q, k, v, **{key: opts[key] for key in (
            "scale", "causal", "window", "softcap", "q_offset", "impl")})
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        o = ctx.opts
        dq, dk, dv = flash_backward(
            q, k, v, out, lse, d_out, scale=o["scale"], causal=o["causal"],
            window=o["window"], softcap=o["softcap"], q_offset=o["q_offset"],
            block_q=o["block_q"], block_kv=o["block_kv"])
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, d)
    k: torch.Tensor,  # (B, Hkv, Skv, d)
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    block_q: int = 512,
    block_kv: int = 1024,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention (B, Hq, Sq, d) differentiable in q, k and v through the
    flash backward. `impl` picks the forward: 'auto' (K2 on CUDA tensors,
    its plain version on CPU tensors), 'kernel' (K2; CUDA only) or 'ref'
    (the plain version on any device)."""
    if impl not in _IMPLS:
        raise ValueError(
            f"impl must be 'auto', 'kernel' or 'ref', got {impl!r}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"query heads {q.shape[1]} must be a multiple of "
                         f"kv heads {k.shape[1]}")
    opts = {"scale": scale, "causal": causal, "window": window,
            "softcap": softcap, "q_offset": q_offset,
            "block_q": block_q, "block_kv": block_kv, "impl": impl}
    return _FlashAttention.apply(q, k, v, opts)
