"""Plain PyTorch version of the RWKV6 WKV recurrence and its backward
(port of `repro.kernels.wkv.ref`).

Per (batch·head), with the (D, D) state S (rows k-channels, columns
v-channels):

    o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

`wkv6_ref` is a Python loop over t on the f32 state, step for step as the
reference's per-step oracle `wkv6_ref_naive` (its chunked `wkv6_ref`
computes the same steps). `wkv6_ref_backward` is the gradient the
reference takes by `jax.vjp` of its chunked scan, written out as the
reverse scan: dS_{t-1} = diag(w_t) dS_t + r_tᵀ do_t, with each chunk of
`REF_CHUNK` steps recomputed from the state kept at its start, as the
reference's `jax.checkpoint` does, so it holds one state per chunk and
one chunk of states at a time. The CPU tests hold both to JAX; on the
card `chip_smoke.py` compares the CUDA kernels with them, and the
training path takes them on CPU tensors (`ops.wkv6`).
"""
from __future__ import annotations

from typing import Optional

import torch

REF_CHUNK = 64  # the reference's checkpointed chunk


def _step(s, w_t, k_t, v_t):
    """S_t from S_{t-1} (BH, D, D) and the step's rows (BH, D)."""
    return w_t[:, :, None] * s + k_t[:, :, None] * v_t[:, None, :]


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: torch.Tensor) -> tuple:
    """r, k, v, w (BH, T, D); u (BH, D); s0 (BH, D, D). Returns (o in r's
    dtype (BH, T, D), final state f32 (BH, D, D)); computed in f32."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[:, :, None]
    s = s0.float().clone()
    out = torch.empty(rf.shape, dtype=torch.float32, device=r.device)
    for t in range(r.shape[1]):
        kv = kf[:, t, :, None] * vf[:, t, None, :]  # (BH, D, D)
        out[:, t] = torch.einsum("bi,bij->bj", rf[:, t], s + uf * kv)
        s = wf[:, t, :, None] * s + kv
    return out.to(r.dtype), s


def wkv6_ref_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                      do: torch.Tensor,
                      ds_fin: Optional[torch.Tensor] = None) -> tuple:
    """The vector-Jacobian product of `wkv6_ref` at (r, k, v, w, u, s0)
    for the cotangents do (BH, T, D) of o and ds_fin (BH, D, D) of the
    final state (None: zeros). Returns (dr, dk, dv, dw in the inputs'
    dtypes (BH, T, D), du f32 (BH, D), ds0 f32 (BH, D, D)), computed in
    f32:

        dr_t = (S_{t-1} + diag(u) k_tᵀ v_t) do_t
        dk_t = (dS_t + diag(r_t u) 1 do_tᵀ) v_t,  dv_t = its transpose's
        dw_t[i] = Σ_j dS_t[i, j] S_{t-1}[i, j],  du += r_t k_t (v_t · do_t)
        dS_{t-1} = diag(w_t) dS_t + r_tᵀ do_t
    """
    rf, kf, vf, wf, gf = (x.float() for x in (r, k, v, w, do))
    uf = u.float()
    bh, steps, d = rf.shape
    ckpts = []  # the state at the start of each chunk
    s = s0.float()
    for t0 in range(0, steps, REF_CHUNK):
        ckpts.append(s)
        for t in range(t0, min(t0 + REF_CHUNK, steps)):
            s = _step(s, wf[:, t], kf[:, t], vf[:, t])
    ds = torch.zeros((bh, d, d), dtype=torch.float32, device=r.device) \
        if ds_fin is None else ds_fin.float()
    grads = [torch.empty(rf.shape, dtype=torch.float32, device=r.device)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((bh, d), dtype=torch.float32, device=r.device)
    for c in reversed(range(len(ckpts))):
        t0 = c * REF_CHUNK
        t1 = min(t0 + REF_CHUNK, steps)
        states = [ckpts[c]]  # S_{t-1} for t = t0 .. t1 - 1
        for t in range(t0, t1 - 1):
            states.append(_step(states[-1], wf[:, t], kf[:, t], vf[:, t]))
        for t in reversed(range(t0, t1)):
            s_prev = states[t - t0]
            r_t, k_t, v_t, g_t = rf[:, t], kf[:, t], vf[:, t], gf[:, t]
            kv = k_t[:, :, None] * v_t[:, None, :]
            dr[:, t] = torch.einsum("bij,bj->bi",
                                    s_prev + uf[:, :, None] * kv, g_t)
            dkv = (r_t * uf)[:, :, None] * g_t[:, None, :] + ds
            dk[:, t] = torch.einsum("bij,bj->bi", dkv, v_t)
            dv[:, t] = torch.einsum("bij,bi->bj", dkv, k_t)
            du = du + r_t * torch.einsum("bij,bj->bi", kv, g_t)
            dw[:, t] = torch.sum(ds * s_prev, dim=-1)
            ds = wf[:, t, :, None] * ds + r_t[:, :, None] * g_t[:, None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du, ds)
