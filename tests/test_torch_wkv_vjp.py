"""The port's WKV6 backward against the JAX reference's gradient, on the
CPU.

The reference differentiates its WKV by `jax.vjp` of the checkpointed
scan `repro.kernels.wkv.ref.wkv6_ref` (it has no backward kernel); that
is the bar. The port's plain backward `ref.wkv6_ref_backward` — what the
hand-written backward kernel (`csrc/wkv6_bwd.cu`) is held to on the card
— is held to it at the reference WKV test shapes
(`tests/test_kernels.py:128-162`) plus a length off both the reference's
64-step chunk and the kernel's 32-step one (T = 100 is one of them; T = 70
and 33 more), with a nonzero s0 and a nonzero cotangent of the final
state: dr, dk, dv, dw, du and ds0 each within 1e-4 + 1e-4 × the
gradient's largest magnitude (f32 sums taken in another order; measured
~1e-7 of the largest). Also: `ops.wkv6` under autograd on CPU tensors
(the differentiable route training takes) against `jax.vjp` of the
reference's `wkv6` (u broadcast over the batch, so du summed over it),
the same route bit for bit against the plain backward, and an emulation
of the backward kernel's order of operations — row groups across
blocks, a row's columns split over lanes and summed in order with FMAs
then by an xor butterfly, v·do once a step, dv summed over a warp's
rows by a tree, over a group's warps in order, then over the groups
in order, states
recomputed per 8-step sub-chunk from 32-step checkpoints with the
forward's FMA — held to the plain backward at the same bar at T = 7,
33, 64, 70 and 100 and D = 16, 32 and 64. Inputs are made with numpy
and handed to both.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.wkv.ops import wkv6 as jax_wkv6  # noqa: E402
from repro.kernels.wkv.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro_torch.kernels.wkv import ops  # noqa: E402
from repro_torch.kernels.wkv.ops import wkv6  # noqa: E402
from repro_torch.kernels.wkv.ref import wkv6_ref_backward  # noqa: E402
from test_torch_helpers import wkv_kernel_order  # noqa: E402

BAR = (1e-4, 1e-4)  # atol + rtol * max |g|, per gradient
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
# tests/test_kernels.py's WKV cases (b, h, t, d), then lengths off the
# 32- and 64-step chunks at every head_dim the kernel takes
CASES = [(2, 2, 128, 64), (1, 4, 100, 32), (2, 1, 64, 64), (1, 2, 256, 16),
         (2, 2, 70, 16), (1, 3, 33, 64)]


def _inputs(b, h, t, d, seed):
    """r, k, v, w (B, H, T, D), u (H, D), s0 (B, H, D, D), and the
    cotangents do (B, H, T, D) and ds_fin (B, H, D, D), numpy f32, at the
    reference tests' scales (w = exp(-exp(N(0, 1))) in (0, 1))."""
    rs = np.random.default_rng(seed)
    r, k, v = (rs.standard_normal((b, h, t, d)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rs.standard_normal((b, h, t, d)))).astype(np.float32)
    u = (0.5 * rs.standard_normal((h, d))).astype(np.float32)
    s0 = (0.1 * rs.standard_normal((b, h, d, d))).astype(np.float32)
    do = rs.standard_normal((b, h, t, d)).astype(np.float32)
    ds_fin = rs.standard_normal((b, h, d, d)).astype(np.float32)
    return r, k, v, w, u, s0, do, ds_fin


def _flat(arrays):
    """The reference oracle's (BH, ...) layout, u broadcast per row."""
    r, k, v, w, u, s0, do, ds_fin = arrays
    b, h, t, d = r.shape
    f = [x.reshape(b * h, *x.shape[2:]) for x in (r, k, v, w)]
    return (*f, np.broadcast_to(u[None], (b, h, d)).reshape(b * h, d),
            s0.reshape(b * h, d, d), do.reshape(b * h, t, d),
            ds_fin.reshape(b * h, d, d))


def _hold(tag, got, want) -> None:
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (tag, name)
        err = float(np.max(np.abs(a - b)))
        bar = BAR[0] + BAR[1] * float(np.max(np.abs(b)))
        print(f"{tag} {name}: max abs error {err:.3e} (bar {bar:.3e})")
        assert err <= bar, (tag, name)


def _jax_flat_vjp(arrays):
    r, k, v, w, u, s0, do, ds_fin = (jnp.asarray(x) for x in _flat(arrays))
    _, vjp = jax.vjp(jax_wkv6_ref, r, k, v, w, u, s0)
    return vjp((do, ds_fin))


@pytest.mark.parametrize("b,h,t,d", CASES)
def test_plain_backward_matches_jax_vjp(b, h, t, d):
    arrays = _inputs(b, h, t, d, 7 * t + d)
    want = _jax_flat_vjp(arrays)
    got = wkv6_ref_backward(*(torch.from_numpy(np.array(x))
                              for x in _flat(arrays)))
    assert all(g.dtype == torch.float32 for g in got)
    _hold(f"plain {(b, h, t, d)}", [g.numpy() for g in got], want)


@pytest.mark.parametrize("b,h,t,d", CASES[:4])
def test_autograd_route_matches_jax_vjp(b, h, t, d):
    """`ops.wkv6` under autograd on CPU tensors against `jax.vjp` of the
    reference's `wkv6`: u is (H, D), shared by the batch, so both sum its
    gradient over the batch; no kernel is launched."""
    arrays = _inputs(b, h, t, d, 11 * t + d)
    r, k, v, w, u, s0, do, ds_fin = arrays
    _, vjp = jax.vjp(lambda *a: jax_wkv6(*a, impl="ref"),
                     *(jnp.asarray(x) for x in (r, k, v, w, u, s0)))
    want = vjp((jnp.asarray(do), jnp.asarray(ds_fin)))
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (r, k, v, w, u, s0)]
    before = (ops.launch_count, ops.backward_launch_count)
    o, s_fin = wkv6(*leaves)
    ((o * torch.from_numpy(do)).sum()
     + (s_fin * torch.from_numpy(ds_fin)).sum()).backward()
    assert (ops.launch_count, ops.backward_launch_count) == before
    _hold(f"autograd {(b, h, t, d)}", [x.grad.numpy() for x in leaves],
          want)


def test_autograd_route_is_the_plain_backward_bitwise():
    """On CPU tensors the route's backward is `wkv6_ref_backward` itself:
    the same bits, with the zero initial state of training (s0 None) and
    no cotangent of the final state; bf16 inputs give bf16 gradients."""
    for dtype in (torch.float32, torch.bfloat16):
        r, k, v, w, u, _, do, _ = (torch.from_numpy(x) for x in
                                   _inputs(2, 2, 40, 16, 5))
        rkvw = [x.to(dtype) for x in (r, k, v, w)]
        leaves = [x.clone().requires_grad_(True) for x in (*rkvw, u)]
        o, _ = wkv6(*leaves)
        assert o.dtype == dtype
        o.backward(do.to(dtype))
        b, h, t, d = r.shape
        want = wkv6_ref_backward(
            *(x.reshape(b * h, *x.shape[2:]) for x in
              (*rkvw, u.expand(b, h, d),
               torch.zeros((b, h, d, d)), do.to(dtype))))
        for x, g in zip(leaves[:4], want[:4]):
            assert x.grad.dtype == dtype
            assert torch.equal(x.grad, g.reshape(b, h, t, d))
        assert torch.equal(leaves[4].grad, want[4].reshape(b, h, d).sum(0))


def test_state_output_is_not_differentiable():
    r, k, v, w, u, s0, _, _ = (torch.from_numpy(x) for x in
                               _inputs(1, 2, 8, 16, 3))
    with pytest.raises(ValueError, match="not differentiable"):
        wkv6(r.requires_grad_(True), k, v, w, u, s0, s_out=s0.clone())


# the reference's three, then lengths off the 8-step sub-chunk and the
# 32-step chunk at every head dim the kernel takes
@pytest.mark.parametrize("b,h,t,d", [
    (1, 2, 100, 16), (1, 1, 70, 64), (2, 1, 64, 32),
    (2, 1, 7, 16), (1, 2, 7, 32), (1, 1, 7, 64), (1, 2, 33, 16),
    (1, 1, 33, 32), (2, 1, 33, 64), (1, 1, 70, 16), (1, 1, 70, 32),
    (1, 1, 100, 32), (1, 1, 100, 64)])
def test_kernel_order_emulation_holds_the_bar(b, h, t, d):
    flat = [torch.from_numpy(np.array(x))
            for x in _flat(_inputs(b, h, t, d, 13 * t + d))]
    emu = wkv_kernel_order(*flat)
    plain = wkv6_ref_backward(*flat)
    _hold(f"kernel order {(b, h, t, d)}", [g.numpy() for g in emu],
          [g.numpy() for g in plain])
