"""The port's WKV6 recurrence against the JAX reference, on the CPU.

`wkv6` on CPU tensors — the plain version (`kernels/wkv/ref.py`) the CUDA
kernel is held to on the card — against the reference's Pallas kernel run
in interpret mode and against its scan oracle, at the shapes and bar of
`tests/test_kernels.py`'s WKV cases: o and the final state within atol
1e-4 and rtol 1e-4 (f32 sums taken in another order). Inputs are made
with numpy and handed to both. Also: two halves chained through the
state equal one pass (atol 1e-5, the reference's bar), the in-place state
update equals the out-of-place one bit for bit, bf16 inputs give bf16 o
and an f32 state within bf16 rounding of the reference, what the
wrapper refuses, and how the CUDA launcher stages each view
(`kernel.copy_bytes`, a pure function of strides, base address and
length).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.wkv.ops import wkv6 as jax_wkv6  # noqa: E402
from repro_torch.kernels.wkv import kernel, ops  # noqa: E402
from repro_torch.kernels.wkv.ops import wkv6  # noqa: E402

ATOL = RTOL = 1e-4
# tests/test_kernels.py::test_wkv6_kernel_matches_scan's cases (b, h, t, d)
CASES = [(2, 2, 128, 64), (1, 4, 100, 32), (2, 1, 64, 64), (1, 2, 256, 16)]


def _inputs(b, h, t, d, seed):
    """r, k, v, w (B, H, T, D), u (H, D), s0 (B, H, D, D) as numpy f32, with
    the reference tests' scales (w = exp(-exp(N(0, 1))) in (0, 1))."""
    rs = np.random.default_rng(seed)
    r, k, v = (rs.standard_normal((b, h, t, d)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rs.standard_normal((b, h, t, d)))).astype(np.float32)
    u = (0.5 * rs.standard_normal((h, d))).astype(np.float32)
    s0 = (0.1 * rs.standard_normal((b, h, d, d))).astype(np.float32)
    return r, k, v, w, u, s0


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("jax_impl", ["pallas", "ref"])
@pytest.mark.parametrize("b,h,t,d", CASES)
def test_plain_version_matches_reference(b, h, t, d, jax_impl):
    arrays = _inputs(b, h, t, d, t * d + b)
    kw = {"interpret": True} if jax_impl == "pallas" else {}
    o_ref, s_ref = jax_wkv6(*(jnp.asarray(a) for a in arrays),
                            impl=jax_impl, **kw)
    before = ops.launch_count
    o, s = wkv6(*_torch(arrays))
    assert ops.launch_count == before  # CPU tensors: the plain version
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=ATOL,
                               rtol=RTOL)


def test_state_chaining_matches_full_sequence():
    """Two halves with the state carried equal one full pass (decode
    continues prefill), as the reference's chaining case; s0 absent means
    a zero state."""
    r, k, v, w, u, _ = _torch(_inputs(1, 2, 64, 32, 4))
    o_full, s_full = wkv6(r, k, v, w, u)
    half = 32
    o1, s1 = wkv6(r[:, :, :half], k[:, :, :half], v[:, :, :half],
                  w[:, :, :half], u)
    o2, s2 = wkv6(r[:, :, half:], k[:, :, half:], v[:, :, half:],
                  w[:, :, half:], u, s1)
    np.testing.assert_allclose(torch.cat([o1, o2], dim=2).numpy(),
                               o_full.numpy(), atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=1e-5)
    o_jax, s_jax = jax_wkv6(*(jnp.asarray(x.numpy()) for x in
                              (r, k, v, w, u)), impl="ref")
    np.testing.assert_allclose(o_full.numpy(), np.asarray(o_jax), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(s_full.numpy(), np.asarray(s_jax), atol=ATOL,
                               rtol=RTOL)


def test_state_written_in_place_equals_out_of_place():
    r, k, v, w, u, s0 = _torch(_inputs(2, 2, 17, 16, 5))
    o_out, s_out = wkv6(r, k, v, w, u, s0)
    state = s0.clone()
    o_in, s_in = wkv6(r, k, v, w, u, state, s_out=state)
    assert s_in is state
    assert torch.equal(o_in, o_out) and torch.equal(s_in, s_out)


def test_single_step_matches_reference():
    """Decode is T = 1; the reference pads it to its chunk with w = 1."""
    arrays = _inputs(2, 4, 1, 64, 6)
    o_ref, s_ref = jax_wkv6(*(jnp.asarray(a) for a in arrays),
                            impl="pallas", interpret=True)
    o, s = wkv6(*_torch(arrays))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=ATOL,
                               rtol=RTOL)


def test_bf16_inputs_give_bf16_output_and_f32_state():
    """r, k, v, w in bf16 (the model dtype), u and the state f32, as the
    reference's kernel takes them; o rounds to bf16 (atol 3e-2, about an
    ulp at |o| ~ 4), the state stays f32 (1e-4)."""
    r, k, v, w, u, s0 = _inputs(1, 2, 48, 64, 7)
    bf = [a.astype(ml_dtypes.bfloat16) for a in (r, k, v, w)]
    o_ref, s_ref = jax_wkv6(*(jnp.asarray(a) for a in bf), jnp.asarray(u),
                            jnp.asarray(s0), impl="ref")
    args = [torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            for a in bf]
    o, s = wkv6(*args, torch.from_numpy(u), torch.from_numpy(s0))
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_ref, np.float32), atol=3e-2,
                               rtol=1e-2)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=ATOL,
                               rtol=RTOL)


def test_wrapper_refuses_bad_arguments():
    r, k, v, w, u, s0 = _torch(_inputs(1, 2, 8, 16, 8))
    with pytest.raises(ValueError, match="impl must be"):
        wkv6(r, k, v, w, u, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv6(r, k, v, w, u, impl="kernel")  # no fallback to the plain one
    with pytest.raises(ValueError, match="one .B, H, T, D. shape"):
        wkv6(r, k[:, :, :4], v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="s0 must be"):
        wkv6(r, k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError, match="s_out must be"):
        wkv6(r, k, v, w, u, s_out=s0[0])


def _view(shape, dtype, offset=0, layout="bthd"):
    """A (B, H, T, D) view of zeros: of (B, T, H, D) memory (the model's
    projections) or contiguous, `offset` elements into its buffer."""
    b, h, t, d = shape
    buf = torch.zeros(b * h * t * d + offset, dtype=dtype)[offset:]
    if layout == "bthd":
        return buf.view(b, t, h, d).transpose(1, 2)
    return buf.view(b, h, t, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_copy_width_follows_the_view(dtype):
    """The kernel stages r, k, v, w by 16-byte copies where every base
    address is 16-byte aligned and every (batch, head, time) stride of a
    dimension longer than 1 spans whole 16 bytes, else by element copies
    of the same kernel (the same bits): the model's (B, T, H, D) views and
    contiguous tensors take 16; a view one element off a 16-byte boundary,
    or sliced from rows whose stride is not a whole 16 bytes, takes the
    element size, and one such view sets the width of the launch."""
    elt = torch.empty((), dtype=dtype).element_size()
    aligned = _view((2, 4, 100, 64), dtype)
    assert aligned.data_ptr() % 16 == 0
    assert kernel.copy_bytes(aligned) == 16
    assert kernel.copy_bytes(_view((2, 4, 100, 64), dtype,
                                   layout="bhtd")) == 16
    offset = _view((2, 4, 100, 64), dtype, offset=1)
    assert kernel.copy_bytes(offset) == elt
    sliced = torch.zeros((2, 100, 4, 66), dtype=dtype)[..., :64]
    assert kernel.copy_bytes(sliced.transpose(1, 2)) == elt
    assert kernel.copy_bytes(aligned, aligned, offset, aligned) == elt


@pytest.mark.parametrize("t,width", [(1, 16), (2, "element")])
def test_copy_width_ignores_the_stride_of_a_single_step(t, width):
    """Decode (T = 1) reads one row per head, so the time stride of its
    view is never used: a time stride that is not a whole 16 bytes keeps
    16-byte copies at T = 1 and takes element copies at T = 2. So do
    batch and head strides of length-1 dimensions."""
    base = torch.zeros(4 * 64 * 3 * 64 + 8)
    view = base.as_strided((4, 64, t, 64), (64 * 3 * 64, 3 * 64, 33, 1))
    expect = 16 if width == 16 else view.element_size()
    assert kernel.copy_bytes(view) == expect
    one = base.as_strided((1, 1, 8, 64), (3, 5, 64, 1))
    assert kernel.copy_bytes(one) == 16
