"""On-card tests of the port's CUDA kernels; they need a CUDA device and the
CUDA toolkit, and skip without them. Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

This file imports torch and the port only (no JAX), so with
`--noconftest` (tests/conftest.py imports JAX) it runs where JAX is not
installed. Each kernel is held to its plain PyTorch version at the
reference's bars (`tests/test_kernels.py`): the OTA aggregation (K1,
also with per-trajectory node counts and with an antenna axis, whose
M = 1 launch and each antenna of an M-antenna launch give the bits of a
single-antenna launch, with and without counts),
flash attention (K2: the f32 CUDA-core kernel and the bf16 Hopper kernel,
each at every reference case) and the WKV6 recurrence (K3), the last two
also at their serving slices' shapes; K3 also at lengths off its chunk,
on views off 16 bytes and for repeatability. The port's threefry is
checked to draw an odd count without a host-to-device copy. The execution
plans run through K1: hoisted draws give the per-step bits, chunked
moments match unchunked ones, and a sweep resumed after an injected
fault equals the uninterrupted one bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.attention.ops import \
    multi_head_attention  # noqa: E402
from repro_torch.kernels.ota import ops  # noqa: E402
from repro_torch.kernels.ota.ops import ota_edge_aggregate  # noqa: E402
from repro_torch.kernels.ota.ref import ota_edge_aggregate_ref  # noqa: E402
from repro_torch.kernels.wkv import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv.ops import wkv6  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(b, n, d, dtype, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn((b, n, d), generator=gen, device=device).to(dtype)
    h = torch.randn((b, n), generator=gen, device=device).abs()
    w = torch.randn((b, d), generator=gen, device=device)
    return g, h, w


@pytest.mark.parametrize("b,n,d", [(1, 128, 512), (1, 100, 300),
                                   (4, 500, 90), (64, 4096, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, b, n, d, dtype):
    g, h, w = _inputs(b, n, d, dtype, b * n + d, cuda)
    before = ops.launch_count
    out = ota_edge_aggregate(g, h, w, noise_scale=0.37)
    torch.cuda.synchronize()
    assert ops.launch_count == before + 1
    ref = ota_edge_aggregate_ref(g, h, w, noise_scale=0.37)
    atol = 2e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=1e-2)


@pytest.mark.parametrize("n,d", [(5, 7), (1, 90), (130, 513), (200, 90)])
def test_odd_shapes_and_noise_probe(cuda, n, d):
    g, h, w = _inputs(1, n, d, torch.float32, n * 1000 + d, cuda)
    out = ota_edge_aggregate(g, h, w, noise_scale=0.37)
    ref = ota_edge_aggregate_ref(g, h, w, noise_scale=0.37)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-5)
    probe = ota_edge_aggregate(torch.zeros_like(g), h, w, noise_scale=0.37)
    torch.testing.assert_close(probe, 0.37 * w, atol=1e-7, rtol=0)


def test_kernel_is_deterministic_and_batched_equals_unbatched(cuda):
    g, h, w = _inputs(3, 1000, 90, torch.float32, 3, cuda)
    first = ota_edge_aggregate(g, h, w, noise_scale=1.0)
    again = ota_edge_aggregate(g, h, w, noise_scale=1.0)
    single = torch.stack([ota_edge_aggregate(g[i], h[i], w[i],
                                             noise_scale=1.0)
                          for i in range(3)])
    assert torch.equal(first, again)
    assert torch.equal(first, single)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_trajectory_counts_match_plain_version(cuda, dtype):
    """A node-count sweep's launch: rows of N in {50, 160, 500} zero-padded
    to 500, each divided by its own N; uniform counts give the bits of a
    launch without counts."""
    counts = torch.tensor([50.0, 160.0, 500.0] * 4, device=cuda)
    g, h, w = _inputs(12, 500, 90, dtype, 12, cuda)
    lanes = torch.arange(500, device=cuda) < counts[:, None]
    g, h = g * lanes[..., None].to(dtype), h * lanes
    out = ota_edge_aggregate(g, h, w, noise_scale=0.37, n_true=counts)
    ref = ota_edge_aggregate_ref(g, h, w, noise_scale=0.37, n_true=counts)
    atol = 2e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=1e-2)
    full = torch.full((12,), 500.0, device=cuda)
    assert torch.equal(ota_edge_aggregate(g, h, w, noise_scale=0.37,
                                          n_true=full),
                       ota_edge_aggregate(g, h, w, noise_scale=0.37))


@pytest.mark.parametrize("b,m,n,d", [(3, 5, 131, 37), (2, 1, 500, 90),
                                     (4, 7, 33, 100), (16, 16, 4096, 24),
                                     (3, 17, 131, 37), (4, 20, 500, 24),
                                     (2, 64, 160, 90)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_antenna_axis_matches_plain_version(cuda, b, m, n, d, dtype):
    """gains (B, M, N), noise (B, M, d) -> (B, M, d) in one launch, at
    odd M, N and d, M off the kernel's antenna chunks (17, 20) and past
    the largest (64), against the plain version at the single-antenna
    bars, with and without per-trajectory counts."""
    g, _, _ = _inputs(b, n, d, dtype, b * m + n + d, cuda)
    gen = torch.Generator(device=cuda).manual_seed(m)
    h = torch.randn((b, m, n), generator=gen, device=cuda).abs()
    w = torch.randn((b, m, d), generator=gen, device=cuda)
    counts = torch.randint(1, n + 1, (b,), generator=gen,
                           device=cuda).float()
    atol = 2e-5 if dtype == torch.float32 else 5e-2
    for n_true in (None, counts):
        before = ops.launch_count
        out = ota_edge_aggregate(g, h, w, noise_scale=0.37, n_true=n_true)
        torch.cuda.synchronize()
        assert ops.launch_count == before + 1
        assert tuple(out.shape) == (b, m, d)
        ref = ota_edge_aggregate_ref(g, h, w, noise_scale=0.37,
                                     n_true=n_true)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=1e-2)


@pytest.mark.parametrize("with_counts", [False, True])
def test_antenna_launch_has_the_single_antenna_bits(cuda, with_counts):
    """M = 1 gives the bits of the single-antenna launch (the count-free
    and the count instantiations), and antenna j of an M-antenna launch
    the bits of a single-antenna launch on its own gains and noise: at
    M = 4, at M off the kernel's antenna chunks (17, 20) and past the
    largest (64), at even d (column pairs for chunks of 8 and 16) and odd
    d."""
    b, n = 6, 500
    counts = torch.tensor([50.0, 500.0] * 3, device=cuda) if with_counts \
        else None
    for m, d in ((4, 90), (17, 90), (20, 37), (64, 24)):
        g, h, w = _inputs(b, n, d, torch.float32, 21 + m, cuda)
        single = ota_edge_aggregate(g, h, w, noise_scale=0.37, n_true=counts)
        one = ota_edge_aggregate(g, h[:, None], w[:, None], noise_scale=0.37,
                                 n_true=counts)
        assert torch.equal(one[:, 0], single)
        gen = torch.Generator(device=cuda).manual_seed(5 + m)
        hm = torch.randn((b, m, n), generator=gen, device=cuda).abs()
        wm = torch.randn((b, m, d), generator=gen, device=cuda)
        out = ota_edge_aggregate(g, hm, wm, noise_scale=0.37, n_true=counts)
        for j in range(m):
            assert torch.equal(out[:, j], ota_edge_aggregate(
                g, hm[:, j].contiguous(), wm[:, j], noise_scale=0.37,
                n_true=counts)), (m, d, j)


# ------------------------------------------------------------ attention (K2)

# the shapes of tests/test_kernels.py's attention cases, then the serving
# slice's prefill shapes: olmo-1b (B=4, 16 heads of 128) at a 32- and a
# 2048-token prompt in bf16, repro-100m (10 heads of 64) at 2048 in f32
ATTN_TEST_SHAPES = [
    (2, 4, 4, 256, 64, {}),
    (1, 8, 2, 256, 64, {}),
    (1, 4, 4, 384, 128, {"window": 100}),
    (1, 4, 4, 256, 64, {"softcap": 30.0}),
    (1, 2, 2, 200, 64, {}),
    (1, 2, 2, 256, 32, {"causal": False}),
    (1, 4, 4, 512, 256, {"window": 128, "softcap": 50.0}),
]
ATTN_SLICE_SHAPES = [
    (4, 16, 16, 32, 128, torch.bfloat16),
    (4, 16, 16, 2048, 128, torch.bfloat16),
    (4, 10, 10, 2048, 64, torch.float32),
]


def _qkv(b, hq, hkv, s, d, dtype, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((b, h, s, d), generator=gen, device=device)
                 .to(dtype) for h in (hq, hkv, hkv))


def _attn_pair(q, k, v, kw):
    before = attn_ops.launch_count
    out = multi_head_attention(q, k, v, scale=q.shape[-1] ** -0.5, **kw)
    torch.cuda.synchronize()
    assert attn_ops.launch_count == before + 1
    ref = multi_head_attention(q, k, v, scale=q.shape[-1] ** -0.5,
                               impl="ref", **kw)
    return out.float(), ref.float()


# the reference's bars (tests/test_kernels.py): (atol, rtol) per dtype
ATTN_BARS = {torch.float32: (5e-5, 1e-4), torch.bfloat16: (3e-2, 0.0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,kw", ATTN_TEST_SHAPES)
def test_attention_kernel_matches_plain_version(cuda, b, hq, hkv, s, d, kw,
                                                dtype):
    """f32 runs on the CUDA-core kernel, bf16 on the Hopper kernel
    (wgmma, TMA); both at every reference case."""
    q, k, v = _qkv(b, hq, hkv, s, d, dtype, s + d, cuda)
    out, ref = _attn_pair(q, k, v, kw)
    print(f"{dtype} {(b, hq, hkv, s, d)} {kw}: max abs error "
          f"{(out - ref).abs().max().item():.3e}")
    atol, rtol = ATTN_BARS[dtype]
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)


def test_attention_kernel_bf16(cuda):
    q, k, v = _qkv(1, 4, 4, 256, 64, torch.bfloat16, 9, cuda)
    out, ref = _attn_pair(q, k, v, {})
    torch.testing.assert_close(out, ref, atol=3e-2, rtol=0)


@pytest.mark.parametrize("b,hq,hkv,s,d,dtype", ATTN_SLICE_SHAPES)
def test_attention_kernel_at_serving_shapes(cuda, b, hq, hkv, s, d, dtype):
    q, k, v = _qkv(b, hq, hkv, s, d, dtype, s, cuda)
    out, ref = _attn_pair(q, k, v, {})
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=5e-5, rtol=1e-4)
    else:
        torch.testing.assert_close(out, ref, atol=3e-2, rtol=0)


@pytest.mark.parametrize("dtype,row,col", [(torch.float32, 64, 0),
                                           (torch.bfloat16, 64, 0),
                                           (torch.float32, 68, 1)])
def test_attention_kernel_reads_strided_views(cuda, dtype, row, col):
    """q, k, v as (B, S, H, d) memory seen as (B, H, S, d) give the same
    bits as contiguous copies (bf16: TMA reads those strides). In f32 the
    views are also sliced at column 1 of 68-wide rows, off 16 bytes: the
    f32 kernel reads them with its 4-byte copies, contiguous copies with
    its 16-byte ones."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((2, 100, h, row), generator=gen, device=cuda)
               .to(dtype)[..., col:col + 64].transpose(1, 2)
               for h in (4, 2, 2))
    if dtype == torch.float32:
        assert attn_kernel.copy_bytes(q, k, v) == (4 if col else 16)
    kw = {"scale": 0.125, "window": 30}
    strided = multi_head_attention(q, k, v, **kw)
    dense = multi_head_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), **kw)
    assert torch.equal(strided, dense)


def test_bf16_attention_kernel_refuses_views_tma_cannot_load(cuda):
    """TMA cannot load a bf16 view whose (batch, head, seq) stride is off
    16 bytes (q: 68-wide rows sliced to 64) or whose base address is (v:
    one element in): the kernel runs once on a contiguous copy of exactly
    those operands, with the bits of a launch on contiguous copies of all
    three, and matches the plain version at the bf16 bar."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((1, 2, 40, 68), generator=gen, device=cuda).to(
        torch.bfloat16)[..., :64]
    k = torch.randn((1, 2, 40, 64), generator=gen, device=cuda).to(
        torch.bfloat16)
    v = torch.randn(2 * 40 * 64 + 1, generator=gen, device=cuda).to(
        torch.bfloat16)[1:].view(1, 2, 40, 64)
    assert not attn_ops.tma_loadable(q) and not attn_ops.tma_loadable(v)
    assert attn_ops.tma_loadable(k)
    before = attn_ops.launch_count
    out = multi_head_attention(q, k, v, scale=0.125)
    torch.cuda.synchronize()
    assert attn_ops.launch_count == before + 1
    dense = multi_head_attention(q.contiguous(), k, v.clone(), scale=0.125)
    assert torch.equal(out, dense)
    ref = multi_head_attention(q, k, v, scale=0.125, impl="ref")
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)


# ------------------------------------------------------------------ WKV6 (K3)

# the shapes of tests/test_kernels.py's WKV cases (b, h, t, d), all f32
WKV_TEST_SHAPES = [(2, 2, 128, 64), (1, 4, 100, 32), (2, 1, 64, 64),
                   (1, 2, 256, 16)]


def _wkv_inputs(b, h, t, d, dtype, seed, device, layout="bhtd"):
    """r, k, v, w in `dtype`, as (B, H, T, D) tensors or, for layout
    'bthd', as (B, H, T, D) views of (B, T, H, D) memory; u and s0 f32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (b, h, t, d) if layout == "bhtd" else (b, t, h, d)
    r, k, v = (torch.randn(shape, generator=gen, device=device)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(shape, generator=gen,
                                         device=device)))
    rkvw = [x.to(dtype) for x in (r, k, v, w)]
    if layout == "bthd":
        rkvw = [x.transpose(1, 2) for x in rkvw]
    u = 0.5 * torch.randn((h, d), generator=gen, device=device)
    s0 = 0.1 * torch.randn((b, h, d, d), generator=gen, device=device)
    return (*rkvw, u, s0)


def _wkv_pair(r, k, v, w, u, s0):
    before = wkv_ops.launch_count
    o, s = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv_ops.launch_count == before + 1
    o_ref, s_ref = wkv6(r, k, v, w, u, s0, impl="ref")
    return o.float(), s, o_ref.float(), s_ref


@pytest.mark.parametrize("b,h,t,d", WKV_TEST_SHAPES)
def test_wkv_kernel_matches_plain_version(cuda, b, h, t, d):
    o, s, o_ref, s_ref = _wkv_pair(*_wkv_inputs(b, h, t, d, torch.float32,
                                                t * d, cuda))
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, s_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("t", [1, 2048])
def test_wkv_kernel_bf16_at_model_shape(cuda, t):
    """rwkv6-7b's prefill (T = 2048) and decode (T = 1) shape: B = 4, 64
    heads of 64, bf16 in and out, f32 state. o rounds to bf16 (the kernel
    and the plain version round the same f32 sum, summed in another
    order): atol 2e-2 + rtol 1e-2; the state 1e-4 relative."""
    o, s, o_ref, s_ref = _wkv_pair(*_wkv_inputs(4, 64, t, 64,
                                                torch.bfloat16, t, cuda))
    torch.testing.assert_close(o, o_ref, atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(s, s_ref, atol=1e-4, rtol=1e-4)


def test_wkv_kernel_reads_strided_views_and_updates_state_in_place(cuda):
    """(B, T, H, D) memory seen as (B, H, T, D) gives the bits of
    contiguous copies; the state written over s0 equals the one written
    to a new buffer; o comes back as a view of (B, T, H, D) memory; two
    runs give the same bits; two halves chained equal one pass."""
    r, k, v, w, u, s0 = _wkv_inputs(2, 4, 70, 64, torch.bfloat16, 3, cuda,
                                    layout="bthd")
    assert not r.is_contiguous()
    o, s = wkv6(r, k, v, w, u, s0)
    o_dense, s_dense = wkv6(*(x.contiguous() for x in (r, k, v, w)), u, s0)
    assert torch.equal(o, o_dense) and torch.equal(s, s_dense)
    assert o.transpose(1, 2).is_contiguous()
    state = s0.clone()
    o_in, s_in = wkv6(r, k, v, w, u, state, s_out=state)
    assert s_in is state
    assert torch.equal(o_in, o) and torch.equal(s_in, s)
    o_again, s_again = wkv6(r, k, v, w, u, s0)
    assert torch.equal(o_again, o) and torch.equal(s_again, s)
    o1, s1 = wkv6(r[:, :, :35], k[:, :, :35], v[:, :, :35], w[:, :, :35],
                  u, s0)
    o2, s2 = wkv6(r[:, :, 35:], k[:, :, 35:], v[:, :, 35:], w[:, :, 35:],
                  u, s1)
    assert torch.equal(torch.cat([o1, o2], dim=2), o)
    assert torch.equal(s2, s)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("t", [1, 31, 33, 2047])
def test_wkv_kernel_at_lengths_off_the_chunk(cuda, t, d):
    """Lengths off the kernel's 32-step chunk (a ragged last chunk, or
    decode's single step) at every head_dim, in f32 at the reference's
    bar (atol and rtol 1e-4)."""
    o, s, o_ref, s_ref = _wkv_pair(*_wkv_inputs(2, 4, t, d, torch.float32,
                                                t + d, cuda, layout="bthd"))
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, s_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_views_off_16_bytes_equal_contiguous_copies(cuda, dtype):
    """(B, T, H, D) memory one element past a 16-byte boundary cannot be
    staged by 16-byte copies: the kernel stages it by element copies
    (`kernel.copy_bytes`) and gives the bits of contiguous copies, which
    it stages by 16-byte copies."""
    b, h, t, d = 2, 4, 45, 64
    args = _wkv_inputs(b, h, t, d, dtype, 11, cuda)
    views = []
    for x in args[:4]:
        buf = torch.empty(b * h * t * d + 1, dtype=dtype, device=cuda)
        views.append(buf[1:].view(b, t, h, d).transpose(1, 2))
        views[-1].copy_(x)
    assert wkv_kernel.copy_bytes(*views) == views[0].element_size()
    assert wkv_kernel.copy_bytes(*args[:4]) == 16
    o, s = wkv6(*views, *args[4:])
    o_dense, s_dense = wkv6(*args)
    assert torch.equal(o, o_dense) and torch.equal(s, s_dense)


def test_wkv_kernel_launches_are_repeatable(cuda):
    """Two identical launches at rwkv6-7b's prefill widths give the same
    bits: no atomics, no order that changes from run to run."""
    args = _wkv_inputs(4, 64, 300, 64, torch.bfloat16, 12, cuda,
                       layout="bthd")
    o1, s1 = wkv6(*args)
    o2, s2 = wkv6(*args)
    assert torch.equal(o1, o2) and torch.equal(s1, s2)


def test_wkv_kernel_without_initial_state(cuda):
    r, k, v, w, u, _ = _wkv_inputs(1, 2, 33, 32, torch.float32, 4, cuda)
    o, s, o_ref, s_ref = _wkv_pair(r, k, v, w, u, None)
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, s_ref, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------- threefry

def test_odd_count_draw_copies_nothing_to_the_card(cuda):
    """`random_bits` with an odd count fills its pad counter on the card
    (no host scalar copied into a 0-d view, which would synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import rng

    k = rng.key(torch.arange(4, device=cuda))
    rng.random_bits(k, (7,))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bits = rng.random_bits(k, (7,))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert not [n for n in names if "HtoD" in n
                or n == "cudaStreamSynchronize"], names
    assert bits.shape == (4, 7)


# ----------------------------------------------------- execution plans (P8, P9)

def _exec_problem(device, n=300, d=24):
    import numpy as np

    from repro_torch.core.mc.problems import quadratic_mc_problem

    rs = np.random.default_rng(0)
    X = rs.standard_normal((n, d))
    y = X @ rs.standard_normal(d) + 0.1 * rs.standard_normal(n)
    return quadratic_mc_problem(X, y, 0.1, np.zeros(d), device=device)


@pytest.mark.parametrize("algo,kw", [
    ("gbma", {}), ("gbma", {"n_antennas": 4}), ("fdm", {}),
    ("power_control", {}), ("blind", {"n_antennas": (2, 3)}),
    ("nesterov", {"participation": [0.7, 1.0]})])
def test_hoisted_run_mc_has_the_inscan_bits_on_the_card(cuda, algo, kw):
    """The hoisted RNG plan draws the per-step streams bit for bit, so
    `run_mc` through K1 gives the same curves under both plans."""
    import numpy as np

    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc.engine import run_mc

    mc = _exec_problem(cuda)
    chs = [ChannelConfig(fading="rayleigh", noise_std=0.5, energy=e)
           for e in (1.0, 0.5)]
    out = {plan: run_mc(mc, chs, algo, [0.01, 0.02], 20, 8, rng_plan=plan,
                        device=cuda, **kw)
           for plan in ("hoisted", "inscan")}
    np.testing.assert_array_equal(out["hoisted"].risks, out["inscan"].risks)
    np.testing.assert_array_equal(out["hoisted"].cum_energy,
                                  out["inscan"].cum_energy)


def test_chunked_moments_match_unchunked_on_the_card(cuda):
    """Chan-merged chunk moments against the unchunked call's (mean,
    ci95), at the engine bar and F3's ci95 bar."""
    import numpy as np

    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc.engine import run_mc

    mc = _exec_problem(cuda)
    ch = ChannelConfig(fading="rayleigh", noise_std=0.5)
    whole = run_mc(mc, [ch], "gbma", [0.01], 30, 64, keep_seed_curves=False,
                   device=cuda)
    chunked = run_mc(mc, [ch], "gbma", [0.01], 30, 64, seed_chunk=8,
                     keep_seed_curves=False, device=cuda)
    np.testing.assert_allclose(chunked.mean, whole.mean, rtol=1e-5, atol=0)
    assert np.all(np.abs(chunked.ci95 - whole.ci95)
                  <= 1e-5 * np.abs(whole.ci95) + 1e-5 * np.abs(whole.mean))


def test_resume_after_an_injected_fault_is_bit_identical_on_the_card(
        cuda, tmp_path):
    """A chunk fault stops the sweep; rerun with the same resume_dir, it
    starts at the first unfinished chunk and equals the uninterrupted
    sweep bit for bit."""
    import numpy as np

    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc import exec as exec_mod
    from repro_torch.core.mc.engine import run_mc

    mc = _exec_problem(cuda)
    args = (mc, [ChannelConfig(fading="rayleigh", noise_std=0.5)], "gbma",
            [0.01], 20, 32)
    kw = dict(seed_chunk=8, keep_seed_curves=False, device=cuda)
    clean = run_mc(*args, **kw)

    def hook(info):
        if info["off"] == 16:
            raise RuntimeError("injected chunk fault")

    remove = exec_mod.install_chunk_fault_hook(hook)
    try:
        with pytest.raises(RuntimeError, match="injected"):
            run_mc(*args, resume_dir=str(tmp_path), **kw)
    finally:
        remove()
    before = ops.launch_count
    resumed = run_mc(*args, resume_dir=str(tmp_path), **kw)
    assert ops.launch_count - before == 2 * 20  # chunks at 16 and 24
    np.testing.assert_array_equal(resumed.mean, clean.mean)
    np.testing.assert_array_equal(resumed.ci95, clean.ci95)
