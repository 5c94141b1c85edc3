"""On-card tests of the port's CUDA kernels; they need a CUDA device and the
CUDA toolkit, and skip without them. Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

This file imports torch and the port only (no JAX), so with
`--noconftest` (tests/conftest.py imports JAX) it runs where JAX is not
installed. Each kernel is held to its plain PyTorch version at the
reference's bars (`tests/test_kernels.py`): the OTA aggregation (K1,
also with per-trajectory node counts and with an antenna axis, whose
M = 1 launch and each antenna of an M-antenna launch give the bits of a
single-antenna launch, with and without counts; a column block of a
wider leaf read in place, with the bits of a contiguous copy, also
where a leaf's rows lie 7e7 elements apart; a leaf of 20,480,000
columns; `transport.aggregate` one launch per block),
flash attention (K2: the f32 CUDA-core kernel and the bf16 Hopper kernel,
each at every reference case; both kernels' row log-sum-exp, the
flash backward through it and reduced training steps on both routes, in
bf16 for olmo-1b and rwkv6-7b) and the WKV6 recurrence (K3; its
hand-written backward against the plain backward, also at a transport
node's shape, bit for bit across two launches and against the CPU
emulation of its order of operations), the last two
also at their serving slices' shapes; K3 also at lengths off its chunk,
on views off 16 bytes and for repeatability; K2's bf16 kernel also at
the S2 models' shapes (head_dim 256, windows, softcaps, GQA groups of 2
and 3). The rbg keys' bits and normals on the card equal the CPU's. The
port's threefry is checked to draw an odd count without a host-to-device copy, and a long
normal draw in passes to give the one-pass bits. The execution
plans run through K1: hoisted draws give the per-step bits, chunked
moments match unchunked ones, a sweep resumed after an injected
fault equals the uninterrupted one bit for bit, and LARGE placed over
four mesh entries of the card equals the unplaced call bit for bit. The MC sweep server runs
on the card: the launcher's selftests, and a served mix through K1 held
to the plain route. The fused training step over a (2, 2) mesh of four
entries of the card launches K2 on each entry's heads and stays within
the training bar of the unmeshed step, bit for bit run after run; served
over the same mesh, the reduced olmo-1b launches K2 once a layer an
entry in the prefill and its logits and placed cache stay within 1e-4
of the unmeshed card run's and of the mesh run on the CPU.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.attention.ops import (  # noqa: E402
    multi_head_attention, plain_attention)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lo,hi,m", [(0, 4096, None), (3, 5000, None),
                                     (7, 8, None), (1, 1001, 5),
                                     (0, 2048, 8)])
def test_strided_block_matches_plain_version(cuda, dtype, lo, hi, m):
    """A column block [lo, hi) of a wider (N, size) leaf, as the
    channel-transport layer tiles it: the kernel reads the view in place
    (one launch, no copy), gives the bits of a launch on a contiguous
    copy, and meets the plain version's bars; with an antenna axis at a
    batch stride of 0 (an expanded view) too."""
    size = 3 * 4096 + 5
    gen = torch.Generator(device=cuda).manual_seed(hi)
    full = torch.randn((8, size), generator=gen, device=cuda).to(dtype)
    b = 1 if m is None else 3
    g = full[None, :, lo:hi].expand(b, 8, hi - lo)
    assert not g.is_contiguous()
    h = torch.rand((b, 8) if m is None else (b, m, 8), generator=gen,
                   device=cuda)
    w = torch.randn(h.shape[:-1] + (hi - lo,), generator=gen, device=cuda)
    before = ops.launch_count
    out = ota_edge_aggregate(g, h, w, noise_scale=0.37)
    torch.cuda.synchronize()
    assert ops.launch_count == before + 1
    assert torch.equal(out, ota_edge_aggregate(g.contiguous(), h, w,
                                               noise_scale=0.37))
    ref = ota_edge_aggregate_ref(g, h, w, noise_scale=0.37)
    atol = 1e-6 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("dtype,n,m", [(torch.bfloat16, 40, None),
                                       (torch.bfloat16, 64, None),
                                       (torch.bfloat16, 64, 8),
                                       (torch.float32, 64, None)])
def test_block_of_a_leaf_past_2_26_columns(cuda, dtype, n, m):
    """A narrow column block of an (N, 70,000,000) leaf: rows 7e7
    elements apart, so a step of kUnroll nodes of a node group (8 rows
    each) passes 2^31 elements, at N where a group's node loop goes past
    one such step (40 and 64 for one antenna, where kUnroll is 4; 64 for
    chunks of 8, where it is 8). The leaf outside the block is NaN:
    a wrapped address reads NaN or faults. The kernel gives the bits of a
    contiguous copy and meets the plain version's bars."""
    size, lo, hi = 70_000_000, 70_000_000 - 4096 - 2, 70_000_000 - 2
    full = torch.full((n, size), float("nan"), dtype=dtype, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    full[:, lo:hi] = torch.randn((n, hi - lo), generator=gen,
                                 device=cuda).to(dtype)
    g = full[None, :, lo:hi]
    h = torch.rand((1, n) if m is None else (1, m, n), generator=gen,
                   device=cuda)
    w = torch.randn(h.shape[:-1] + (hi - lo,), generator=gen, device=cuda)
    before = ops.launch_count
    out = ota_edge_aggregate(g, h, w, noise_scale=0.37,
                             out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.launch_count == before + 1
    dense = g.contiguous()
    del full
    assert torch.equal(out, ota_edge_aggregate(dense, h, w, noise_scale=0.37,
                                               out_dtype=torch.float32))
    ref = ota_edge_aggregate_ref(dense, h, w, noise_scale=0.37,
                                 out_dtype=torch.float32)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-5)


def test_leaf_past_the_grid_y_limit_matches_plain_version(cuda):
    """repro-100m's tied embedding as one leaf: 20,480,000 columns, 640,000
    column tiles, past gridDim.y's 65,535 (the tiles fold into z)."""
    d = 32000 * 640
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.randn((8, d), generator=gen, device=cuda)
    h = torch.rand((8,), generator=gen, device=cuda)
    w = torch.randn((d,), generator=gen, device=cuda)
    out = ota_edge_aggregate(g, h, w, noise_scale=0.01)
    ref = ota_edge_aggregate_ref(g, h, w, noise_scale=0.01)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-5)
    tail = slice(d - 4096, d)  # the last z slab's columns
    torch.testing.assert_close(out[tail], ref[tail], atol=1e-6, rtol=1e-5)


def test_transport_aggregate_launches_k1_once_per_block(cuda):
    """`transport.aggregate('gbma')` on the card with the default route:
    one K1 launch per column block (untiled: one per leaf; tiled at 256:
    ceil(size / 256) per leaf), each within 1e-6 + 1e-5·|v| of the plain
    route on the same key, and tiled within 1e-6 of untiled."""
    from repro_torch.core import rng, transport
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.tree import tree_leaves

    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn((8, 40, 30), generator=gen, device=cuda),
            "b": [torch.randn((8, 700), generator=gen, device=cuda)]}
    cfg = transport.TransportConfig(n_nodes=8, channel=ChannelConfig(
        noise_std=0.01))
    outs = {}
    for label, kw, blocks in (("untiled", {}, 2),
                              ("tiled", {"block_d": 256}, 5 + 3),
                              ("ref", {"ota_impl": "ref"}, 0)):
        before = ops.launch_count
        v, _, _ = transport.aggregate("gbma", tree, rng.key(4, cuda),
                                      dataclasses.replace(cfg, **kw))
        torch.cuda.synchronize()
        assert ops.launch_count - before == blocks, label
        outs[label] = tree_leaves(v)
    for a, b, c in zip(outs["untiled"], outs["ref"], outs["tiled"]):
        assert a.device.type == "cuda" and a.dtype == torch.float32
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(c, a, atol=1e-6, rtol=0)


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

# K2 at the S2 serving shapes, bf16 (B, Hq, Hkv, S, d, kw): gemma2-9b's
# local layers at 2048 and 8,192 tokens and its global layers at 8,192,
# gemma-7b, minitron-4b
S2_ATTN_SHAPES = [(4, 16, 8, 2048, 256, {"window": 4096, "softcap": 50.0}),
                  (1, 16, 8, 8192, 256, {"window": 4096, "softcap": 50.0}),
                  (1, 16, 8, 8192, 256, {"softcap": 50.0}),
                  (4, 16, 16, 2048, 256, {}),
                  (4, 24, 8, 2048, 128, {})]
# q's scale at the S2 softcap shapes: with randn q and k the scaled logits
# stay within about ±5, where the softcap of 50 moves them by < 0.01; at
# 10 times that they reach the cap, and the controls below show it
S2_SOFTCAP_Q_SCALE = 10.0
ATTN_CASES = [(dtype, *shape, 1.0) for shape in ATTN_TEST_SHAPES
              for dtype in (torch.float32, torch.bfloat16)] + [
    (torch.bfloat16, *shape,
     S2_SOFTCAP_Q_SCALE if "softcap" in shape[-1] else 1.0)
    for shape in S2_ATTN_SHAPES]


@pytest.mark.parametrize("dtype,b,hq,hkv,s,d,kw,q_scale", ATTN_CASES)
def test_attention_kernel_matches_plain_version(cuda, b, hq, hkv, s, d, kw,
                                                dtype, q_scale):
    """f32 runs on the CUDA-core kernel, bf16 on the Hopper kernel
    (wgmma, TMA); both at every reference case, and bf16 at the S2
    serving shapes. Where q is scaled so the logits reach the softcap,
    controls require the kernel to miss the bar against the plain
    version without the softcap, and without the window where it
    bites."""
    q, k, v = _qkv(b, hq, hkv, s, d, dtype, s + d, cuda)
    q = q * q_scale
    out, ref = _attn_pair(q, k, v, kw)
    print(f"{dtype} {(b, hq, hkv, s, d)} {kw} q x{q_scale}: max abs error "
          f"{(out - ref).abs().max().item():.3e}")
    atol, rtol = ATTN_BARS[dtype]
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
    if q_scale == 1.0:
        return
    del ref
    for name in ("softcap", "window"):
        if kw.get(name) is not None and (name == "softcap" or kw[name] < s):
            ctl = multi_head_attention(q, k, v, scale=d ** -0.5, impl="ref",
                                       **{**kw, name: None})
            gap = (out - ctl.float()).abs().max().item()
            print(f"  control without the {name}: {gap:.3e}")
            assert gap > atol, name


# K2 at the S6 and S7 serving shapes (dtype, B, Hq, Hkv, S, d, kw):
# hymba's local and global layers (groups of 5 at head_dim 64) over its
# 32- and 2,048-token prompts with 128 meta tokens, whisper's encoder
# (non-causal over 1,500 frames, f32 by JAX's promotion of its f32 frames)
# and decoder (bf16 at 32 and 448 tokens), pixtral (groups of 4 over
# 1,024 patches and 2,048 tokens)
S6_S7_ATTN_SHAPES = [
    (torch.bfloat16, 4, 25, 5, 160, 64, {"window": 1024}),
    (torch.bfloat16, 4, 25, 5, 2176, 64, {"window": 1024}),
    (torch.bfloat16, 4, 25, 5, 2176, 64, {}),
    (torch.float32, 4, 12, 12, 1500, 64, {"causal": False}),
    (torch.bfloat16, 4, 12, 12, 32, 64, {}),
    (torch.bfloat16, 4, 12, 12, 448, 64, {}),
    (torch.bfloat16, 4, 32, 8, 3072, 128, {}),
]


@pytest.mark.parametrize("dtype,b,hq,hkv,s,d,kw", S6_S7_ATTN_SHAPES)
def test_attention_kernel_at_s6_s7_shapes(cuda, dtype, b, hq, hkv, s, d, kw):
    """Where hymba's window bites (2,176 positions over 1,024), a control
    requires the kernel to miss the bar against the plain version
    without the window; the non-causal encoder likewise against the
    causal one."""
    q, k, v = _qkv(b, hq, hkv, s, d, dtype, s + hq, cuda)
    out, ref = _attn_pair(q, k, v, kw)
    atol, rtol = ATTN_BARS[dtype]
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
    controls = []
    if kw.get("window", s) < s:
        controls.append({**kw, "window": None})
    if kw.get("causal") is False:
        controls.append({**kw, "causal": True})
    for ctl_kw in controls:
        ctl = multi_head_attention(q, k, v, scale=d ** -0.5, impl="ref",
                                   **ctl_kw).float()
        assert (out - ctl).abs().max().item() > atol, ctl_kw


# K2 at llama4-maverick's shapes (S4): 40 query heads over 8 kv heads
# (groups of 5) at head_dim 128, bf16; its dense layers' 8,192 window
# (which bites only past 8,192 positions) and its global MoE layers; the
# 16,384-token prompt at B = 1
S4_ATTN_SHAPES = [
    (4, 40, 8, 2048, 128, {"window": 8192}),
    (4, 40, 8, 2048, 128, {}),
    (1, 40, 8, 16384, 128, {"window": 8192}),
]


@pytest.mark.parametrize("b,hq,hkv,s,d,kw", S4_ATTN_SHAPES)
def test_attention_kernel_at_s4_shapes(cuda, b, hq, hkv, s, d, kw):
    """Within the bf16 bar of the plain version; where the window bites,
    the kernel misses the bar against the plain version without it."""
    q, k, v = _qkv(b, hq, hkv, s, d, torch.bfloat16, s + hq, cuda)
    before = attn_ops.launch_count
    out = multi_head_attention(q, k, v, scale=d ** -0.5, **kw).float()
    torch.cuda.synchronize()
    assert attn_ops.launch_count == before + 1
    atol, rtol = ATTN_BARS[torch.bfloat16]
    ref = plain_attention(q, k, v, scale=d ** -0.5, **kw).float()
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
    if kw.get("window", s) < s:
        ctl = plain_attention(q, k, v, scale=d ** -0.5,
                              **{**kw, "window": None}).float()
        assert (out - ctl).abs().max().item() > atol


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


# the training shape (B, heads, S, head_dim) of repro-100m at the train
# launcher's defaults (batch 8, seq 256)
TRAIN_ATTN_SHAPE = (8, 10, 10, 256, 64)
LSE_BAR = (1e-5, 1e-6)  # atol + rtol * |lse|


@pytest.mark.parametrize("b,hq,hkv,s,d,kw", ATTN_TEST_SHAPES
                         + [(*TRAIN_ATTN_SHAPE, {})])
def test_attention_kernel_writes_lse(cuda, b, hq, hkv, s, d, kw):
    """The f32 kernel's row log-sum-exp against the plain version's, and
    its output with `lse` at the f32 bar and equal bit for bit to a
    launch without it."""
    q, k, v = _qkv(b, hq, hkv, s, d, torch.float32, s + d + 1, cuda)
    scale = d ** -0.5
    before = attn_ops.launch_count
    out, lse = multi_head_attention(q, k, v, scale=scale, return_lse=True,
                                    **kw)
    torch.cuda.synchronize()
    assert attn_ops.launch_count == before + 1
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    ref, ref_lse = multi_head_attention(q, k, v, scale=scale, impl="ref",
                                        return_lse=True, **kw)
    print(f"{(b, hq, hkv, s, d)} {kw}: lse max abs error "
          f"{(lse - ref_lse).abs().max().item():.3e}")
    torch.testing.assert_close(out, ref, atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_BAR[0],
                               rtol=LSE_BAR[1])
    assert torch.equal(out, multi_head_attention(q, k, v, scale=scale,
                                                 **kw))


def test_bf16_kernel_refuses_lse(cuda):
    """The bf16 kernel used to refuse `lse` (ROADMAP T4); it now writes
    it: one launch, the plain version's lse within 1e-5 + 1e-6·|lse|,
    and the output equal bit for bit to a launch without it."""
    q, k, v = _qkv(1, 2, 2, 64, 64, torch.bfloat16, 3, cuda)
    before = attn_ops.launch_count
    out, lse = multi_head_attention(q, k, v, scale=0.125, return_lse=True)
    torch.cuda.synchronize()
    assert attn_ops.launch_count == before + 1
    _, ref_lse = multi_head_attention(q, k, v, scale=0.125, impl="ref",
                                      return_lse=True)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_BAR[0],
                               rtol=LSE_BAR[1])
    assert torch.equal(out, multi_head_attention(q, k, v, scale=0.125))


# olmo-1b's training shape (B, heads, S, head_dim) at the launcher's
# defaults
OLMO_TRAIN_ATTN_SHAPE = (8, 16, 16, 256, 128)


@pytest.mark.parametrize("b,hq,hkv,s,d,kw", ATTN_TEST_SHAPES
                         + [(*OLMO_TRAIN_ATTN_SHAPE, {})])
def test_bf16_attention_kernel_writes_lse(cuda, b, hq, hkv, s, d, kw):
    """The bf16 Hopper kernel's row log-sum-exp against the plain
    version's at 1e-5 + 1e-6·|lse|, its output at the bf16 bar, and a
    serving launch (no `lse`) equal to it bit for bit."""
    q, k, v = _qkv(b, hq, hkv, s, d, torch.bfloat16, s + d + 2, cuda)
    scale = d ** -0.5
    out, lse = multi_head_attention(q, k, v, scale=scale, return_lse=True,
                                    **kw)
    ref, ref_lse = multi_head_attention(q, k, v, scale=scale, impl="ref",
                                        return_lse=True, **kw)
    torch.cuda.synchronize()
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    print(f"{(b, hq, hkv, s, d)} {kw}: bf16 lse max abs error "
          f"{(lse - ref_lse).abs().max().item():.3e}")
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_BAR[0],
                               rtol=LSE_BAR[1])
    assert torch.equal(out, multi_head_attention(q, k, v, scale=scale,
                                                 **kw))


@pytest.mark.parametrize("b,hq,hkv,s,d,kw", [
    (*TRAIN_ATTN_SHAPE, {}),
    # the reference's GQA + window + softcap case at d = 32 (K2 takes
    # head_dim 32, 64, 128, 256)
    (1, 2, 1, 128, 32, {"window": 40, "softcap": 25.0}),
])
def test_flash_vjp_kernel_route_matches_plain_route(cuda, b, hq, hkv, s, d,
                                                    kw):
    """`flash_attention`'s output and gradients with K2's forward against
    the plain forward (both with the flash backward) and against
    autograd through `full_attention`, at tests/test_flash_vjp.py's bars
    (out atol 2e-5 + rtol 1e-4, gradients atol 5e-4 + rtol 5e-3)."""
    from repro_torch.models.attention import full_attention
    from repro_torch.models.flash_vjp import flash_attention

    q, k, v = _qkv(b, hq, hkv, s, d, torch.float32, 21, cuda)
    t = torch.randn_like(q)
    runs = {}
    for name in ("kernel", "ref", "full"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = attn_ops.launch_count
        if name == "full":
            out = full_attention(*leaves, scale=d ** -0.5, **kw)
        else:
            out = flash_attention(*leaves, scale=d ** -0.5, block_q=128,
                                  block_kv=256, impl=name, **kw)
        (out * t).sum().backward()
        torch.cuda.synchronize()
        assert attn_ops.launch_count == before + (name == "kernel")
        runs[name] = (out.detach(), [x.grad for x in leaves])
    for other in ("ref", "full"):
        torch.testing.assert_close(runs["kernel"][0], runs[other][0],
                                   atol=2e-5, rtol=1e-4)
        for a, b_ in zip(runs["kernel"][1], runs[other][1]):
            torch.testing.assert_close(a, b_, atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("aggregator,route", [("gbma", "auto"),
                                              ("momentum", "auto")])
def test_reduced_training_step_kernel_route_matches_plain_route(
        cuda, aggregator, route):
    """Two steps of the reduced repro-100m on the card: K2 (and K1 on the
    transport route) against the plain versions (`impl='ref'`,
    `ota_impl='ref'`): losses within 1e-5 relative, parameters within
    1e-5 of each leaf's largest |p|."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import transport
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.gbma import GBMAConfig
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim.gd import momentum
    from repro_torch.training.train_step import TrainConfig, build_train_step

    cfg = get_config("repro-100m").reduced()
    ch = ChannelConfig(fading="rayleigh", noise_std=0.01)
    params0 = build_model(cfg).init_params(device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (8, 33), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(2))
    out = {}
    for impl in ("auto", "ref"):
        tp = transport.TransportConfig(n_nodes=8, channel=ch, gamma=0.9,
                                       stepsize=0.05, ota_impl=impl) \
            if aggregator != "gbma" else None
        tcfg = TrainConfig(aggregator=aggregator, gbma=GBMAConfig(
            n_nodes=8, channel=ch), route=route, transport=tp)
        step = build_train_step(build_model(cfg, impl=impl), tcfg,
                                momentum(0.05))
        params = tree_map(lambda x: x.clone(), params0)
        state = step.init_state(params)
        before = (attn_ops.launch_count, ops.launch_count)
        losses = []
        for i in range(2):
            params, state, metrics = step(params, state, {"tokens": tokens},
                                          i)
            losses.append(float(metrics["loss"]))
        launches = (attn_ops.launch_count - before[0],
                    ops.launch_count - before[1])
        out[impl] = (losses, tree_leaves(params), launches)
    n_leaves = len(tree_leaves(params0))
    per_step_attn = cfg.n_layers * (8 if aggregator != "gbma" else 1)
    assert out["auto"][2] == (2 * per_step_attn,
                              2 * n_leaves if aggregator != "gbma" else 0)
    assert out["ref"][2] == (0, 0)
    for a, b_ in zip(out["auto"][0], out["ref"][0]):
        assert abs(a - b_) <= 1e-5 * abs(b_)
    for a, b_ in zip(out["auto"][1], out["ref"][1]):
        assert (a - b_).abs().max() <= 1e-5 * b_.abs().max()


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-7b"])
def test_reduced_bf16_training_kernel_route_matches_plain_route(cuda, arch):
    """The reduced model in bf16 (olmo-1b through K2's bf16 kernel with
    lse and the flash backward; rwkv6-7b through K3 with checkpoints and
    the WKV backward kernel) against its plain route, as chip_smoke holds
    the full-width models: the per-example losses within 1e-2 relative,
    and each leaf's gradient at most twice as far (in norm) from the f32
    model's (the same parameters upcast, plain route) as the plain bf16
    route's, with one launch of each kernel a layer; then one fused gbma
    step on the kernel route gives finite parameters."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.gbma import GBMAConfig
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim.gd import momentum
    from repro_torch.training.train_step import TrainConfig, build_train_step

    cfg = get_config(arch).reduced().with_(dtype="bfloat16")
    params0 = build_model(cfg).init_params(device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (8, 65), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(4))
    out = {}
    for impl, dtype in (("auto", "bfloat16"), ("ref", "bfloat16"),
                        ("ref", "float32")):
        params = tree_map(lambda x: x.to(getattr(torch, dtype)).clone()
                          if x.dtype == torch.bfloat16 else x.clone(),
                          params0)
        params = tree_map(lambda x: x.requires_grad_(True), params)
        before = (attn_ops.launch_count, wkv_ops.launch_count,
                  wkv_ops.backward_launch_count)
        losses, _ = build_model(cfg.with_(dtype=dtype), impl=impl) \
            .train_loss_per_example(params, {"tokens": tokens})
        torch.mean(losses).backward()
        torch.cuda.synchronize()
        launches = tuple(a - b_ for a, b_ in zip(
            (attn_ops.launch_count, wkv_ops.launch_count,
             wkv_ops.backward_launch_count), before))
        out[impl, dtype] = (losses.detach(),
                            [p.grad for p in tree_leaves(params)], launches)
    n = cfg.n_layers
    kernel, plain, f32 = (out["auto", "bfloat16"], out["ref", "bfloat16"],
                          out["ref", "float32"])
    assert kernel[2] == ((n, 0, 0) if arch == "olmo-1b" else (0, n, n))
    assert plain[2] == f32[2] == (0, 0, 0)
    torch.testing.assert_close(kernel[0], plain[0], atol=0, rtol=1e-2)
    norm = torch.linalg.vector_norm
    for a, b_, c in zip(kernel[1], plain[1], f32[1]):
        assert a.dtype == b_.dtype and torch.isfinite(a).all()
        a, b_, c = a.double(), b_.double(), c.double()
        assert norm(a - c) <= 2.0 * norm(b_ - c)
    ch = ChannelConfig(fading="rayleigh", noise_std=0.01)
    step = build_train_step(build_model(cfg), TrainConfig(
        gbma=GBMAConfig(n_nodes=8, channel=ch)), momentum(0.05))
    params, _, metrics = step(params0, step.init_state(params0),
                              {"tokens": tokens}, 0)
    assert all(torch.isfinite(p).all() for p in tree_leaves(params))
    assert abs(float(metrics["loss"]) - float(plain[0].mean())) \
        <= 1e-2 * float(plain[0].mean())


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


@pytest.mark.parametrize("b,h,t,d,dtype", [
    *[(*shape, torch.float32) for shape in WKV_TEST_SHAPES],
    (8, 64, 256, 64, torch.float32), (8, 64, 256, 64, torch.bfloat16),
    (1, 64, 256, 64, torch.float32), (1, 64, 256, 64, torch.bfloat16),
    (2, 8, 100, 64, torch.bfloat16), (1, 3, 33, 16, torch.float32)])
def test_wkv_backward_kernel_matches_plain_backward(cuda, b, h, t, d, dtype):
    """The differentiable WKV on the kernel route (K3 writing its chunk
    checkpoints, then the hand-written backward kernel) against the plain
    pair, with a nonzero s0 and a nonzero cotangent of the final state,
    on the model's (B, T, H, D) views: one launch each; dr, dk, dv, dw
    within 1e-4 of each gradient's largest magnitude in f32 (plus one
    bf16 rounding, 2^-7·|g|, in bf16), du and ds0 (f32 either way) within
    1e-4 of theirs; the forward's o and state equal to a launch without
    checkpoints bit for bit."""
    args = _wkv_inputs(b, h, t, d, dtype, 7 * t + d, cuda, layout="bthd")
    gen = torch.Generator(device=cuda).manual_seed(t)
    do = torch.randn(args[0].shape, generator=gen, device=cuda).to(dtype)
    ds_fin = torch.randn(args[5].shape, generator=gen, device=cuda)
    runs = {}
    for use_kernel in (True, False):
        leaves = [x.clone().requires_grad_(True) for x in args]
        before = (wkv_ops.launch_count, wkv_ops.backward_launch_count)
        o, s_fin = wkv_ops._WKV6.apply(*leaves, use_kernel)
        ((o.float() * do.float()).sum() + (s_fin * ds_fin).sum()).backward()
        torch.cuda.synchronize()
        assert (wkv_ops.launch_count - before[0],
                wkv_ops.backward_launch_count - before[1]) == \
            ((1, 1) if use_kernel else (0, 0))
        runs[use_kernel] = (o.detach(), s_fin.detach(),
                            [x.grad for x in leaves])
    bare_o, bare_s = wkv6(*args)
    assert torch.equal(runs[True][0], bare_o)
    assert torch.equal(runs[True][1], bare_s)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    for i, (a, b_) in enumerate(zip(runs[True][2], runs[False][2])):
        a, b_ = a.float(), b_.float()
        bar = 1e-4 * b_.abs().max() + (ulp * b_.abs() if i < 4 else 0.0)
        assert torch.all((a - b_).abs() <= bar), i


@pytest.mark.parametrize("b,h,t,d,dtype", [
    (8, 64, 256, 64, torch.bfloat16), (1, 64, 256, 64, torch.float32),
    (2, 4, 70, 32, torch.float32), (1, 3, 33, 16, torch.bfloat16)])
def test_wkv_backward_launches_are_repeatable(cuda, b, h, t, d, dtype):
    """Two backward launches on the same inputs give the same bits in dr,
    dk, dv, dw, du and ds0: every sum runs in a fixed order, no atomics
    (the row groups' dv partials are summed in group order)."""
    r, k, v, w, u, s0 = _wkv_inputs(b, h, t, d, dtype, 3 * t + d, cuda,
                                    layout="bthd")
    gen = torch.Generator(device=cuda).manual_seed(d)
    do = torch.randn(r.shape, generator=gen, device=cuda).to(dtype)
    ds_fin = torch.randn(s0.shape, generator=gen, device=cuda)
    ckpt = torch.empty((b, h, wkv_kernel.n_ckpt(t), d, d), device=cuda)
    wkv_kernel.launch(r, k, v, w, u, s0, torch.empty_like(s0),
                      torch.empty_like(r), ckpt=ckpt)
    runs = [wkv_ops._launch_backward(r, k, v, w, do, u, ckpt, ds_fin, True)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert torch.equal(a, c)


@pytest.mark.parametrize("b,h,t,d,dtype", [
    (1, 3, 33, 16, torch.float32), (2, 2, 70, 32, torch.float32),
    (1, 2, 100, 64, torch.float32), (1, 2, 70, 64, torch.bfloat16)])
def test_wkv_backward_kernel_is_its_cpu_emulation(cuda, b, h, t, d, dtype):
    """The backward kernel's dr, dk, dv, dw, du and ds0 equal bit for bit
    `wkv_kernel_order`, the CPU emulation of its order of operations that
    tests/test_torch_wkv_vjp.py holds to the plain backward, on the same
    inputs (bf16 ones widened) from K3's checkpoints; bf16 gradients are
    the emulation's rounded once."""
    from test_torch_helpers import wkv_kernel_order

    gen = torch.Generator().manual_seed(7 * t + d)
    r, k, v, do = (torch.randn((b, h, t, d), generator=gen).to(dtype)
                   for _ in range(4))
    w = torch.exp(-torch.exp(torch.randn((b, h, t, d),
                                         generator=gen))).to(dtype)
    u = 0.5 * torch.randn((h, d), generator=gen)
    s0, ds_fin = (torch.randn((b, h, d, d), generator=gen) * scale
                  for scale in (0.1, 1.0))
    dev = [x.to(cuda) for x in (r, k, v, w, u, s0, do, ds_fin)]
    ckpt = torch.empty((b, h, wkv_kernel.n_ckpt(t), d, d), device=cuda)
    wkv_kernel.launch(*dev[:6], torch.empty_like(dev[5]),
                      torch.empty_like(dev[0]), ckpt=ckpt)
    got = wkv_ops._launch_backward(*dev[:4], dev[6], dev[4], ckpt, dev[7],
                                   True)
    flat = [x.float().reshape(b * h, *x.shape[2:]) for x in
            (r, k, v, w, u.expand(b, h, d), s0, do, ds_fin)]
    want = wkv_kernel_order(*flat)
    for name, a, e in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert torch.equal(a.cpu(), e.to(a.dtype).reshape(a.shape)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_backward_copies_views_off_16_bytes(cuda, dtype):
    """The backward stages by 16-byte copies only: r, k, v, w and do as
    views one element off 16 bytes are copied first and give the bits of
    their contiguous copies."""
    b, h, t, d = 2, 4, 70, 32
    args = _wkv_inputs(b, h, t, d + 1, dtype, 13, cuda)
    views = [x[..., 1:] for x in args[:4]]
    u, s0 = args[4][:, 1:].contiguous(), args[5][..., 1:, 1:].contiguous()
    assert wkv_kernel.copy_bytes(*views) != 16
    do = torch.randn((b, h, t, d + 1), device=cuda).to(dtype)[..., 1:]
    ckpt = torch.empty((b, h, wkv_kernel.n_ckpt(t), d, d), device=cuda)
    wkv_kernel.launch(*(x.contiguous() for x in views), u, s0,
                      torch.empty_like(s0),
                      torch.empty((b, h, t, d), dtype=dtype, device=cuda),
                      ckpt=ckpt)
    off = wkv_ops._launch_backward(*views, do, u, ckpt, None, True)
    dense = wkv_ops._launch_backward(*(x.contiguous() for x in views),
                                     do.contiguous(), u, ckpt, None, True)
    torch.cuda.synchronize()
    for a, c in zip(off, dense):
        assert torch.equal(a, c)


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


def test_normal_in_passes_is_bit_exact_on_the_card(cuda, monkeypatch):
    """A whole-model normal draw in passes (the transport's edge noise)
    equals the one-pass chain over `random_bits` bit for bit on the card,
    at an odd length over several passes."""
    from repro_torch.core import rng

    keys = rng.split(rng.key(7, cuda), 2)
    one = rng.u01_to_normal(rng.bits_to_u01(rng.random_bits(
        keys, (3 * 4096 + 5,))))
    assert torch.equal(rng.normal(keys, (3 * 4096 + 5,)), one)
    monkeypatch.setattr(rng, "NORMAL_PASS", 1024)
    assert torch.equal(rng.normal(keys, (3 * 4096 + 5,)), one)


# ------------------------------------------------------------- rbg keys (T6)

@pytest.mark.parametrize("width", [32, 16, 8])
@pytest.mark.parametrize("n", [1, 5, 1023, 2**20 + 3])
def test_rbg_bits_on_the_card_equal_the_cpus(cuda, n, width):
    """The rbg keys' Philox stream (int64 arithmetic, 32 x 32 products
    wrapping) gives the CPU's bits on the card, from a key whose halves
    differ and whose counter carries across its words."""
    from repro_torch.core import rng

    k = torch.tensor([1, 0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFFF])
    for key in (k, rng.split(rng.fold_in(rng.key(0, impl="rbg"), 3))[1]):
        card = rng.random_bits(key.to(cuda), (n,), width=width)
        assert torch.equal(card.cpu(), rng.random_bits(key, (n,),
                                                       width=width))


def test_rbg_normals_on_the_card_match_the_cpus(cuda):
    from repro_torch.core import rng

    k = rng.split(rng.key(5, impl="rbg"))[1]
    card = rng.normal(k.to(cuda), (3, 4099)).cpu()
    torch.testing.assert_close(card, rng.normal(k, (3, 4099)), atol=1e-6,
                               rtol=0)
    card = rng.normal(k.to(cuda), (4099,), dtype=torch.bfloat16).cpu()
    assert torch.equal(card, rng.normal(k, (4099,), dtype=torch.bfloat16))


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


def test_placed_large_call_has_the_unplaced_bits_on_the_card(cuda):
    """LARGE (N = 4096, d = 24, 150 steps, 1,024 seeds, 'inscan') with its
    seeds over four mesh entries of one card (M8): K1 launched 150 times
    in each of the four blocks, and the curves, energies and statistics
    the unplaced call's bit for bit."""
    import numpy as np

    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.core.mc.plan import ExecPlan
    from repro_torch.figures import MSDProblem

    mc = MSDProblem.make(4096, dim=24).to_mc(cuda)
    args = (mc, [ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                               energy=1.0 / 4096)], "gbma", [0.01], 150,
            1024)
    plain = run_mc(*args, rng_plan="inscan", device=cuda)
    before = ops.launch_count
    placed = run_mc(*args, plan=ExecPlan(rng_plan="inscan", n_shards=4),
                    device=[cuda] * 4)
    assert ops.launch_count - before == 4 * 150
    assert placed.plan.n_shards == 4
    for field in ("risks", "cum_energy", "mean", "ci95"):
        np.testing.assert_array_equal(getattr(placed, field),
                                      getattr(plain, field))


# --------------------------------------------------------------- the server
def test_serve_mc_selftests_pass_on_the_card(cuda):
    """The launcher's `--selftest` and `--selftest --chaos` on the card:
    one program shape per signature, each demuxed request within 1e-6
    of a solo `run_mc`, the chunk and quantum retries and the deadline."""
    from repro_torch.launch import serve_mc

    for argv in (["--selftest", "--device", "cuda"],
                 ["--selftest", "--chaos", "--device", "cuda"]):
        with pytest.raises(SystemExit) as done:
            serve_mc.main(argv)
        assert done.value.code == 0, argv


def test_served_results_match_the_plain_route_on_the_card(cuda):
    """A small mix served bucketed through K1 (one launch a step of each
    engine call) against each request through the plain route on the
    card, within the route checks' 1e-5 rel."""
    import numpy as np

    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.core.mc.problems import (MCProblemBatch,
                                              quadratic_mc_problem)
    from repro_torch.serving.mc_server import (InlineExecutor,
                                               McServeConfig, McSweepServer,
                                               SweepRequest, serve_sync)

    steps, seeds = 20, 4
    reqs = []
    for i, n in enumerate((6, 9, 24, 40)):
        rs = np.random.default_rng(i)
        mc = quadratic_mc_problem(
            rs.standard_normal((n, 3)).astype(np.float32),
            rs.standard_normal(n).astype(np.float32), 0.1,
            np.zeros(3, np.float32), device=cuda)
        reqs.append(SweepRequest(
            problem=mc, channels=[ChannelConfig(noise_std=0.5 + 0.1 * i)],
            algo="gbma", betas=[0.05], steps=steps, seeds=seeds))
    srv = McSweepServer(McServeConfig(quantum_seeds=seeds),
                        executor=InlineExecutor(), device=cuda)
    before = ops.launch_count
    served = serve_sync(reqs, server=srv)
    assert ops.launch_count - before == steps * len(srv.stats.batches)
    for res, req in zip(served, reqs):
        plain = run_mc(MCProblemBatch.stack([req.problem]), req.channels,
                       req.algo, req.betas, steps, seeds, ota_impl="ref",
                       shard_seeds=False, device=cuda)
        for name in ("risks", "mean", "cum_energy"):
            np.testing.assert_allclose(getattr(res, name),
                                       getattr(plain, name), rtol=1e-5,
                                       atol=0)


# ---------------------------------- training hymba, whisper and pixtral (T8)

# K2 at the new models' training shapes: (B, Hq, Hkv, S, d, dtype, kw):
# hymba's groups of 5 under its 1,024 window and globally, whisper's f32
# encoder over 1,500 frames (no causal mask) and bf16 decoder, pixtral's
# 1,024 patches + 256 tokens over 8 kv heads
T8_ATTN_SHAPES = [
    (8, 25, 5, 384, 64, torch.bfloat16, {"window": 1024}),
    (8, 25, 5, 384, 64, torch.bfloat16, {}),
    (8, 12, 12, 1500, 64, torch.float32, {"causal": False}),
    (8, 12, 12, 256, 64, torch.bfloat16, {}),
    (8, 32, 8, 1280, 128, torch.bfloat16, {}),
]


@pytest.mark.parametrize("b,hq,hkv,s,d,dtype,kw", T8_ATTN_SHAPES)
def test_attention_lse_at_the_new_training_shapes(cuda, b, hq, hkv, s, d,
                                                  dtype, kw):
    """K2 with `lse` against its plain version at K2's bars (f32 atol
    5e-5 + rtol 1e-4, bf16 atol 3e-2; lse 1e-5 + 1e-6·|lse|), one launch
    each."""
    q, k, v = _qkv(b, hq, hkv, s, d, dtype, s + hq, cuda)
    scale = d ** -0.5
    before = attn_ops.launch_count
    out, lse = multi_head_attention(q, k, v, scale=scale, return_lse=True,
                                    **kw)
    torch.cuda.synchronize()
    assert attn_ops.launch_count == before + 1
    ref, ref_lse = multi_head_attention(q, k, v, scale=scale, impl="ref",
                                        return_lse=True, **kw)
    atol, rtol = (5e-5, 1e-4) if dtype == torch.float32 else (3e-2, 0.0)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_BAR[0],
                               rtol=LSE_BAR[1])


def test_hymba_fused_steps_recompute_each_layer(cuda):
    """hymba-1.5b at full width with 2 of its 32 layers (a global layer
    and a windowed one) in bf16: with `remat=True` the gradients of one
    forward and backward equal those without it bit for bit, K2 launching
    twice a layer; then 2 fused gbma steps through the recompute give
    finite losses and parameters, 4 K2 launches a step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.gbma import GBMAConfig
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim.gd import momentum
    from repro_torch.training.train_step import TrainConfig, build_train_step

    cfg = get_config("hymba-1.5b").with_(n_layers=2, global_layer_ids=(0,))
    assert cfg.remat
    params0 = build_model(cfg).init_params(device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (8, 257), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(6))
    grads = {}
    for remat in (False, True):
        params = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                          params0)
        before = attn_ops.launch_count
        losses, _ = build_model(cfg.with_(remat=remat)) \
            .train_loss_per_example(params, {"tokens": tokens})
        torch.mean(losses).backward()
        torch.cuda.synchronize()
        assert attn_ops.launch_count - before == 2 * (2 if remat else 1)
        grads[remat] = [p.grad for p in tree_leaves(params)]
    for a, b_ in zip(grads[False], grads[True]):
        assert torch.equal(a, b_)
    step = build_train_step(build_model(cfg), TrainConfig(
        gbma=GBMAConfig(n_nodes=8, channel=ChannelConfig(
            fading="rayleigh", noise_std=0.01))), momentum(0.05))
    params = tree_map(lambda x: x.clone(), params0)
    state = step.init_state(params)
    before = attn_ops.launch_count
    for i in range(2):
        params, state, metrics = step(params, state, {"tokens": tokens}, i)
        assert torch.isfinite(metrics["loss"])
    torch.cuda.synchronize()
    assert attn_ops.launch_count - before == 2 * 4
    assert all(torch.isfinite(p).all() for p in tree_leaves(params))


@pytest.mark.parametrize("fsdp", [False, True])
def test_mesh_train_step_on_four_entries_of_the_card(cuda, fsdp):
    """The fused step over a (2, 2) ("data", "model") mesh of
    ["cuda:0"] * 4 (M12a) on the reduced olmo-1b in f32: K2 on each
    entry's heads (one launch a layer an entry a step: the reduced config
    does not recompute), the params after 2 steps within 1e-6 + 1e-5·|p|
    of the unmeshed step's, every shard its block of `unshard`, and two
    runs the same bits."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.gbma import GBMAConfig
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.gd import momentum
    from repro_torch.sharding.placement import shard_params, unshard
    from repro_torch.sharding.specs import use_mesh
    from repro_torch.training.train_step import TrainConfig, build_train_step

    cfg = get_config("olmo-1b").reduced().with_(fsdp=fsdp)
    model = build_model(cfg)
    params0 = model.init_params(device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (8, 65),
                                        device=cuda, generator=gen)}
               for _ in range(2)]
    tcfg = TrainConfig(gbma=GBMAConfig(n_nodes=2, channel=ChannelConfig(
        fading="rayleigh", noise_std=0.05)))
    mesh = make_mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)

    def run(on_mesh: bool):
        with use_mesh(mesh if on_mesh else None):
            step = build_train_step(model, tcfg, momentum(0.05))
        params = shard_params(params0, fsdp, mesh) if on_mesh \
            else tree_map(lambda x: x.clone(), params0)
        state = step.init_state(params)
        before = attn_ops.launch_count
        for i, b in enumerate(batches):
            params, state, _ = step(params, state, b, i)
        torch.cuda.synchronize()
        assert attn_ops.launch_count - before == 2 * cfg.n_layers * (
            4 if on_mesh else 1)
        return params

    ref = run(False)
    meshed, again = run(True), run(True)
    whole = unshard(meshed)
    for leaf, full, r in zip(tree_leaves(meshed), tree_leaves(whole),
                             tree_leaves(ref)):
        assert torch.allclose(full, r, rtol=1e-5, atol=1e-6)
        for i, s in enumerate(leaf.shards):
            assert torch.equal(s, full[leaf.box(i)])
    for x, y in zip(tree_leaves(meshed), tree_leaves(again)):
        for s, t in zip(x.shards, y.shards):
            assert torch.equal(s, t)


def test_mesh_serving_on_four_entries_of_the_card(cuda):
    """Serving over a (2, 2) ("data", "model") mesh of ["cuda:0"] * 4
    (M12b) on the reduced olmo-1b in f32: K2 once a layer on each entry's
    heads in the prefill; the prefill's and 4 decode steps' logits and
    the placed cache within atol 1e-4 + rtol 1e-4 of the unmeshed card
    run's and of the same mesh run on the CPU, every cache shard its
    block of `unshard`."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.sharding.placement import shard_params, unshard
    from repro_torch.sharding.specs import use_mesh

    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg)
    params0 = model.init_params(device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (4, 40), device=cuda,
                           generator=gen)
    steps = torch.randint(0, cfg.vocab_size, (4, 4), device=cuda,
                          generator=gen)

    def run(devices, on_mesh: bool):
        mesh = make_mesh((2, 2), ("data", "model"), devices)
        params = tree_map(lambda x: x.to(mesh.devices[0]), params0)
        if on_mesh:
            params = shard_params(params, False, mesh)
        with use_mesh(mesh if on_mesh else None):
            before = attn_ops.launch_count
            logits, cache = model.prefill(
                params, {"tokens": prompt.to(mesh.devices[0])}, 44)
            launched = attn_ops.launch_count - before
            seq = [logits]
            for j in range(4):
                logits, cache = model.decode_step(
                    params, cache, steps[:, j].to(mesh.devices[0]), 40 + j)
                seq.append(logits)
        if on_mesh:
            whole = unshard(cache)
            for leaf, full in zip(tree_leaves(cache), tree_leaves(whole)):
                for i, s in enumerate(leaf.shards):
                    assert torch.equal(s, full[leaf.box(i)])
            cache = whole
        return [x.cpu() for x in seq], \
            [x.cpu() for x in tree_leaves(cache)], launched

    ref, ref_cache, n_ref = run(["cuda:0"] * 4, False)
    got, got_cache, n_mesh = run(["cuda:0"] * 4, True)
    cpu, cpu_cache, _ = run(["cpu"] * 4, True)
    assert n_ref == cfg.n_layers and n_mesh == cfg.n_layers * 4
    for other, other_cache in ((ref, ref_cache), (cpu, cpu_cache)):
        for a, b in zip(got + got_cache, other + other_cache):
            if a.dtype == torch.int32:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
