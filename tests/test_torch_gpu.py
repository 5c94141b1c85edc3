"""On-card tests of the port's CUDA kernels; they need a CUDA device and the
CUDA toolkit, and skip without them. Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

This file imports torch and the port only (no JAX), so with
`--noconftest` (tests/conftest.py imports JAX) it runs where JAX is not
installed. Each kernel is held to its plain PyTorch version at the
reference's bars (`tests/test_kernels.py`): the OTA aggregation (K1) and
flash attention (K2), the latter also at the serving slice's shapes.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.attention.ops import \
    multi_head_attention  # noqa: E402
from repro_torch.kernels.ota import ops  # noqa: E402
from repro_torch.kernels.ota.ops import ota_edge_aggregate  # noqa: E402
from repro_torch.kernels.ota.ref import ota_edge_aggregate_ref  # noqa: E402

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


@pytest.mark.parametrize("b,hq,hkv,s,d,kw", ATTN_TEST_SHAPES)
def test_attention_kernel_matches_plain_version(cuda, b, hq, hkv, s, d, kw):
    q, k, v = _qkv(b, hq, hkv, s, d, torch.float32, s + d, cuda)
    out, ref = _attn_pair(q, k, v, kw)
    torch.testing.assert_close(out, ref, atol=5e-5, rtol=1e-4)


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


def test_attention_kernel_reads_strided_views(cuda):
    """q, k, v as (B, S, H, d) memory seen as (B, H, S, d) give the same
    bits as contiguous copies."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((2, 100, h, 64), generator=gen, device=cuda)
               .transpose(1, 2) for h in (4, 2, 2))
    kw = {"scale": 0.125, "window": 30}
    strided = multi_head_attention(q, k, v, **kw)
    dense = multi_head_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), **kw)
    assert torch.equal(strided, dense)
