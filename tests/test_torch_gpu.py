"""On-card tests of the port's CUDA kernel; they need a CUDA device and the
CUDA toolkit, and skip without them. Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

This file imports torch and the port only (no JAX), so with
`--noconftest` (tests/conftest.py imports JAX) it runs where JAX is not
installed. The kernel is held to its plain PyTorch version at the
reference's bars (`tests/test_kernels.py`).
"""
import pytest

torch = pytest.importorskip("torch")

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
