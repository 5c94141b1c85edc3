"""The OTA edge aggregation of the port (`repro_torch.kernels.ota`) on the
CPU, where the wrapper takes the plain PyTorch version: held against the
JAX oracle (`ota_edge_aggregate_ref`) AND the Pallas kernel in interpret
mode, at the reference's own bars (`tests/test_kernels.py`): f32 atol
2e-5, bf16 atol 5e-2, odd shapes atol 1e-6, noise-only probe == 0.37·w to
1e-7. The CUDA kernel itself is checked on the card (`chip_smoke.py`,
`tests/test_torch_gpu.py`)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ota.ops import ota_edge_aggregate as jax_ota  # noqa: E402
from repro.kernels.ota.ref import ota_edge_aggregate_ref  # noqa: E402
from repro_torch.kernels.ota import ops  # noqa: E402
from repro_torch.kernels.ota.ops import ota_edge_aggregate  # noqa: E402


def _inputs(n, d, seed):
    rs = np.random.default_rng(seed)
    g = rs.standard_normal((n, d)).astype(np.float32)
    h = np.abs(rs.standard_normal(n)).astype(np.float32)
    w = rs.standard_normal(d).astype(np.float32)
    return g, h, w


def _both_jax(g, h, w, dtype):
    gj = jnp.asarray(g).astype(dtype)
    ref = ota_edge_aggregate_ref(gj, jnp.asarray(h), jnp.asarray(w),
                                 noise_scale=0.37)
    pallas = jax_ota(gj, jnp.asarray(h), jnp.asarray(w), noise_scale=0.37,
                     impl="pallas", interpret=True)
    return (np.asarray(ref.astype(jnp.float32)),
            np.asarray(pallas.astype(jnp.float32)))


@pytest.mark.parametrize("n,d", [(128, 512), (256, 1024), (100, 300),
                                 (64, 128), (8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_oracle_and_pallas(n, d, dtype):
    g, h, w = _inputs(n, d, n * d)
    ref, pallas = _both_jax(g, h, w, getattr(jnp, dtype))
    out = ota_edge_aggregate(torch.tensor(g).to(getattr(torch, dtype)),
                             torch.tensor(h), torch.tensor(w),
                             noise_scale=0.37)
    assert out.dtype == getattr(torch, dtype)
    atol = 2e-5 if dtype == "float32" else 5e-2
    for target in (ref, pallas):
        np.testing.assert_allclose(out.float().numpy(), target, atol=atol,
                                   rtol=1e-2)


@pytest.mark.parametrize("n,d", [(5, 7), (1, 90), (130, 513), (200, 90)])
def test_odd_shapes_and_noise_probe(n, d):
    g, h, w = _inputs(n, d, n * 1000 + d)
    h = np.random.default_rng(n).uniform(size=n).astype(np.float32)
    ref, pallas = _both_jax(g, h, w, jnp.float32)
    out = ota_edge_aggregate(torch.tensor(g), torch.tensor(h),
                             torch.tensor(w), noise_scale=0.37).numpy()
    for target in (ref, pallas):
        np.testing.assert_allclose(out, target, atol=1e-6, rtol=1e-5)
    probe = ota_edge_aggregate(torch.zeros(n, d), torch.tensor(h),
                               torch.tensor(w), noise_scale=0.37).numpy()
    np.testing.assert_allclose(probe, 0.37 * w, atol=1e-7)


def test_f32_out_for_bf16_grads():
    """`out_dtype` picks the emission dtype of the f32 accumulation."""
    g, h, w = _inputs(64, 128, 5)
    gj = jnp.asarray(g).astype(jnp.bfloat16)
    ref = np.asarray(ota_edge_aggregate_ref(
        gj, jnp.asarray(h), jnp.asarray(w), noise_scale=0.37,
        out_dtype=jnp.float32))
    out = ota_edge_aggregate(torch.tensor(g).bfloat16(), torch.tensor(h),
                             torch.tensor(w), noise_scale=0.37,
                             out_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_batched_equals_unbatched_calls():
    rs = np.random.default_rng(0)
    g = torch.tensor(rs.standard_normal((3, 130, 90)), dtype=torch.float32)
    h = torch.tensor(rs.uniform(size=(3, 130)), dtype=torch.float32)
    w = torch.tensor(rs.standard_normal((3, 90)), dtype=torch.float32)
    scale = torch.tensor([[0.1], [0.37], [2.5]])
    batched = ota_edge_aggregate(g, h, w, noise_scale=scale)
    single = torch.stack([ota_edge_aggregate(g[i], h[i], w[i],
                                             noise_scale=float(scale[i]))
                          for i in range(3)])
    assert torch.equal(batched, single)


def test_cpu_tensors_never_launch_the_kernel():
    ops.launch_count = 0
    g, h, w = (torch.tensor(a) for a in _inputs(8, 16, 1))
    for impl in ("auto", "ref"):
        ota_edge_aggregate(g, h, w, noise_scale=1.0, impl=impl)
    assert ops.launch_count == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        ota_edge_aggregate(g, h, w, noise_scale=1.0, impl="kernel")
    assert ops.launch_count == 0
    with pytest.raises(ValueError, match="impl must be"):
        ota_edge_aggregate(g, h, w, noise_scale=1.0, impl="pallas")
