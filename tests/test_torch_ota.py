"""The OTA edge aggregation of the port (`repro_torch.kernels.ota`) on the
CPU, where the wrapper takes the plain PyTorch version: held against the
JAX oracle (`ota_edge_aggregate_ref`) AND the Pallas kernel in interpret
mode, at the reference's own bars (`tests/test_kernels.py`): f32 atol
2e-5, bf16 atol 5e-2, odd shapes atol 1e-6, noise-only probe == 0.37·w to
1e-7. The antenna axis (gains `(B, M, N)`, noise `(B, M, d)`) is held,
antenna by antenna, to the Pallas kernel on that antenna's gains at the
same bars (the reference reaches the kernel once per antenna). The CUDA
kernel itself is checked on the card (`chip_smoke.py`,
`tests/test_torch_gpu.py`)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ota.ops import ota_edge_aggregate as jax_ota  # noqa: E402
from repro.kernels.ota.ref import ota_edge_aggregate_ref  # noqa: E402
from repro_torch.kernels.ota import ops  # noqa: E402
from repro_torch.kernels.ota.ops import ota_edge_aggregate  # noqa: E402
from repro_torch.kernels.ota.ref import \
    ota_edge_aggregate_ref as port_ref  # noqa: E402


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


# ------------------------------------------------ per-trajectory node counts
# a node-count sweep's rows (N in {50, 160, 500} at n_max = 500, d = 90,
# the fig3 sweep's shape cut to 2 trajectories per N) zero-padded
RAGGED_COUNTS = (50, 50, 160, 160, 500, 500)


def _ragged(dtype, seed=3, n_max=500, d=90):
    rs = np.random.default_rng(seed)
    b = len(RAGGED_COUNTS)
    g = rs.standard_normal((b, n_max, d)).astype(np.float32)
    h = np.abs(rs.standard_normal((b, n_max))).astype(np.float32)
    w = rs.standard_normal((b, d)).astype(np.float32)
    for i, n in enumerate(RAGGED_COUNTS):
        g[i, n:], h[i, n:] = 0.0, 0.0
    return g, h, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_trajectory_counts_match_jax_oracle_row_by_row(dtype):
    """Each padded row against the JAX oracle on its unpadded (N, d)
    slice, which divides by that N: the reference's bars."""
    g, h, w = _ragged(dtype)
    counts = torch.tensor(RAGGED_COUNTS, dtype=torch.float32)
    out = ota_edge_aggregate(torch.tensor(g).to(getattr(torch, dtype)),
                             torch.tensor(h), torch.tensor(w),
                             noise_scale=0.37, n_true=counts)
    atol = 2e-5 if dtype == "float32" else 5e-2
    for i, n in enumerate(RAGGED_COUNTS):
        gj = jnp.asarray(g[i, :n]).astype(getattr(jnp, dtype))
        ref = ota_edge_aggregate_ref(gj, jnp.asarray(h[i, :n]),
                                     jnp.asarray(w[i]), noise_scale=0.37)
        np.testing.assert_allclose(out[i].float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   atol=atol, rtol=1e-2)


def test_uniform_counts_equal_the_scalar_path():
    g, h, w = (torch.tensor(a) for a in _ragged("float32"))
    n_max = g.shape[1]
    counts = torch.full((g.shape[0],), float(n_max))
    scalar = ota_edge_aggregate(g, h, w, noise_scale=0.37)
    assert torch.equal(ota_edge_aggregate(g, h, w, noise_scale=0.37,
                                          n_true=counts), scalar)
    # the unbatched form takes a 0-d count
    one = ota_edge_aggregate(g[0], h[0], w[0], noise_scale=0.37,
                             n_true=torch.tensor(float(n_max)))
    assert torch.equal(one, scalar[0])


def test_counts_of_the_wrong_shape_raise():
    g, h, w = (torch.tensor(a) for a in _ragged("float32"))
    with pytest.raises(ValueError, match="counts"):
        ota_edge_aggregate(g, h, w, noise_scale=1.0,
                           n_true=torch.ones(g.shape[0] + 1))


# ------------------------------------------------------------ antenna axis
def _antenna_inputs(b, m, n, d, seed):
    rs = np.random.default_rng(seed)
    g = rs.standard_normal((b, n, d)).astype(np.float32)
    h = np.abs(rs.standard_normal((b, m, n))).astype(np.float32)
    w = rs.standard_normal((b, m, d)).astype(np.float32)
    return g, h, w


@pytest.mark.parametrize("b,m,n,d", [(2, 3, 100, 300), (1, 1, 130, 513),
                                     (3, 5, 7, 90), (2, 16, 64, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_antenna_axis_matches_pallas_per_antenna(b, m, n, d, dtype):
    """out[b, m] against the Pallas kernel (interpret mode) and the JAX
    oracle on (g[b], h[b, m], w[b, m]): the single-antenna bars."""
    g, h, w = _antenna_inputs(b, m, n, d, b * m * n + d)
    out = ota_edge_aggregate(torch.tensor(g).to(getattr(torch, dtype)),
                             torch.tensor(h), torch.tensor(w),
                             noise_scale=0.37)
    assert tuple(out.shape) == (b, m, d)
    assert out.dtype == getattr(torch, dtype)
    atol = 2e-5 if dtype == "float32" else 5e-2
    for i in range(b):
        for j in range(m):
            ref, pallas = _both_jax(g[i], h[i, j], w[i, j],
                                    getattr(jnp, dtype))
            for target in (ref, pallas):
                np.testing.assert_allclose(out[i, j].float().numpy(),
                                           target, atol=atol, rtol=1e-2)


def test_antenna_axis_with_counts_and_m1():
    """Per-trajectory counts divide every antenna of a trajectory; M = 1
    equals the single-antenna form; each antenna equals a single-antenna
    call on its own gains and noise."""
    g, h, w = (torch.tensor(a) for a in _ragged("float32"))
    b, n, d = g.shape
    rs = np.random.default_rng(9)
    hm = torch.tensor(np.abs(rs.standard_normal((b, 4, n))),
                      dtype=torch.float32) * (h > 0)[:, None]
    wm = torch.tensor(rs.standard_normal((b, 4, d)), dtype=torch.float32)
    counts = torch.tensor(RAGGED_COUNTS, dtype=torch.float32)
    out = ota_edge_aggregate(g, hm, wm, noise_scale=0.37, n_true=counts)
    for j in range(4):
        single = ota_edge_aggregate(g, hm[:, j], wm[:, j], noise_scale=0.37,
                                    n_true=counts)
        np.testing.assert_allclose(out[:, j].numpy(), single.numpy(),
                                   atol=1e-6, rtol=1e-6)
    one = ota_edge_aggregate(g, h[:, None], w[:, None], noise_scale=0.37,
                             n_true=counts)
    np.testing.assert_allclose(
        one[:, 0].numpy(),
        ota_edge_aggregate(g, h, w, noise_scale=0.37, n_true=counts).numpy(),
        atol=1e-6, rtol=1e-6)


def test_antenna_noise_of_the_wrong_shape_raises():
    g, h, w = (torch.tensor(a) for a in _antenna_inputs(2, 3, 8, 16, 0))
    with pytest.raises(ValueError, match="shape mismatch"):
        ota_edge_aggregate(g, h, w[:, 0], noise_scale=1.0)
    with pytest.raises(ValueError, match="shape mismatch"):
        ota_edge_aggregate(g, h[:, :, :-1], w, noise_scale=1.0)


def test_plain_version_accumulates_f64_inputs_in_f64():
    """f64 operands stay f64 (the card's checks of the antenna axis hold
    the kernel to this evaluation): equal to numpy's f64 sum to 1e-12."""
    g, h, w = _antenna_inputs(2, 3, 4096, 24, 11)
    counts = np.array([4096.0, 1000.0])
    out = port_ref(torch.tensor(g, dtype=torch.float64),
                   torch.tensor(h, dtype=torch.float64),
                   torch.tensor(w, dtype=torch.float64), noise_scale=0.37,
                   n_true=torch.tensor(counts))
    assert out.dtype == torch.float64
    ref = np.einsum("bmn,bnd->bmd", h.astype(np.float64),
                    g.astype(np.float64)) / counts[:, None, None] \
        + 0.37 * w.astype(np.float64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)


def _k1_order(g, h, w, n_true=None):
    """The CUDA kernel's arithmetic, in PyTorch: g (B, N, d), h (B, M, N),
    w (B, M, d), f32. Node group grp = n mod 8 sums its nodes in sequence,
    one fmaf each (emulated in f64, where h·g is exact, then rounded to
    f32); a fixed tree combines the groups (4, then 2, then 1 apart); the
    count divides after the tree; w is added."""
    b, n, d = g.shape
    g64, h64 = g.double(), h.double()
    parts = []
    for grp in range(8):
        acc = torch.zeros((b, h.shape[1], d), dtype=torch.float32)
        for node in range(grp, n, 8):
            acc = (h64[:, :, node, None] * g64[:, None, node, :]
                   + acc.double()).float()
        parts.append(acc)
    for stride in (4, 2, 1):
        for grp in range(stride):
            parts[grp] = parts[grp] + parts[grp + stride]
    count = float(n) if n_true is None else n_true[:, None, None]
    return parts[0] / count + w


@pytest.mark.parametrize("b,m,n,d,with_counts", [
    (3, 5, 131, 37, False), (2, 17, 500, 24, True), (1, 16, 4096, 24, False),
    (4, 1, 200, 90, True), (2, 20, 257, 90, False)])
def test_kernel_order_holds_the_bar_whatever_m(b, m, n, d, with_counts):
    """The order the CUDA kernel sums in (`_k1_order`) against the plain
    version at K1's bars: f32 atol 2e-5 (`tests/test_kernels.py`), and the
    f64 plain version at 1e-6 + 1e-5·|v| (the bar of antenna launches on
    the card). Each antenna's result is the same, bit for bit, whether it
    is summed alone or among M antennas: the order never depends on M, so
    an M-antenna launch has each antenna's single-antenna bits."""
    rs = np.random.default_rng(b * m + n + d)
    g = torch.tensor(rs.standard_normal((b, n, d)) + 1.0,
                     dtype=torch.float32)
    h = torch.tensor(np.abs(rs.standard_normal((b, m, n))),
                     dtype=torch.float32)
    w = torch.tensor(rs.standard_normal((b, m, d)), dtype=torch.float32)
    counts = None
    if with_counts:
        counts = torch.tensor(rs.integers(1, n + 1, b), dtype=torch.float32)
        lanes = torch.arange(n) < counts[:, None]
        g = g * lanes[..., None]
        h = h * lanes[:, None]
    out = _k1_order(g, h, w, counts)
    plain = port_ref(g, h, w, noise_scale=1.0, n_true=counts)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=2e-5,
                               rtol=0)
    plain64 = port_ref(g.double(), h.double(), w.double(), noise_scale=1.0,
                       n_true=None if counts is None else counts.double())
    assert torch.all((out.double() - plain64).abs()
                     <= 1e-6 + 1e-5 * plain64.abs())
    for j in {0, m // 2, m - 1}:
        alone = _k1_order(g, h[:, j:j + 1], w[:, j:j + 1], counts)
        assert torch.equal(alone[:, 0], out[:, j])
