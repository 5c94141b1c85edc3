"""The port's problem kinds against the reference's, on the CPU: the
`localization` (paper §VI-B) and `logistic` (Fig. 8) grad and risk rows,
padded and unpadded, the logistic minibatch index draw and its gradient
over given indices, the numpy data generators and the federated
partitions (`repro_torch.data`).

Inputs: the reference's own problems (`localization_mc_problem`,
`logistic_mc_problem`), stacked by `MCProblemBatch.stack` at N in {7, 12}
(padded to 12) and carried across as numpy arrays; θ drawn from a numpy
seed around the problem's optimum.

Bars: the data generators, partitions, pads and index draws are equal
(bits); padded node rows are exactly 0. Gradients within 1e-5 relative
of the largest entry of their row (sigmoid, exp and the dot products
round per library). The localization risk and the logistic risk, the
excess F(θ) − F* of an f32 objective F ≈ 0.5, within 1e-5 relative: at
equal θ the two agree that far, though XLA's and PyTorch's exp and log1p
differ by up to 3 ulps per sample (ROADMAP §3, F8).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout, port_problem  # noqa: E402

from repro.core.mc import problems as jproblems  # noqa: E402
from repro.core.montecarlo import (localization_mc_problem,  # noqa: E402
                                   logistic_mc_problem)
from repro.data import federated as jfederated  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch.core.mc import problems as tproblems  # noqa: E402
from repro_torch.data import federated as tfederated  # noqa: E402
from repro_torch.data import synthetic as tsynthetic  # noqa: E402

COUNTS = (7, 12)
SEEDS = 3
K = 6  # local samples per logistic node


def _localization(n, seed):
    r, x, src, _ = jsynthetic.localization_field(n, signal_a=100.0,
                                                 snr_db=-10.0, seed=seed)
    return localization_mc_problem(r, x, src, 100.0)


def _logistic(n, seed=0):
    X, y, _ = jsynthetic.logistic_classification(n * K, dim=16, seed=seed)
    return logistic_mc_problem(X, y, n, lam=0.1)


def _batches(make, counts):
    jps = [make(n, i) for i, n in enumerate(counts)]
    return (jproblems.MCProblemBatch.stack(jps),
            tproblems.MCProblemBatch.stack([port_problem(p) for p in jps]))


def _thetas(center: np.ndarray, spread: float, seed: int = 0) -> np.ndarray:
    """(C, S, d) f32 parameters around `center (C, d)`."""
    rs = np.random.default_rng(seed)
    c, d = center.shape
    return (center[:, None] + spread * rs.standard_normal((c, SEEDS, d))
            ).astype(np.float32)


def _jax_rows(fn, batch, thetas) -> np.ndarray:
    """The reference's row function over rows and seeds."""
    return np.asarray(jax.vmap(lambda row, th: jax.vmap(
        lambda t: fn(row, t))(th))(batch.data, jnp.asarray(thetas)))


def _assert_grads(out, ref):
    scale = np.max(np.abs(ref), axis=(2, 3), keepdims=True)
    assert np.all(np.abs(out - ref) <= 1e-5 * scale)


@pytest.mark.parametrize("counts", [(12, 12), COUNTS])
def test_localization_rows_match_reference(counts):
    jb, tb = _batches(_localization, counts)
    thetas = _thetas(np.asarray(jb.data["src"]), 15.0)
    ref_g = _jax_rows(jb.grad_fn, jb, thetas)
    ref_r = _jax_rows(jb.risk_fn, jb, thetas)
    out_g = tb.grad_fn(tb.data, torch.tensor(thetas)).numpy()
    out_r = tb.risk_fn(tb.data, torch.tensor(thetas)).numpy()
    assert out_g.shape == ref_g.shape and np.all(np.isfinite(out_g))
    _assert_grads(out_g, ref_g)
    np.testing.assert_allclose(out_r, ref_r, rtol=1e-5, atol=0)
    for c, n in enumerate(counts):  # padded sensors give exact zeros
        assert not out_g[c, :, n:].any()
    pad = tb.data["r"][0, counts[0]:]
    assert torch.all(pad == 1.0e6)


def test_localization_pad_keeps_padded_rows_finite():
    """A padded sensor at the source would make 0·inf = NaN; the 1e6 pad
    keeps the padded rows finite before the mask."""
    _, tb = _batches(_localization, COUNTS)
    src = tb.data["src"][:, None, :].expand(-1, SEEDS, -1).contiguous()
    g = tb.grad_fn(tb.data, src)
    assert torch.all(torch.isfinite(g))


@pytest.mark.parametrize("counts", [(12, 12), COUNTS])
def test_logistic_rows_match_reference(counts):
    jb, tb = _batches(lambda n, i: _logistic(n), counts)
    thetas = _thetas(np.asarray(jb.data["theta_star"]), 0.3)
    ref_g = _jax_rows(jb.grad_fn, jb, thetas)
    ref_r = _jax_rows(jb.risk_fn, jb, thetas)
    out_g = tb.grad_fn(tb.data, torch.tensor(thetas)).numpy()
    out_r = tb.risk_fn(tb.data, torch.tensor(thetas)).numpy()
    _assert_grads(out_g, ref_g)
    bar = 1e-5 * np.abs(ref_r)
    assert np.all(np.abs(out_r - ref_r) <= bar)
    for c, n in enumerate(counts):
        assert not out_g[c, :, n:].any()


def test_logistic_index_draws_bit_exact():
    """The minibatch indices: entry (n, j) from fold_in(fold_in(key, j),
    n), equal to the reference's draw for every trajectory, whatever the
    padded N and the lane count."""
    jb, tb = _batches(lambda n, i: _logistic(n), COUNTS)
    b_max = 5
    with jax_original_layout():
        keys = [jax.random.fold_in(jax.random.key(3), i) for i in range(4)]
        ref = np.stack([np.asarray(jproblems._logistic_sample_idx_row(
            jax.tree_util.tree_map(lambda v: v[0], jb.data), k, b_max))
            for k in keys]).astype(np.int64)
        kd = np.stack([np.asarray(jax.random.key_data(k)) for k in keys])
    out = tproblems._logistic_sample_idx_row(
        tb.data, torch.tensor(kd.astype(np.int64)), b_max)
    assert tuple(out.shape) == (4, max(COUNTS), b_max)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert int(out.min()) >= 0 and int(out.max()) < K
    narrow = tproblems._logistic_sample_idx_row(
        tb.data, torch.tensor(kd.astype(np.int64)), 2)
    np.testing.assert_array_equal(narrow.numpy(), ref[..., :2])


def test_logistic_minibatch_gradient_matches_reference():
    """The gradient over given indices, each row using its own first
    b_count lanes: within 1e-5 of each row's largest entry."""
    jb, tb = _batches(lambda n, i: _logistic(n), COUNTS)
    thetas = _thetas(np.asarray(jb.data["theta_star"]), 0.3, seed=1)
    rs = np.random.default_rng(2)
    idx = rs.integers(0, K, size=(len(COUNTS), SEEDS, max(COUNTS), 4))
    b_count = np.array([4, 2])
    ref = np.asarray(jax.vmap(lambda row, th, ix, bc: jax.vmap(
        lambda t, i: jproblems._logistic_sgrad_from_idx_row(row, t, i, bc))(
            th, ix))(jb.data, jnp.asarray(thetas), jnp.asarray(idx,
                                                                jnp.int32),
                     jnp.asarray(b_count, jnp.int32)))
    out = tproblems._logistic_sgrad_from_idx_row(
        tb.data, torch.tensor(thetas), torch.tensor(idx),
        torch.tensor(b_count)).numpy()
    _assert_grads(out, ref)


def test_logistic_problem_arrays_equal_reference():
    """The port's constructor (its own partition and f64 Newton solve)
    gives the reference's arrays bit for bit."""
    X, y, _ = jsynthetic.logistic_classification(13 * K, dim=16, seed=0)
    ref = logistic_mc_problem(X, y, 13, lam=0.1)
    out = tproblems.logistic_mc_problem(X, y, 13, lam=0.1, device="cpu")
    assert out.stochastic and out.n_nodes == 13 and out.dim == 16
    for name, leaf in ref.data.items():
        np.testing.assert_array_equal(out.data[name].numpy(),
                                      np.asarray(leaf), err_msg=name)
    with pytest.raises(ValueError, match="±1"):
        tproblems.logistic_mc_problem(X, np.abs(y) * 2, 13, device="cpu")
    with pytest.raises(ValueError, match="evenly"):
        tproblems.logistic_mc_problem(X[:-1], y[:-1], 13, device="cpu")


def test_localization_problem_arrays_equal_reference():
    r, x, src, _ = tsynthetic.localization_field(9, seed=4)
    ref = localization_mc_problem(r, x, src, 100.0)
    out = tproblems.localization_mc_problem(r, x, src, 100.0, device="cpu")
    assert out.n_nodes == 9 and out.dim == 2 and not out.stochastic
    for name, leaf in ref.data.items():
        np.testing.assert_array_equal(out.data[name].numpy(),
                                      np.asarray(leaf), err_msg=name)


@pytest.mark.parametrize("seed", [0, 3])
def test_data_generators_equal_reference(seed):
    for name, args in (("logistic_classification", (50,)),
                       ("localization_field", (40,)),
                       ("msd_like_regression", (30, 8))):
        ref = getattr(jsynthetic, name)(*args, seed=seed)
        out = getattr(tsynthetic, name)(*args, seed=seed)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n_nodes", [1, 4, 7])
def test_partitions_equal_reference(n_nodes):
    X, y, _ = jsynthetic.logistic_classification(28, dim=5, seed=1)
    for name in ("partition_rows", "partition_noniid"):
        ref = getattr(jfederated, name)(X, y, n_nodes)
        out = getattr(tfederated, name)(X, y, n_nodes)
        assert len(out) == len(ref) == n_nodes
        for (ox, oy), (rx, ry) in zip(out, ref):
            np.testing.assert_array_equal(ox, rx)
            np.testing.assert_array_equal(oy, ry)
    shards = tfederated.partition_noniid(X, y, n_nodes)
    labels = np.concatenate([py for _, py in shards])
    assert np.all(np.diff(labels) >= 0)  # label-sorted shards
    spec = tfederated.FederatedSpec(n_nodes=n_nodes, global_batch=28)
    ref_spec = jfederated.FederatedSpec(n_nodes=n_nodes, global_batch=28)
    assert spec.examples_per_node == ref_spec.examples_per_node
    np.testing.assert_array_equal(spec.node_of_example(),
                                  ref_spec.node_of_example())
    with pytest.raises(ValueError, match="divide"):
        tfederated.FederatedSpec(n_nodes=5, global_batch=28)
