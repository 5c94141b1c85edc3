"""The port's threefry (`repro_torch.core.rng`) against `jax.random` in the
original threefry layout: key data, split, fold_in and bits bit-exact;
uniforms bit-exact; normals within 1e-6 relative (the port copies XLA's
f32 erf_inv polynomial; its log1p rounds differently by an ulp)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout, rel_err  # noqa: E402

from repro_torch.core import rng  # noqa: E402

SHAPES = [(1,), (7,), (90,), (4096,), (5, 2)]
SEEDS = [0, 7, 123457, 2**31 - 1]


def _jax_key(seed):
    return jax.random.key(seed)


def _key_data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bit_exact(seed):
    with jax_original_layout():
        k = _jax_key(seed)
        split5 = _key_data(jax.random.split(k, 5))
        split2 = _key_data(jax.random.split(k))
        folded = _key_data(jax.random.fold_in(k, 0x64617461))
        kd = _key_data(k)
    tk = rng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), kd)
    np.testing.assert_array_equal(rng.split(tk, 5).numpy(), split5)
    np.testing.assert_array_equal(rng.split(tk).numpy(), split2)
    np.testing.assert_array_equal(rng.fold_in(tk, 0x64617461).numpy(),
                                  folded)


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_bit_exact(shape):
    with jax_original_layout():
        ref = np.stack([np.asarray(jax.random.bits(_jax_key(s), shape))
                        for s in SEEDS]).astype(np.int64)
    out = rng.random_bits(rng.key(torch.tensor(SEEDS)), shape).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1e-12, 1.0), (-0.3, 0.3)])
def test_uniform_bit_exact(shape, lo, hi):
    with jax_original_layout():
        ref = np.stack([np.asarray(jax.random.uniform(
            _jax_key(s), shape, minval=lo, maxval=hi)) for s in SEEDS])
    out = rng.uniform(rng.key(torch.tensor(SEEDS)), shape, lo, hi).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_within_1e6_rel(shape):
    with jax_original_layout():
        ref = np.stack([np.asarray(jax.random.normal(_jax_key(s), shape))
                        for s in SEEDS])
    out = rng.normal(rng.key(torch.tensor(SEEDS)), shape).numpy()
    assert out.dtype == np.float32
    assert rel_err(out, ref) <= 1e-6


def test_normal_tails_within_1e6_rel():
    """The tails (|z| > 3.5), where torch.erfinv and XLA's erf_inv part by
    up to ~80 ulps, stay within the bar through the copied polynomial."""
    with jax_original_layout():
        ref = np.asarray(jax.random.normal(_jax_key(0), (200_000,)))
    out = rng.normal(rng.key(0), (200_000,)).numpy()
    tails = np.abs(ref) > 3.5
    assert tails.sum() > 10
    assert rel_err(out[tails], ref[tails]) <= 1e-6


def test_batched_keys_equal_single_draws():
    """One batched call equals per-key calls (the engine draws for all
    trajectories of a step at once)."""
    keys = rng.split(rng.key(3), 6)
    batched = rng.normal(keys, (33,))
    single = torch.stack([rng.normal(keys[i], (33,)) for i in range(6)])
    assert torch.equal(batched, single)


@pytest.mark.parametrize("n", [1, 3, 5, 9, 33, 101, 2, 4, 34, 100])
def test_odd_and_even_counts_bit_exact(n):
    """Counts of either parity, batched over keys: an odd count hashes its
    pad slot on counter 0, written as a fill on a one-element slice."""
    with jax_original_layout():
        bits = np.stack([np.asarray(jax.random.bits(_jax_key(s), (n,)))
                         for s in SEEDS]).astype(np.int64)
        u = np.stack([np.asarray(jax.random.uniform(_jax_key(s), (n,)))
                      for s in SEEDS])
    keys = rng.key(torch.tensor(SEEDS))
    np.testing.assert_array_equal(rng.random_bits(keys, (n,)).numpy(), bits)
    np.testing.assert_array_equal(rng.uniform(keys, (n,)).numpy(), u)


# ------------------------------------------------- randint, fold_in on data
RANDINT_CASES = [((), 0, 6), ((7,), 0, 6), ((5, 3), 3, 100_000),
                 ((4,), -5, 2**31 - 1), ((9,), 0, 1), ((6,), 0, 70_000),
                 ((33,), 0, 65_536)]


@pytest.mark.parametrize("shape,lo,hi", RANDINT_CASES)
def test_randint_bit_exact(shape, lo, hi):
    """`rng.randint` against `jax.random.randint` (int32): equal values,
    over spans below, at and above 2^16, where the multiplier
    (2^16 mod span)^2 wraps in uint32."""
    with jax_original_layout():
        ref = np.stack([np.asarray(jax.random.randint(
            _jax_key(s), shape, lo, hi)) for s in SEEDS]).astype(np.int64)
    out = rng.randint(rng.key(torch.tensor(SEEDS)), shape, lo, hi).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_fold_in_on_tensor_data_bit_exact():
    """A tensor `data` folds each entry in, broadcast against the keys:
    `fold_in(k[:, None], arange(n))` equals n scalar folds per key."""
    data = [0, 1, 7, 0x64617461, 2**32 - 1]
    with jax_original_layout():
        ref = np.stack([np.stack([_key_data(jax.random.fold_in(
            _jax_key(s), x)) for x in data]) for s in SEEDS])
    keys = rng.key(torch.tensor(SEEDS))
    out = rng.fold_in(keys[:, None], torch.tensor(data))
    assert tuple(out.shape) == (len(SEEDS), len(data), 2)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        rng.fold_in(keys, torch.tensor(7)).numpy(), ref[:, 2])


@pytest.mark.parametrize("n", [0, 1, 10, 11, 129, 4097, 65539])
def test_normal_in_passes_equals_one_pass(n, monkeypatch):
    """A draw longer than `NORMAL_PASS` counter pairs a key runs in passes
    (the transport's whole-model draws); with the pass cut to 64 pairs,
    odd and even lengths (and an empty draw), three keys at once: bit for
    bit the one-pass chain over `random_bits`, and the reference's normal
    within 1e-6 relative."""
    keys = rng.split(rng.key(3), 3)
    one = rng.u01_to_normal(rng.bits_to_u01(rng.random_bits(keys, (n,))))
    assert torch.equal(rng.normal(keys, (n,)), one)
    monkeypatch.setattr(rng, "NORMAL_PASS", 64)
    passes = rng.normal(keys, (n,))
    assert passes.shape == (3, n) and torch.equal(passes, one)
    with jax_original_layout():
        ref = np.asarray(jax.random.normal(jax.random.split(
            _jax_key(3), 3)[1], (n,)))
    if n:
        assert rel_err(passes[1].numpy(), ref) <= 1e-6


def test_bf16_normal_bit_exact():
    """`normal(..., dtype=bfloat16)` is JAX's own bf16 draw (8 random bits
    an element), not the f32 normal rounded: bit for bit, batched too."""
    with jax_original_layout():
        ref = np.asarray(jax.random.normal(_jax_key(21), (4099,),
                                           dtype=jax.numpy.bfloat16)
                         .astype(jax.numpy.float32))
        keys = jax.random.split(_jax_key(5), 3)
        ref_b = np.stack([np.asarray(jax.random.normal(
            k, (6,), dtype=jax.numpy.bfloat16).astype(jax.numpy.float32))
            for k in keys])
    out = rng.normal(rng.key(21), (4099,), dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert np.array_equal(out.float().numpy(), ref)
    out_b = rng.normal(rng.split(rng.key(5), 3), (6,), dtype=torch.bfloat16)
    assert np.array_equal(out_b.float().numpy(), ref_b)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rng.normal(rng.key(0), (3,), dtype=torch.float16)
