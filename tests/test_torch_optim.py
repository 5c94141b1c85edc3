"""The port's optimizers (`repro_torch.optim.gd`) and the training data
(`repro_torch.data.synthetic.SyntheticTokens`) against the JAX
reference's, on the CPU.

Each optimizer runs 5 updates on the same parameter and gradient trees
(numpy inputs from a seed) in both packages: parameters and states
within 1e-6 + 1e-6·|x| (f32 updates in the same order; the measured
gap is printed). The clip takes a precomputed norm. The token batches
are equal bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.synthetic import SyntheticTokens as JaxTokens  # noqa: E402
from repro.data.synthetic import \
    TokenDatasetConfig as JaxTokenConfig  # noqa: E402
from repro.optim import gd as jgd  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.synthetic import (SyntheticTokens,  # noqa: E402
                                        TokenDatasetConfig)
from repro_torch.optim import gd  # noqa: E402

BAR = (1e-6, 1e-6)


def _trees(seed):
    rs = np.random.default_rng(seed)
    params = {"w": rs.standard_normal((4, 6)).astype(np.float32),
              "b": {"c": rs.standard_normal((5,)).astype(np.float32)}}
    grads = [tree_map(lambda p: rs.standard_normal(p.shape).astype(
        np.float32), params) for _ in range(5)]
    return params, grads


def _np_leaves(tree, jax_tree: bool) -> list:
    if jax_tree:
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
    return [x.numpy() for x in tree_leaves(tree)]


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _margin(ours, ref) -> float:
    return max(float(np.max(np.abs(a.astype(np.float64) - b)
                            / (BAR[0] + BAR[1] * np.abs(b))))
               for a, b in zip(ours, ref))


@pytest.mark.parametrize("name", ["gd", "momentum", "adam"])
def test_optimizer_matches_reference_over_5_updates(name):
    params, grads = _trees(3)
    jopt, opt = jgd.get_optimizer(name, 0.05), gd.get_optimizer(name, 0.05)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _torch(params)
    ts = opt.init(tp)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = opt.update(_torch(g), ts, tp)
    m_params = _margin(_np_leaves(tp, False), _np_leaves(jp, True))
    m_state = _margin(_np_leaves(ts, False), _np_leaves(js, True)) \
        if name != "gd" else 0.0
    print(f"{name}: params at {m_params:.3f}, state at {m_state:.3f} of "
          "the bar")
    assert m_params <= 1.0 and m_state <= 1.0
    if name == "adam":
        assert ts["t"].dtype == torch.int32 and int(ts["t"]) == 5


def test_updates_keep_the_parameter_dtype():
    """f32 arithmetic, cast back to each parameter's dtype."""
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(2)}
    grads = tree_map(lambda p: torch.full(p.shape, 0.5, dtype=p.dtype),
                     params)
    for name in ("gd", "momentum", "adam"):
        opt = gd.get_optimizer(name, 0.1)
        new, state = opt.update(grads, opt.init(params), params)
        assert new["a"].dtype == torch.bfloat16
        assert new["b"].dtype == torch.float32
        if name != "gd":
            assert all(x.dtype in (torch.float32, torch.int32)
                       for x in tree_leaves(state))
    with pytest.raises(ValueError):
        gd.get_optimizer("sgd", 0.1)


@pytest.mark.parametrize("max_norm", [2.5, 10.0, 1e-3])
def test_clip_with_a_precomputed_norm_matches_reference(max_norm):
    _, grads = _trees(4)
    g = grads[0]
    jg = jax.tree.map(jnp.asarray, g)
    ref = jgd.clip_by_global_norm(jg, max_norm, norm=jgd.global_norm(jg))
    tg = _torch(g)
    norm = gd.global_norm(tg)
    ours = gd.clip_by_global_norm(tg, max_norm, norm=norm)
    assert float(norm) == pytest.approx(float(jgd.global_norm(jg)),
                                        rel=1e-6)
    assert _margin(_np_leaves(ours, False), _np_leaves(ref, True)) <= 1.0
    again = gd.clip_by_global_norm(tg, max_norm)
    for a, b in zip(tree_leaves(again), tree_leaves(ours)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (64, 16, 8, 3), (32000, 256, 8, 0), (512, 33, 3, 7)])
def test_synthetic_tokens_equal_reference(vocab, seq, batch, seed):
    ours = SyntheticTokens(TokenDatasetConfig(vocab, seq, batch, seed=seed))
    ref = JaxTokens(JaxTokenConfig(vocab, seq, batch, seed=seed))
    for step, (a, b) in enumerate(zip(ours, ref)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        if step == 2:
            break
    np.testing.assert_array_equal(ours.batch(11), ref.batch(11))
