"""The port's unsafe_rbg keys (`core.rng`, `key(seed,
impl="unsafe_rbg")`) against JAX's `impl='unsafe_rbg'` keys, and training
with them (`TrainConfig(rng_impl="unsafe_rbg")`) against the reference's
jitted steps, on the CPU.

JAX 0.9.0's unsafe_rbg (`jax._src.prng`) seeds as rbg does
(`_rbg_seed`), draws rbg's bits (`_rbg_random_bits`: XLA's CPU
`RngBitGenerator`), but splits by taking every 10th row of a (10·num, 4)
draw of the key (`_unsafe_rbg_split`) and folds by XORing the key with
the last row of a (10, 4) draw of `_rbg_seed(data)`
(`_unsafe_rbg_fold_in`). Keys, split and folded keys and bits (uint32,
uint16, uint8) are held bit for bit, single and batched (a vmapped
split, fold or draw comes from the batch's first key or datum, as
`rng_bit_generator`'s batching rule draws); f32 normals within R2's
ulps (1e-6 absolute: |z| < 6), bf16 normals bit for bit. The kind
travels with the key data (`rng.UnsafeRbgKey`) through indexing,
reshapes, `.to`, `clone` and stacking.

The training trajectories: 4 steps of the fused gbma route and of gbma
and receiver momentum through the transport, on the reduced repro-100m,
from the reference's initialization; losses within 1e-5 relative and
parameters within 1e-6 + 1e-5·|p|, T6's bar (`test_torch_rbg.py`).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout, port_channel  # noqa: E402
from test_torch_rbg import (LOSS_RTOL, PARAM_BAR, ROUTES,  # noqa: E402
                            _channel)

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import transport as jt  # noqa: E402
from repro.core.gbma import GBMAConfig as JaxGBMAConfig  # noqa: E402
from repro.data.synthetic import SyntheticTokens as JaxTokens  # noqa: E402
from repro.data.synthetic import \
    TokenDatasetConfig as JaxTokenConfig  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import gd as jgd  # noqa: E402
from repro.training.loop import run_training as jax_run  # noqa: E402
from repro.training.train_step import \
    TrainConfig as JaxTrainConfig  # noqa: E402
from repro.training.train_step import \
    build_train_step as jax_build_step  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import rng, transport  # noqa: E402
from repro_torch.core.gbma import GBMAConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data.synthetic import (SyntheticTokens,  # noqa: E402
                                        TokenDatasetConfig)
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import gd  # noqa: E402
from repro_torch.training.loop import run_training  # noqa: E402
from repro_torch.training.train_step import (TrainConfig,  # noqa: E402
                                             build_train_step)

IMPL = "unsafe_rbg"
SIZES = (1, 3, 5, 1023, 2**20 + 3, (4, 3, 7))
WIDTHS = {32: jnp.uint32, 16: jnp.uint16, 8: jnp.uint8}
NORMAL_ATOL = 1e-6
STEPS, NODES, LR = 4, 4, 0.05
# a key whose words carry into the counter's higher words within a few
# blocks
WRAPPED = (0x00000001, 0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFFF)


def _data(k) -> torch.Tensor:
    return torch.from_numpy(
        np.asarray(jax.random.key_data(k)).astype(np.int64))


def _ours(k) -> torch.Tensor:
    """The reference key `k`'s data as the port's unsafe_rbg key."""
    return _data(k).as_subclass(rng.UnsafeRbgKey)


def _jax_keys() -> dict:
    with jax_original_layout():
        base = jax.random.key(12345, impl=IMPL)
        wrapped = jax.random.wrap_key_data(
            jnp.asarray(WRAPPED, jnp.uint32), impl=IMPL)
        return {"key": base, "split": jax.random.split(base, 3)[1],
                "fold_in": jax.random.fold_in(base, 7), "wrapped": wrapped,
                "split of wrapped": jax.random.split(wrapped, 5)[3]}


KEYS = _jax_keys()


def test_key_is_rbg_data_of_its_own_kind():
    for seed in (0, 1, 12345, 2**31 - 1):
        with jax_original_layout():
            ref = _data(jax.random.key(seed, impl=IMPL))
        ours = rng.key(seed, impl=IMPL)
        assert isinstance(ours, rng.UnsafeRbgKey) and rng.is_rbg(ours)
        assert torch.equal(ours.as_subclass(torch.Tensor), ref)
    assert torch.equal(rng.key(0, impl=IMPL).as_subclass(torch.Tensor),
                       torch.zeros(4, dtype=torch.int64))
    assert not rng.is_unsafe_rbg(rng.key(0, impl="rbg"))


def test_the_kind_travels_with_the_key():
    k = rng.split(rng.key(3, impl=IMPL), 4)
    views = {"index": k[1], "slice": k[1:3], "reshape": k.reshape(2, 2, 4),
             "to": k.to("cpu"), "clone": k.clone(),
             "stack": torch.stack([k[0], k[2]]), "detach": k.detach()}
    for name, v in views.items():
        assert rng.is_unsafe_rbg(v), name
    assert not rng.is_unsafe_rbg(rng.random_bits(k[0], (3,)))
    assert not rng.is_unsafe_rbg(rng.normal(k[0], (3,)))


@pytest.mark.parametrize("name", sorted(KEYS))
def test_split_and_fold_in_keys_match(name):
    k = KEYS[name]
    with jax_original_layout():
        splits = {num: _data(jax.random.split(k, num)) for num in (1, 2, 5)}
        folds = {d: _data(jax.random.fold_in(k, d)) for d in (0, 7, 2**31)}
        vfold = _data(jax.vmap(lambda d: jax.random.fold_in(k, d))(
            jnp.arange(4)))
    for num, ref in splits.items():
        out = rng.split(_ours(k), num)
        assert rng.is_unsafe_rbg(out) and torch.equal(out, ref), num
    for d, ref in folds.items():
        out = rng.fold_in(_ours(k), d)
        assert rng.is_unsafe_rbg(out) and torch.equal(out, ref), d
    assert torch.equal(rng.fold_in(_ours(k), torch.arange(4)), vfold)


def test_batched_keys_split_and_fold_from_the_first():
    """A batch of keys splits and folds as JAX's vmap does: one draw of
    the first key (or datum) for the whole batch."""
    keys = jax.random.split(KEYS["wrapped"], 6)
    with jax_original_layout():
        split = _data(jax.vmap(lambda k: jax.random.split(k, 3))(keys))
        fold = _data(jax.vmap(jax.random.fold_in)(keys, jnp.arange(6) + 3))
        fold_one = _data(jax.vmap(lambda k: jax.random.fold_in(k, 5))(keys))
    assert torch.equal(rng.split(_ours(keys), 3), split)
    assert torch.equal(rng.fold_in(_ours(keys), torch.arange(6) + 3), fold)
    assert torch.equal(rng.fold_in(_ours(keys), 5), fold_one)


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("name", ["key", "split", "fold_in",
                                  "split of wrapped"])
def test_bits_match_bit_for_bit(name, size, width):
    k = KEYS[name]
    shape = size if isinstance(size, tuple) else (size,)
    ref = np.asarray(jax.random.bits(k, shape, WIDTHS[width]))
    ours = rng.random_bits(_ours(k), shape, width=width)
    assert ours.shape == shape
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.int64))


def test_vmapped_draws_come_from_the_first_key():
    keys = jax.random.split(KEYS["wrapped"], 6)
    ref = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (5,), jnp.uint32))(keys))
    np.testing.assert_array_equal(
        rng.random_bits(_ours(keys), (5,)).numpy(), ref.astype(np.int64))
    grid = keys.reshape(2, 3)
    ref = np.asarray(jax.vmap(jax.vmap(
        lambda k: jax.random.normal(k, (5,))))(grid))
    np.testing.assert_allclose(rng.normal(_ours(grid), (5,)).numpy(), ref,
                               rtol=0, atol=NORMAL_ATOL)


@pytest.mark.parametrize("name", sorted(KEYS))
def test_normals_and_uniforms_match(name):
    k = KEYS[name]
    ref = np.asarray(jax.random.normal(k, (3, 1001)))
    np.testing.assert_allclose(rng.normal(_ours(k), (3, 1001)).numpy(), ref,
                               rtol=0, atol=NORMAL_ATOL)
    ref = np.asarray(jax.random.normal(k, (2049,), jnp.bfloat16))
    ours = rng.normal(_ours(k), (2049,), dtype=torch.bfloat16)
    np.testing.assert_array_equal(ours.float().numpy(),
                                  ref.astype(np.float32))
    ref = np.asarray(jax.random.uniform(k, (777,), minval=-2.0, maxval=3.0))
    np.testing.assert_array_equal(
        rng.uniform(_ours(k), (777,), -2.0, 3.0).numpy(), ref)


# ------------------------------------------------------------------ training
def _reference(case: str) -> tuple:
    algo, route = ROUTES[case]
    ch = _channel()
    jcfg = jax_get_config("repro-100m").reduced()
    tp = None if route == "auto" else jt.TransportConfig(
        n_nodes=NODES, channel=ch, gamma=0.9, stepsize=LR)
    tcfg = JaxTrainConfig(aggregator=algo, rng_impl=IMPL,
                          gbma=JaxGBMAConfig(n_nodes=NODES, channel=ch),
                          route=route, transport=tp)
    with jax_original_layout():
        m = jax_build_model(jcfg)
        step = jax_build_step(m, tcfg, jgd.momentum(LR))
        params = m.init_params(jax.random.key(0))
        init = jax.tree.map(np.asarray, params)
        ds = JaxTokens(JaxTokenConfig(vocab_size=jcfg.vocab_size,
                                      seq_len=16, global_batch=8, seed=3))
        params, _, hist = jax_run(step, params, step.init_state(params),
                                  ({"tokens": t} for t in ds), STEPS,
                                  log_every=1)
        leaves = [np.asarray(x, np.float32)
                  for x in jax.tree_util.tree_leaves(params)]
    return init, np.asarray([h["loss"] for h in hist], np.float32), leaves


def _port(case: str, init) -> tuple:
    algo, route = ROUTES[case]
    ch = port_channel(_channel())
    cfg = get_config("repro-100m").reduced()
    tp = None if route == "auto" else transport.TransportConfig(
        n_nodes=NODES, channel=ch, gamma=0.9, stepsize=LR)
    tcfg = TrainConfig(aggregator=algo, rng_impl=IMPL,
                       gbma=GBMAConfig(n_nodes=NODES, channel=ch),
                       route=route, transport=tp)
    step = build_train_step(build_model(cfg), tcfg, gd.momentum(LR))
    ds = SyntheticTokens(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=8, seed=3))
    params = params_from_reference(init)
    params, _, hist = run_training(step, params, step.init_state(params),
                                   ({"tokens": t} for t in ds), STEPS,
                                   log_every=1)
    return (np.asarray([h["loss"] for h in hist], np.float32),
            [x.float().numpy() for x in tree_leaves(params)], hist)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_unsafe_rbg_trajectory_matches_reference(case):
    init, ref_losses, ref_leaves = _reference(case)
    losses, leaves, hist = _port(case, init)
    loss_rel = float(np.max(np.abs(losses - ref_losses)
                            / np.abs(ref_losses)))
    margin = max(float(np.max(np.abs(a - b) / (PARAM_BAR[0]
                                               + PARAM_BAR[1] * np.abs(b))))
                 for a, b in zip(leaves, ref_leaves))
    print(f"{case} unsafe_rbg: losses {loss_rel:.3e} rel (bar {LOSS_RTOL}); "
          f"params at {margin:.3f} of the bar")
    assert len(losses) == STEPS and loss_rel <= LOSS_RTOL
    assert [a.shape for a in leaves] == [b.shape for b in ref_leaves]
    assert margin <= 1.0
    assert all(np.isfinite(h["grad_norm"]) for h in hist)


def test_unsafe_rbg_and_rbg_steps_differ():
    """The kind reaches the draws: one fused gbma step from the same
    parameters and batch moves them differently under rbg and
    unsafe_rbg keys (their fold_in and split differ)."""
    cfg = get_config("repro-100m").reduced()
    model = build_model(cfg)
    params = model.init_params(device="cpu")
    batch = {"tokens": torch.from_numpy(SyntheticTokens(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=8,
        seed=3)).batch(0))}
    out = {}
    for impl in ("rbg", IMPL):
        step = build_train_step(model, TrainConfig(
            rng_impl=impl, gbma=GBMAConfig(n_nodes=NODES,
                                           channel=port_channel(_channel()))),
            gd.gd(LR))
        new, _, _ = step(params, step.init_state(params), batch, 0)
        out[impl] = new["embed"]
    assert not torch.equal(out["rbg"], out[IMPL])
