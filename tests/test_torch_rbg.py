"""The port's rbg keys (`core.rng`, `key(seed, impl="rbg")`) against
JAX's `impl='rbg'` keys, and training with them (`TrainConfig(
rng_impl="rbg")`) against the reference's jitted steps, on the CPU.

Keys and bits are held bit for bit: uint32, uint16 and uint8 draws at
sizes 1, 3, 5, 1,023 and 2^20 + 3 and at a 3-D shape, from keys made by
`key`, `split` (including a split of a key whose halves differ, so the
counter's word order shows), `fold_in` and wrapped key data; split and
fold_in keys word for word; a vmapped draw over a batch of keys. f32
normals within R2's ulps (1e-6 absolute here: |z| < 6), bf16 normals
bit for bit. Reference values are computed inside
`jax.threefry_partitionable(False)` (ROADMAP §3, R1), which the rbg
halves' threefry split follows.

The training trajectories: 4 steps of the fused gbma route and of gbma
and receiver momentum through the transport, on the reduced repro-100m
and olmo-1b, from the reference's initialization; losses within 1e-5
relative and parameters within 1e-6 + 1e-5·|p|, as `test_torch_train.py`
holds the threefry steps.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout, port_channel  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import transport as jt  # noqa: E402
from repro.core.channel import ChannelConfig  # noqa: E402
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

SIZES = (1, 3, 5, 1023, 2**20 + 3, (4, 3, 7))
WIDTHS = {32: jnp.uint32, 16: jnp.uint16, 8: jnp.uint8}
NORMAL_ATOL = 1e-6
STEPS, NODES, LR = 4, 4, 0.05
LOSS_RTOL = 1e-5
PARAM_BAR = (1e-6, 1e-5)  # atol + rtol * |p|
# a key whose halves differ and whose low counter words carry into the
# high ones within a few blocks
WRAPPED = (0x00000001, 0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFFF)


def _data(k) -> torch.Tensor:
    return torch.from_numpy(
        np.asarray(jax.random.key_data(k)).astype(np.int64))


def _jax_keys() -> dict:
    """The reference's rbg keys of every making, by name."""
    with jax_original_layout():
        base = jax.random.key(12345, impl="rbg")
        wrapped = jax.random.wrap_key_data(
            jnp.asarray(WRAPPED, jnp.uint32), impl="rbg")
        return {"key": base, "split": jax.random.split(base, 3)[1],
                "fold_in": jax.random.fold_in(base, 7), "wrapped": wrapped,
                "split of wrapped": jax.random.split(wrapped, 5)[3]}


KEYS = _jax_keys()


def test_key_is_the_threefry_key_twice():
    for seed in (0, 1, 12345, 2**31 - 1):
        with jax_original_layout():
            ref = _data(jax.random.key(seed, impl="rbg"))
        assert torch.equal(rng.key(seed, impl="rbg"), ref)
    assert rng.key(3, impl="rbg").shape == (4,)
    assert torch.equal(rng.key(torch.tensor([1, 2]), impl="rbg"),
                       torch.tensor([[0, 1, 0, 1], [0, 2, 0, 2]]))
    with pytest.raises(ValueError, match="impl must be"):
        rng.key(0, impl="philox")


@pytest.mark.parametrize("name", sorted(KEYS))
def test_split_and_fold_in_keys_match(name):
    k = KEYS[name]
    with jax_original_layout():
        splits = {num: _data(jax.random.split(k, num)) for num in (1, 2, 5)}
        folds = {d: _data(jax.random.fold_in(k, d)) for d in (0, 7, 2**31)}
        vfold = _data(jax.vmap(lambda d: jax.random.fold_in(k, d))(
            jnp.arange(4)))
    for num, ref in splits.items():
        assert torch.equal(rng.split(_data(k), num), ref), num
    for d, ref in folds.items():
        assert torch.equal(rng.fold_in(_data(k), d), ref), d
    assert torch.equal(rng.fold_in(_data(k), torch.arange(4)), vfold)


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("name", ["key", "split", "fold_in",
                                  "split of wrapped"])
def test_bits_match_bit_for_bit(name, size, width):
    k = KEYS[name]
    shape = size if isinstance(size, tuple) else (size,)
    ref = np.asarray(jax.random.bits(k, shape, WIDTHS[width]))
    ours = rng.random_bits(_data(k), shape, width=width)
    assert ours.shape == shape
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.int64))


def test_counter_carries_across_its_words():
    """A key whose counter words are near 2^32: the draw's blocks carry
    from word to word of the 128-bit counter, as XLA's do."""
    k = KEYS["wrapped"]
    ref = np.asarray(jax.random.bits(k, (64,), jnp.uint32))
    np.testing.assert_array_equal(
        rng.random_bits(_data(k), (64,)).numpy(), ref.astype(np.int64))


def test_vmapped_draws_come_from_the_first_key():
    """A batch of rbg keys draws as JAX's vmap of the draw does: one
    stream from the batch's first key (`rng_bit_generator`'s batching
    rule), so one call matches the reference's vmapped one."""
    keys = jax.random.split(KEYS["wrapped"], 6)
    ref = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (5,), jnp.uint32))(keys))
    np.testing.assert_array_equal(rng.random_bits(_data(keys), (5,)).numpy(),
                                  ref.astype(np.int64))
    grid = keys.reshape(2, 3)
    ref = np.asarray(jax.vmap(jax.vmap(
        lambda k: jax.random.normal(k, (5,))))(grid))
    np.testing.assert_allclose(rng.normal(_data(grid), (5,)).numpy(), ref,
                               rtol=0, atol=NORMAL_ATOL)


@pytest.mark.parametrize("name", sorted(KEYS))
def test_normals_and_uniforms_match(name):
    k = KEYS[name]
    ref = np.asarray(jax.random.normal(k, (3, 1001)))
    np.testing.assert_allclose(rng.normal(_data(k), (3, 1001)).numpy(), ref,
                               rtol=0, atol=NORMAL_ATOL)
    ref = np.asarray(jax.random.normal(k, (2049,), jnp.bfloat16))
    ours = rng.normal(_data(k), (2049,), dtype=torch.bfloat16)
    np.testing.assert_array_equal(ours.float().numpy(),
                                  ref.astype(np.float32))
    ref = np.asarray(jax.random.uniform(k, (777,), minval=-2.0, maxval=3.0))
    np.testing.assert_array_equal(
        rng.uniform(_data(k), (777,), -2.0, 3.0).numpy(), ref)


def test_normal_in_passes_matches_one_draw(monkeypatch):
    """The f32 normal of a wide draw runs in passes of 2·NORMAL_PASS
    outputs; shrunk here, the passes give the reference's normals."""
    k = KEYS["split"]
    ref = np.asarray(jax.random.normal(k, (1000,)))
    monkeypatch.setattr(rng, "NORMAL_PASS", 64)
    np.testing.assert_allclose(rng.normal(_data(k), (1000,)).numpy(), ref,
                               rtol=0, atol=NORMAL_ATOL)


def test_engine_only_layouts_refuse_rbg_keys():
    with pytest.raises(ValueError, match="threefry"):
        rng.dynamic_bits(rng.key(torch.tensor([1]), impl="rbg"),
                         torch.tensor([3]), 4)
    with pytest.raises(ValueError, match="threefry"):
        rng.random_bits(rng.key(0), (3,), width=16)
    with pytest.raises(ValueError, match="words"):
        rng.split(torch.zeros(3, dtype=torch.int64))


# ------------------------------------------------------------------ training
def _channel():
    return ChannelConfig(fading="rayleigh", noise_std=0.05, energy=1.0,
                         phase_error_max=0.3)


ROUTES = {"gbma fused": ("gbma", "auto"),
          "gbma transport": ("gbma", "transport"),
          "momentum transport": ("momentum", "transport")}


def _reference(arch: str, case: str) -> tuple:
    algo, route = ROUTES[case]
    ch = _channel()
    jcfg = jax_get_config(arch).reduced()
    tp = None if route == "auto" else jt.TransportConfig(
        n_nodes=NODES, channel=ch, gamma=0.9, stepsize=LR)
    tcfg = JaxTrainConfig(aggregator=algo, rng_impl="rbg",
                          gbma=JaxGBMAConfig(n_nodes=NODES, channel=ch),
                          route=route, transport=tp)
    with jax_original_layout():
        m = jax_build_model(jcfg)
        step = jax_build_step(m, tcfg, jgd.momentum(LR))
        params = m.init_params(jax.random.key(0))
        init = jax.tree.map(np.asarray, params)
        ds = JaxTokens(JaxTokenConfig(vocab_size=jcfg.vocab_size,
                                      seq_len=16, global_batch=8, seed=3))
        # run_training jits the step
        params, _, hist = jax_run(step, params, step.init_state(params),
                                  ({"tokens": t} for t in ds), STEPS,
                                  log_every=1)
        leaves = [np.asarray(x, np.float32)
                  for x in jax.tree_util.tree_leaves(params)]
    return init, np.asarray([h["loss"] for h in hist], np.float32), leaves


def _port(arch: str, case: str, init) -> tuple:
    algo, route = ROUTES[case]
    ch = port_channel(_channel())
    cfg = get_config(arch).reduced()
    tp = None if route == "auto" else transport.TransportConfig(
        n_nodes=NODES, channel=ch, gamma=0.9, stepsize=LR)
    tcfg = TrainConfig(aggregator=algo, rng_impl="rbg",
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
@pytest.mark.parametrize("arch", ["repro-100m", "olmo-1b"])
def test_rbg_trajectory_matches_reference(arch, case):
    init, ref_losses, ref_leaves = _reference(arch, case)
    losses, leaves, hist = _port(arch, case, init)
    loss_rel = float(np.max(np.abs(losses - ref_losses)
                            / np.abs(ref_losses)))
    margin = max(float(np.max(np.abs(a - b) / (PARAM_BAR[0]
                                               + PARAM_BAR[1] * np.abs(b))))
                 for a, b in zip(leaves, ref_leaves))
    print(f"{arch} {case} rbg: losses {loss_rel:.3e} rel (bar "
          f"{LOSS_RTOL}); params at {margin:.3f} of the bar")
    assert len(losses) == STEPS and loss_rel <= LOSS_RTOL
    assert [a.shape for a in leaves] == [b.shape for b in ref_leaves]
    assert margin <= 1.0
    assert all(math.isfinite(h["grad_norm"]) for h in hist)


def test_rbg_and_threefry_steps_differ():
    """The key kind reaches the draws: one fused gbma step from the same
    parameters and batch moves them differently under the two kinds."""
    cfg = get_config("repro-100m").reduced()
    model = build_model(cfg)
    params = model.init_params(device="cpu")
    batch = {"tokens": torch.from_numpy(SyntheticTokens(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=8,
        seed=3)).batch(0))}
    out = {}
    for impl in ("threefry2x32", "rbg"):
        step = build_train_step(model, TrainConfig(
            rng_impl=impl, gbma=GBMAConfig(n_nodes=NODES,
                                           channel=port_channel(_channel()))),
            gd.gd(LR))
        new, _, _ = step(params, step.init_state(params), batch, 0)
        out[impl] = new["embed"]
    assert not torch.equal(out["threefry2x32"], out["rbg"])
