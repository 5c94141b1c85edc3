"""The port's dense serving path against the JAX reference, on the CPU.

Reduced olmo-1b and repro-100m (2 layers, d_model 256, f32; `reduced()`
of each config), with the reference's parameters carried across by
`repro_torch.models.convert`. On the CPU the port's prefill attention is
the kernel's plain version and the reference's is its blockwise jnp path.

Bars: prefill and decode logits, and the cache's k/v, within atol 1e-4
and rtol 1e-4 (f32 sums taken in another order; measured ~1e-6); the
cache's `pos_ids` and every generated token exactly — greedy, and at
temperature 0.8 with the same seed through the port's threefry (the
reference computed in the original threefry layout, ROADMAP §3 R1).
"""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

ATOL = RTOL = 1e-4
B, S, MAX_LEN = 2, 10, 14


def _pair(arch, **overrides):
    jcfg = jax_get_config(arch).reduced().with_(**overrides)
    cfg = get_config(arch).reduced().with_(**overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = jax_build_model(jcfg)
    jparams = jm.init_params(jax.random.key(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(cfg), params


@pytest.fixture(scope="module", params=["olmo-1b", "repro-100m",
                                        "olmo-1b-gqa"])
def pair(request):
    if request.param == "olmo-1b-gqa":  # 4 query heads over 2 kv heads
        return _pair("olmo-1b", n_kv_heads=2)
    return _pair(request.param)


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _kv(cache):
    return cache["seg0"]["sub0"]["kv"]


def _assert_cache(cache, jcache):
    for name in ("k", "v"):
        np.testing.assert_allclose(_kv(cache)[name].numpy(),
                                   np.asarray(_kv(jcache)[name]),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(_kv(cache)["pos_ids"].numpy(),
                                  np.asarray(_kv(jcache)["pos_ids"]))


def test_prefill_and_decode_match_reference(pair):
    jm, jparams, m, params = pair
    toks = _tokens(m.cfg.vocab_size, (B, S))
    jlogits, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                 max_len=MAX_LEN)
    logits, cache = m.prefill(params, {"tokens": torch.from_numpy(toks)},
                              MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=RTOL)
    assert _kv(cache)["k"].shape == _kv(jcache)["k"].shape
    _assert_cache(cache, jcache)
    nxt = _tokens(m.cfg.vocab_size, (B,), seed=2)
    for pos in (S, S + 1):  # two steps: the second reads the first's slot
        jlogits, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt),
                                         jnp.asarray(pos, jnp.int32))
        logits, cache = m.decode_step(params, cache, torch.from_numpy(nxt),
                                      pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=RTOL)
        _assert_cache(cache, jcache)
        nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)


def test_decode_continues_prefill(pair):
    """prefill(S) + one decode step gives prefill(S + 1)'s last logits
    (the port alone, as tests/test_decode_consistency.py holds the
    reference)."""
    _, _, m, params = pair
    toks = torch.from_numpy(_tokens(m.cfg.vocab_size, (B, S)))
    ref, _ = m.prefill(params, {"tokens": toks}, MAX_LEN)
    _, cache = m.prefill(params, {"tokens": toks[:, :-1]}, MAX_LEN)
    inc, _ = m.decode_step(params, cache, toks[:, -1], S - 1)
    np.testing.assert_allclose(inc.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 3)])
def test_generate_matches_reference_tokens(pair, temperature, seed):
    jm, jparams, m, params = pair
    toks = _tokens(m.cfg.vocab_size, (B, 6), seed=4)
    with jax_original_layout():
        jout = JaxEngine(jm, jparams, JaxServeConfig(
            max_new_tokens=5, temperature=temperature, seed=seed)
        ).generate({"tokens": jnp.asarray(toks)})
        jout = np.asarray(jout)
    out = Engine(m, params, ServeConfig(
        max_new_tokens=5, temperature=temperature, seed=seed)
    ).generate({"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(out.numpy(), jout)


def test_convert_carries_bf16_bits():
    ref = jax.random.normal(jax.random.key(0), (3, 5), jnp.bfloat16)
    tree = {"w": np.asarray(ref), "norm": None}
    out = params_from_reference(tree)
    assert out["norm"] is None and out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  np.asarray(ref, np.float32))


def test_launcher_prints_the_reference_summary(capsys):
    serve.main(["--device", "cpu", "--arch", "repro-100m", "--batch", "2",
                "--prompt-len", "4", "--new-tokens", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"arch=repro-100m generated \(2, 2\) in "
                        r"[0-9.]+s \([0-9.]+ tok/s\)", line), line
