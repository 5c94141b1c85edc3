"""The int8 KV cache and head padding (S3) of the port against the JAX
reference, on the CPU.

Reduced gemma-7b (a global cache) and gemma2-9b (a local ring of 16
slots beside a global cache), `opt_int8_cache=True`, in f32, the
reference's parameters carried across by `repro_torch.models.convert`.

* `attention.quantize` against the reference's `_quantize` on the same
  inputs: the int8 values and the scales bit for bit (both round half
  to even), ties and all-zero rows included; and `cache_write` into an
  int8 ring against the reference's on the same keys, through a wrap,
  every leaf bit for bit.
* The whole cache after a prefill past the window and after 3 decode
  steps: `pos_ids` bit for bit; the scales, max|k| / 127 of keys the two
  packages project with different summation orders, within SCALE_RTOL
  (measured 1.2e-6); the int8 values within 1, where a key sits within
  an f32 rounding of a half step (1 of 14,336 values in one case), and
  at most INT8_FLIPS of them. The reference's prefill
  cache is rolled into the ring's layout first (`_ring_aligned`, ROADMAP
  §3 F14).
* The logits within atol 1e-4 + rtol 1e-4 of the reference's, and
  within the reference's own int8-vs-fp bars (0.05 prefill, 0.08
  decode, `tests/test_int8_cache.py`) of the port's f32-cache logits,
  with the same greedy token.
* The cache's bytes under half of the f32 cache's.
* `opt_pad_heads`: the loss equal to the loss without it bit for bit,
  and within atol 1e-3 + rtol 1e-4 of the reference's padded loss
  (`tests/test_perf_opts.py`).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout  # noqa: E402
from test_torch_serve_s2 import _subs  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.attention import _quantize as jax_quantize  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.attention import quantize  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ATOL = RTOL = 1e-4
SCALE_RTOL = 1e-5  # the keys' own f32 rounding gap
INT8_FLIPS = 1e-3  # share of int8 values off by one
INT8_BARS = {"prefill": 0.05, "decode": 0.08}  # the reference's own
B, S, STEPS = 2, 24, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(arch, **extra):
    jcfg = jax_get_config(arch).reduced().with_(**extra)
    cfg = get_config(arch).reduced().with_(**extra)
    jm = jax_build_model(jcfg)
    with jax_original_layout():
        jparams = jm.init_params(jax.random.key(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(cfg), params


def _ring_aligned(jcache, s: int):
    """The reference's prefill cache with each kept position p in slot
    p mod cache_len, its scales moved with their keys (as
    `test_torch_serve_s2._ring_aligned`, ROADMAP §3 F14)."""
    def align(kv):
        n = kv["pos_ids"].shape[-1]
        shift = (s - min(s, n)) % n
        return {name: jnp.roll(x, shift, axis=-1 if name == "pos_ids"
                               else -2) for name, x in kv.items()}

    return {seg: {sub: {**c, "kv": align(c["kv"])}
                  for sub, c in subs.items()}
            for seg, subs in jcache.items()}


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_the_references_bits(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 40, 32)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero row: the scale's floor of 1e-8
    # exact halves after scaling: max 127 makes the scale 1, so x/scale
    # lands on .5 and rounds half to even
    x[0, 1, 1] = np.arange(32, dtype=np.float32) - 15.5
    x[0, 1, 1, 0] = 127.0
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jax_quantize(jx)
    q, s = quantize(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[0, 0, 0, 0]) == np.float32(1e-8)
    # -14.5, -13.5 and 15.5 round half to even
    assert q[0, 1, 1, [1, 2, 31]].tolist() == [-14, -14, 16]


def test_cache_write_is_the_references_bits():
    """Decode writes into a 5-slot int8 ring, past its wrap: k, v, the
    scales and pos_ids equal the reference's bit for bit."""
    from repro.models.attention import cache_write as jax_cache_write
    from repro.models.attention import init_kv_cache as jax_init_kv_cache
    from repro_torch.models.attention import cache_write, init_kv_cache

    cfg = get_config("gemma-7b").reduced().with_(opt_int8_cache=True)
    jcache = jax_init_kv_cache(2, 5, cfg)
    cache = init_kv_cache(2, 5, cfg)
    rng = np.random.default_rng(11)
    for pos in range(8):
        k, v = (rng.standard_normal((2, cfg.n_kv_heads, 1, cfg.head_dim))
                .astype(np.float32) for _ in range(2))
        jcache = jax_cache_write(jcache, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos, jnp.int32))
        cache = cache_write(cache, torch.from_numpy(k), torch.from_numpy(v),
                            pos)
        assert sorted(cache) == sorted(jcache)
        for name in cache:
            np.testing.assert_array_equal(cache[name].numpy(),
                                          np.asarray(jcache[name]),
                                          err_msg=f"{name} at {pos}")


def _assert_int8_cache(cache, jcache):
    ours, ref = _subs(cache), _subs(jcache)
    assert [n for n, _ in ours] == [n for n, _ in ref]
    for (name, kv), (_, jkv) in zip(ours, ref):
        assert sorted(kv) == sorted(jkv) == ["k", "k_scale", "pos_ids", "v",
                                             "v_scale"], name
        assert kv["pos_ids"].dtype == torch.int32
        np.testing.assert_array_equal(kv["pos_ids"].numpy(),
                                      np.asarray(jkv["pos_ids"]))
        for leaf in ("k", "v"):
            assert kv[leaf].dtype == torch.int8, name
            off = np.abs(kv[leaf].numpy().astype(np.int32)
                         - np.asarray(jkv[leaf]).astype(np.int32))
            assert off.max() <= 1 and off.mean() <= INT8_FLIPS, \
                (name, leaf, off.max(), off.mean())
        for leaf in ("k_scale", "v_scale"):
            np.testing.assert_allclose(kv[leaf].numpy(),
                                       np.asarray(jkv[leaf]), rtol=SCALE_RTOL,
                                       atol=0, err_msg=f"{name} {leaf}")


@pytest.mark.parametrize("arch", ["gemma-7b", "gemma2-9b"])
def test_int8_cache_matches_reference(arch):
    """Prefill 24 tokens (past gemma2-9b's window of 16, not a multiple
    of it) and decode 3: the cache after each call and the logits."""
    jm, jparams, m, params = _pair(arch, opt_int8_cache=True)
    _, _, m_fp, _ = _pair(arch)
    prompt = _tokens(m.cfg.vocab_size, (B, S))
    max_len = S + STEPS + 1
    jlogits, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                 max_len=max_len)
    jcache = _ring_aligned(jcache, S)
    logits, cache = m.prefill(params, {"tokens": torch.from_numpy(prompt)},
                              max_len)
    fp_logits, fp_cache = m_fp.prefill(
        params, {"tokens": torch.from_numpy(prompt)}, max_len)
    steps = [("prefill", logits, jlogits, fp_logits)]
    _assert_int8_cache(cache, jcache)
    nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)
    for pos in range(S, S + STEPS):
        jlogits, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt),
                                         jnp.asarray(pos, jnp.int32))
        tok = torch.from_numpy(nxt)
        logits, cache = m.decode_step(params, cache, tok, pos)
        fp_logits, fp_cache = m_fp.decode_step(params, fp_cache, tok, pos)
        _assert_int8_cache(cache, jcache)
        steps.append(("decode", logits, jlogits, fp_logits))
        nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)
    for kind, ours, ref, fp in steps:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=RTOL, err_msg=kind)
        bar = INT8_BARS[kind]
        np.testing.assert_allclose(ours.numpy(), fp.numpy(), atol=bar,
                                   rtol=bar, err_msg=f"{kind} vs fp cache")
        assert torch.equal(ours.argmax(-1), fp.argmax(-1)), kind


def test_int8_cache_memory_is_under_half():
    """int8 values and one f32 scale per (token, head): (1 + 4/hd) / 4 of
    the f32 cache, 0.28 at the reduced head_dim of 32."""
    cfg = get_config("gemma-7b").reduced()

    def nbytes(c):
        return sum(x.numel() * x.element_size() for _, kv in _subs(c)
                   for x in kv.values())

    fp = build_model(cfg).init_cache(4, 1024, device="cpu")
    q8 = build_model(cfg.with_(opt_int8_cache=True)).init_cache(
        4, 1024, device="cpu")
    assert nbytes(q8) < 0.5 * nbytes(fp)
    hd = cfg.head_dim
    kv_bytes = sum(kv[n].numel() * kv[n].element_size()
                   for _, kv in _subs(fp) for n in ("k", "v"))
    assert nbytes(q8) - nbytes(fp) == kv_bytes * ((1 + 4 / hd) / 4 - 1)


@pytest.mark.parametrize("arch", ["minitron-4b", "hymba-1.5b",
                                  "whisper-small"])
def test_pad_heads_preserves_loss(arch):
    """One card has no model axis: padding heads changes nothing, so the
    loss is the unpadded loss bit for bit, and the reference's padded
    loss (k and v repeated to q's width) within its own bar."""
    jm, jparams, m, params = _pair(arch, opt_pad_heads=True)
    m0 = build_model(m.cfg.with_(opt_pad_heads=False))
    rng = np.random.default_rng(3)
    batch = {"tokens": _tokens(m.cfg.vocab_size, (2, 17), seed=3)}
    if m.kind == "encdec":
        batch["frames"] = rng.standard_normal(
            (2, m.cfg.enc_seq, m.cfg.d_model)).astype(np.float32)
    jloss, _ = jm.train_loss_per_example(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, _ = m.train_loss_per_example(params, tb)
        loss0, _ = m0.train_loss_per_example(params, tb)
    assert torch.equal(loss, loss0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), atol=1e-3,
                               rtol=1e-4)
