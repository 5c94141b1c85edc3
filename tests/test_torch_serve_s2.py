"""The window, softcap and qk-norm families (S2) served and trained by the
port against the JAX reference, on the CPU.

Reduced gemma2-9b (local and global layers alternating over a window of
16, attention and final softcaps, sandwich norms, the embedding scale),
gemma-7b (the embedding scale, head_dim 32 after `reduced()`),
minitron-4b (squared ReLU without GLU, GQA) and gemma-7b with qk-norm;
each `reduced()` (2 layers, d_model 256), the reference's parameters
carried across by `repro_torch.models.convert`. On the CPU the port's
prefill attention is the kernel's plain version and the reference's its
blockwise jnp path.

* Prefill at 24 tokens, longer than the window, so local and global
  layers differ; the whole cache (each sublayer's k, v and pos_ids, the
  local ones a 16-slot ring buffer with position p in slot p mod 16,
  held to the reference's cache moved into that layout, since the
  reference's prefill keeps them in order: ROADMAP §3 F14); then decode
  steps, each reading the ring the step before wrote.
* prefill(s) + decode against prefill(s + 1), within, past and two
  windows past the window.
* A 12-token prompt decoded past position 16, so the window starts to
  mask the oldest keys in decode.
* A cache exactly as long as the prompt, so the next decode wraps the
  global layers' buffer too.
* Greedy tokens of `Engine.generate`; the loss and its gradients through
  `train_loss_per_example` (reduced gemma2-9b, 32 positions, so the
  window bites in training as well).

Bars: f32 as `test_torch_serve.py` (atol 1e-4 + rtol 1e-4; measured
~1e-6), the cache's `pos_ids` exactly; bf16 logits within 4 bf16 ulps of
the largest logit (2^-6 of it), the loss 1e-5 relative and each gradient
within 1e-4 of its leaf's largest magnitude, as
`test_torch_train_models.py`.
"""
import dataclasses

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
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

ATOL = RTOL = 1e-4
BF16_ULPS = 4 * 2.0**-8  # of the largest |logit|
LOSS_RTOL, GRAD_BAR = 1e-5, 1e-4
B, S = 2, 24
WINDOW = 16  # `reduced()` caps gemma2-9b's 4096 at 16
MODELS = {"gemma2-9b": ("gemma2-9b", {}), "gemma-7b": ("gemma-7b", {}),
          "minitron-4b": ("minitron-4b", {}),
          "gemma-7b-qk-norm": ("gemma-7b", {"qk_norm": True})}


def _pair(name, **extra):
    arch, overrides = MODELS[name]
    overrides = {**overrides, **extra}
    jcfg = jax_get_config(arch).reduced().with_(**overrides)
    cfg = get_config(arch).reduced().with_(**overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = jax_build_model(jcfg)
    with jax_original_layout():
        jparams = jm.init_params(jax.random.key(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(cfg), params


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    return _pair(request.param)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _subs(cache):
    """(name, kv cache) of each sublayer, in the tree's order."""
    return [(f"{seg}/{sub}", c["kv"]) for seg, subs in cache.items()
            for sub, c in subs.items()]


def _assert_close(ours, ref, bf16: bool, what: str):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref, np.float32)
    if bf16:
        bar = BF16_ULPS * float(np.max(np.abs(ref)))
        assert float(np.max(np.abs(ours - ref))) <= bar, what
    else:
        np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL,
                                   err_msg=what)


def _assert_cache(cache, jcache, bf16=False):
    ours, ref = _subs(cache), _subs(jcache)
    assert [n for n, _ in ours] == [n for n, _ in ref]
    for (name, kv), (_, jkv) in zip(ours, ref):
        for leaf in ("k", "v"):
            assert tuple(kv[leaf].shape) == jkv[leaf].shape, name
            _assert_close(kv[leaf], jkv[leaf], bf16, f"{name} {leaf}")
        np.testing.assert_array_equal(kv["pos_ids"].numpy(),
                                      np.asarray(jkv["pos_ids"]))


def _ring_aligned(jcache, s: int):
    """The reference's cache after a prefill of `s` positions with each
    kept position p moved to slot p mod cache_len, where its decode step
    reads and writes the ring, as the port's prefill places it. The
    reference keeps them in slots 0.. in order, which differs when s
    exceeds a windowed buffer and is not a multiple of it (ROADMAP §3
    F14)."""
    def align(kv):
        n = kv["pos_ids"].shape[-1]
        shift = (s - min(s, n)) % n
        return {**kv, "k": jnp.roll(kv["k"], shift, axis=-2),
                "v": jnp.roll(kv["v"], shift, axis=-2),
                "pos_ids": jnp.roll(kv["pos_ids"], shift, axis=-1)}

    return {seg: {sub: {**c, "kv": align(c["kv"])}
                  for sub, c in subs.items()}
            for seg, subs in jcache.items()}


def _serve_both(jm, jparams, m, params, prompt, max_len, steps, bf16=False):
    """Prefill `prompt` and decode `steps` greedy tokens in both, holding
    logits and the whole cache after each call; the reference decodes
    from its prefill's cache in the ring's layout (`_ring_aligned`)."""
    jlogits, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                 max_len=max_len)
    jcache = _ring_aligned(jcache, prompt.shape[1])
    logits, cache = m.prefill(params, {"tokens": torch.from_numpy(prompt)},
                              max_len)
    _assert_close(logits, jlogits, bf16, "prefill logits")
    _assert_cache(cache, jcache, bf16)
    nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)
    s = prompt.shape[1]
    for pos in range(s, s + steps):
        jlogits, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt),
                                         jnp.asarray(pos, jnp.int32))
        logits, cache = m.decode_step(params, cache, torch.from_numpy(nxt),
                                      pos)
        _assert_close(logits, jlogits, bf16, f"decode logits at {pos}")
        _assert_cache(cache, jcache, bf16)
        nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)
    return cache


def test_prefill_past_the_window_and_decode_match_reference(pair):
    jm, jparams, m, params = pair
    prompt = _tokens(m.cfg.vocab_size, (B, S))
    cache = _serve_both(jm, jparams, m, params, prompt, S + 4, 4)
    lens = {tuple(kv["k"].shape)[-2] for _, kv in _subs(cache)}
    if m.cfg.sliding_window:  # a 16-slot ring beside the global cache
        assert lens == {WINDOW, S + 4}
    else:
        assert lens == {S + 4}


def test_decode_crosses_the_window_as_the_reference(pair):
    """A 12-token prompt decoded to position 21: from position 16 on the
    local layers' ring overwrites its oldest keys and the window masks
    them."""
    jm, jparams, m, params = pair
    prompt = _tokens(m.cfg.vocab_size, (B, 12), seed=5)
    _serve_both(jm, jparams, m, params, prompt, 22, 10)


def test_decode_wraps_a_full_cache_as_the_reference(pair):
    """A cache as long as the prompt: the next decodes overwrite the
    oldest slots of every layer's buffer, global ones included."""
    jm, jparams, m, params = pair
    prompt = _tokens(m.cfg.vocab_size, (B, S), seed=6)
    cache = _serve_both(jm, jparams, m, params, prompt, S, 2)
    for _, kv in _subs(cache):
        assert kv["pos_ids"].shape[-1] <= S
        assert bool((kv["pos_ids"] == S + 1).any(dim=-1).all())


def test_prefill_past_an_unaligned_window_misplaces_the_ring():
    """ROADMAP §3 F14, in the reference and repaired in the port: a
    prefill of S > window positions with S mod window != 0. The
    reference writes its last `window` keys into slots 0.. (position
    S - window in slot 0), where its decode expects position p in slot
    p mod window, so its next decode overwrites a live key and
    prefill(S) + decode differs from prefill(S + 1). The port places
    each key in its ring slot: its prefill(S) + decode equals its
    prefill(S + 1) and the reference's decode from the aligned cache."""
    jm, jparams, m, params = _pair("gemma2-9b")
    toks = _tokens(m.cfg.vocab_size, (B, S + 1), seed=8)
    _, cache = m.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])},
                         S + 1)
    local = cache["seg0"]["sub0"]["kv"]["pos_ids"][0]
    assert [p % WINDOW for p in local.tolist()] == list(range(WINDOW))
    assert sorted(local.tolist()) == list(range(S - WINDOW, S))
    inc, _ = m.decode_step(params, cache, torch.from_numpy(toks[:, S]), S)
    full, _ = m.prefill(params, {"tokens": torch.from_numpy(toks)}, S + 1)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), atol=ATOL,
                               rtol=RTOL)
    _, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                           max_len=S + 1)
    jlocal = np.asarray(jcache["seg0"]["sub0"]["kv"]["pos_ids"][0])
    assert jlocal.tolist() == list(range(S - WINDOW, S))  # not p mod 16
    jtok, jpos = jnp.asarray(toks[:, S]), jnp.asarray(S, jnp.int32)
    jinc, _ = jm.decode_step(jparams, jcache, jtok, jpos)
    gap = float(np.max(np.abs(np.asarray(jinc) - full.numpy()))
                / np.max(np.abs(full.numpy())))
    assert gap > 1e-2, gap  # the reference's fault shows
    jaligned, _ = jm.decode_step(jparams, _ring_aligned(jcache, S), jtok,
                                 jpos)
    np.testing.assert_allclose(inc.numpy(), np.asarray(jaligned), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("s", [20, 24, 33])
def test_decode_after_a_prefill_equals_a_longer_prefill(pair, s):
    """prefill(s) + decode of the token at s gives prefill(s + 1)'s
    logits, whether s is within the window, past it unaligned, or past
    two windows: every layer's ring holds the keys its decode reads."""
    _, _, m, params = pair
    toks = torch.from_numpy(_tokens(m.cfg.vocab_size, (B, s + 1), seed=9))
    _, cache = m.prefill(params, {"tokens": toks[:, :s]}, s + 1)
    inc, _ = m.decode_step(params, cache, toks[:, s], s)
    full, _ = m.prefill(params, {"tokens": toks}, s + 1)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_greedy_tokens_match_reference(pair):
    jm, jparams, m, params = pair
    toks = _tokens(m.cfg.vocab_size, (B, 14), seed=4)
    with jax_original_layout():
        jout = np.asarray(JaxEngine(jm, jparams, JaxServeConfig(
            max_new_tokens=6)).generate({"tokens": jnp.asarray(toks)}))
    out = Engine(m, params, ServeConfig(max_new_tokens=6)).generate(
        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(out.numpy(), jout)


def test_converter_carries_every_leaf(pair):
    """The port's own initialization has the reference's tree: the same
    paths, shapes and dtypes (sub1, the post norms, the qk-norm scales),
    and the converted tree is the reference's leaf for leaf."""
    jm, jparams, m, params = pair
    mine = m.init_params(device="cpu")
    paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    names = ["/".join(str(k.key) for k in path) for path, _ in paths]
    assert len(tree_leaves(mine)) == len(tree_leaves(params)) == len(paths)
    for name, (_, ref), ours, conv in zip(names, paths, tree_leaves(mine),
                                          tree_leaves(params)):
        assert tuple(ours.shape) == ref.shape == tuple(conv.shape), name
        assert str(ours.dtype).split(".")[-1] == str(ref.dtype), name
        np.testing.assert_array_equal(conv.numpy(), np.asarray(ref))
    cfg = m.cfg
    if cfg.norm_style == "sandwich":
        assert {"post_ln1", "post_ln2"} <= set(
            mine["segments"]["seg0"]["sub1"])
        assert not mine["segments"]["seg0"]["sub0"]["post_ln1"].any()
    if cfg.qk_norm:
        assert mine["segments"]["seg0"]["sub0"]["attn"]["q_norm"].eq(1).all()


@pytest.mark.parametrize("name", ["gemma2-9b", "minitron-4b"])
def test_bf16_serving_within_ulps(name):
    """bf16 weights and activations: prefill past the window and decode,
    the logits and the cache within a few bf16 ulps of the reference's."""
    jm, jparams, m, params = _pair(name, dtype="bfloat16")
    prompt = _tokens(m.cfg.vocab_size, (B, S), seed=7)
    _serve_both(jm, jparams, m, params, prompt, S + 3, 3, bf16=True)


def test_embedding_scale_rounds_to_the_activation_dtype():
    """sqrt(3584) = 59.87 is 59.75 in bf16, and the product rounds once:
    the scaled embedding equals the reference's bit for bit."""
    cfg = get_config("gemma2-9b").with_(vocab_size=8)
    emb = torch.randn((8, cfg.d_model), dtype=torch.float32).to(
        torch.bfloat16)
    tokens = torch.arange(8)[None]
    ours = tfm.embed_tokens({"embed": emb}, tokens, cfg)
    from repro.models.transformer import embed_tokens as jax_embed

    ref = jax_embed({"embed": jnp.asarray(emb.float().numpy(),
                                          jnp.bfloat16)},
                    jnp.asarray(tokens.numpy()), cfg)
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(ref, np.float32))
    assert float(torch.tensor(59.866, dtype=torch.bfloat16)) == 59.75


def test_loss_and_gradients_match_reference():
    """Reduced gemma2-9b's per-example losses and the gradients of their
    mean: both softcaps, the window over 32 positions, sandwich norms and
    the embedding scale under autograd (the flash backward)."""
    jm, jparams, m, params = _pair("gemma2-9b")
    tokens = _tokens(m.cfg.vocab_size, (4, 33), seed=17)

    def mean_loss(p):
        losses, _ = jm.train_loss_per_example(
            p, {"tokens": jnp.asarray(tokens)})
        return jnp.mean(losses), losses

    (_, ref_losses), ref_grads = jax.value_and_grad(
        mean_loss, has_aux=True)(jparams)
    ref_grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(ref_grads)]
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    losses, _ = m.train_loss_per_example(
        params, {"tokens": torch.from_numpy(tokens)})
    torch.mean(losses).backward()
    ref_losses = np.asarray(ref_losses)
    loss_rel = float(np.max(np.abs(losses.detach().numpy() - ref_losses)
                            / np.abs(ref_losses)))
    assert loss_rel <= LOSS_RTOL
    assert len(leaves) == len(ref_grads)
    worst = 0.0
    for p, g in zip(leaves, ref_grads):
        assert p.grad is not None and p.grad.shape == g.shape
        scale = max(float(np.max(np.abs(g))), 1e-30)
        worst = max(worst, float(np.max(np.abs(p.grad.numpy() - g))) / scale)
    print(f"gemma2-9b: losses {loss_rel:.3e} rel, gradients within "
          f"{worst:.3e} of each leaf's largest (bar {GRAD_BAR})")
    assert worst <= GRAD_BAR


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma-7b", "minitron-4b"])
def test_launcher_serves_the_arch(arch, capsys):
    serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                "--prompt-len", "20", "--new-tokens", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"arch={arch} generated (2, 2)"), line
