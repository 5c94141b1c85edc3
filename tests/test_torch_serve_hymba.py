"""hymba-1.5b (S6) served and trained by the port against the JAX
reference, on the CPU.

Reduced hymba-1.5b (2 layers, d_model 256, a window of 16, layer 0
global and layer 1 local, 8 meta tokens, an SSM state of 16), the
reference's parameters carried across by `repro_torch.models.convert`.

* `mamba_apply` at prefill over 300 positions (past the scan's 256-step
  chunk, ending ragged) and a decode step from its state: the output,
  the conv state and the SSM state.
* Prefill of 24 tokens (32 positions with the meta tokens, past the
  window), then decode steps: the logits and the whole cache (every
  layer's full-length KV cache, the conv and SSM states) after each.
* prefill(9) + decode against prefill(10), at the reference's own bar
  (5e-3, `tests/test_decode_consistency.py`) and at the f32 bar.
* Greedy tokens of `Engine.generate` equal to the reference `Engine`'s,
  decoding at the reference's positions (prompt + meta tokens + i).
* `train_loss_per_example` within 1e-5 relative; a bf16 run within a few
  bf16 ulps; the launcher; the converter.

Bars: f32 atol 1e-4 + rtol 1e-4 (as `test_torch_serve_s2.py`), the
cache's `pos_ids` exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import layer_slice  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

ATOL = RTOL = 1e-4
DECODE_BAR = 5e-3  # the reference's decode-vs-prefill bar
BF16_ULPS = 4 * 2.0**-8  # of the largest |value|
B, S = 2, 24
ARCH = "hymba-1.5b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(**extra):
    jcfg = jax_get_config(ARCH).reduced().with_(**extra)
    cfg = get_config(ARCH).reduced().with_(**extra)
    jm = jax_build_model(jcfg)
    with jax_original_layout():
        jparams = jm.init_params(jax.random.key(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(cfg), params


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _close(ours, ref, what, bf16=False):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref, np.float32)
    if bf16:
        bar = BF16_ULPS * float(np.max(np.abs(ref)))
        assert float(np.max(np.abs(ours - ref))) <= bar, what
    else:
        np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL,
                                   err_msg=what)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def _assert_cache(cache, jcache, bf16=False):
    ours, ref = _flat(cache), _flat(jcache)
    assert [n for n, _ in ours] == [n for n, _ in ref]
    for (name, x), (_, jx) in zip(ours, ref):
        assert tuple(x.shape) == jx.shape, name
        if name.endswith("pos_ids"):
            np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        else:
            _close(x, jx, name, bf16)


def test_layer_windows():
    cfg = get_config(ARCH)
    assert [ssm.layer_window(cfg, i) for i in (0, 1, 15, 30, 31)] == \
        [None, 1024, None, 1024, None]
    assert sum(ssm.layer_window(cfg, i) is None
               for i in range(cfg.n_layers)) == 3


def test_mamba_apply_matches_reference(pair):
    """300 positions: a full 256-step chunk and a ragged one of 44; then
    one decode step from the prefill's state."""
    jm, jparams, m, params = pair
    cfg = m.cfg
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"]["mamba"])
    p = layer_slice(params["blocks"]["mamba"], 0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 300, cfg.d_model)).astype(np.float32)
    jout, jstate = jax_ssm.mamba_apply(jnp.asarray(x), jp, cfg)
    out, state = ssm.mamba_apply(torch.from_numpy(x), p, cfg)
    _close(out, jout, "prefill out")
    _close(state["conv"], jstate["conv"], "prefill conv state")
    _close(state["ssm"], jstate["ssm"], "prefill ssm state")
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jout, jstate = jax_ssm.mamba_apply(jnp.asarray(x1), jp, cfg, jstate)
    out, state = ssm.mamba_apply(torch.from_numpy(x1), p, cfg, state)
    _close(out, jout, "decode out")
    _close(state["conv"], jstate["conv"], "decode conv state")
    _close(state["ssm"], jstate["ssm"], "decode ssm state")


def test_selective_scan_is_the_recurrence():
    """The chunked doubling scan against the recurrence stepped in order,
    at lengths under, at and past a chunk."""
    gen = torch.Generator().manual_seed(0)
    for s in (1, 7, 256, 300):
        a = torch.rand((2, s, 3, 4), generator=gen)
        bx = torch.randn((2, s, 3, 4), generator=gen)
        h0 = torch.randn((2, 3, 4), generator=gen)
        h_all, h_fin = ssm.selective_scan(a, bx, h0)
        h, ref = h0, []
        for t in range(s):
            h = a[:, t] * h + bx[:, t]
            ref.append(h)
        torch.testing.assert_close(h_all, torch.stack(ref, 1), atol=1e-5,
                                   rtol=1e-5)
        assert torch.equal(h_fin, h_all[:, -1])


def _serve_both(jm, jparams, m, params, prompt, steps, bf16=False):
    meta = m.cfg.meta_tokens
    s = prompt.shape[1]
    max_len = s + steps
    jlogits, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                 max_len=max_len)
    logits, cache = m.prefill(params, {"tokens": torch.from_numpy(prompt)},
                              max_len)
    _close(logits, jlogits, "prefill logits", bf16)
    _assert_cache(cache, jcache, bf16)
    nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)
    for pos in range(s + meta, s + meta + steps):
        jlogits, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt),
                                         jnp.asarray(pos, jnp.int32))
        logits, cache = m.decode_step(params, cache, torch.from_numpy(nxt),
                                      pos)
        _close(logits, jlogits, f"decode logits at {pos}", bf16)
        _assert_cache(cache, jcache, bf16)
        nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)
    return cache


def test_prefill_past_the_window_and_decode_match_reference(pair):
    jm, jparams, m, params = pair
    prompt = _tokens(m.cfg.vocab_size, (B, S))
    assert S + m.cfg.meta_tokens > m.cfg.sliding_window
    cache = _serve_both(jm, jparams, m, params, prompt, 3)
    meta = m.cfg.meta_tokens
    assert cache["kv"]["k"].shape[-2] == S + 3 + meta  # no ring
    assert cache["kv"]["pos_ids"][0, :S + meta + 3].tolist() == list(
        range(S + meta + 3))


def test_decode_after_a_prefill_equals_a_longer_prefill(pair):
    """prefill(9) + decode of token 9 at position 9 + meta against
    prefill(10): the reference's own bar, and the f32 bar."""
    jm, jparams, m, params = pair
    toks = _tokens(m.cfg.vocab_size, (B, 10), seed=9)
    t = torch.from_numpy(toks)
    _, cache = m.prefill(params, {"tokens": t[:, :9]}, 10)
    inc, _ = m.decode_step(params, cache, t[:, 9], 9 + m.cfg.meta_tokens)
    full, _ = m.prefill(params, {"tokens": t}, 10)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), atol=DECODE_BAR,
                               rtol=DECODE_BAR)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), atol=ATOL,
                               rtol=RTOL)


def _recording(decode, positions):
    def wrapped(params, cache, token, pos):
        positions.append(int(pos))
        return decode(params, cache, token, pos)
    return wrapped


def test_greedy_tokens_and_positions_match_reference(pair, monkeypatch):
    jm, jparams, m, params = pair
    toks = _tokens(m.cfg.vocab_size, (B, 14), seed=4)
    with jax_original_layout():
        jeng = JaxEngine(jm, jparams, JaxServeConfig(max_new_tokens=6))
        jpos: list = []
        jeng._decode = _recording(jeng._decode, jpos)
        jout = np.asarray(jeng.generate({"tokens": jnp.asarray(toks)}))
    pos: list = []
    monkeypatch.setattr(m, "decode_step", _recording(m.decode_step, pos))
    out = Engine(m, params, ServeConfig(max_new_tokens=6)).generate(
        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(out.numpy(), jout)
    assert pos == jpos == list(range(14 + m.cfg.meta_tokens,
                                     20 + m.cfg.meta_tokens))


def test_loss_matches_reference(pair):
    jm, jparams, m, params = pair
    tokens = _tokens(m.cfg.vocab_size, (4, 33), seed=17)
    jloss, _ = jm.train_loss_per_example(jparams,
                                         {"tokens": jnp.asarray(tokens)})
    loss, _ = m.train_loss_per_example(params,
                                       {"tokens": torch.from_numpy(tokens)})
    jloss = np.asarray(jloss)
    rel = np.max(np.abs(loss.detach().numpy() - jloss) / np.abs(jloss))
    assert rel <= 1e-5, rel


def test_loss_is_differentiable(pair):
    """Gradients reach every stacked leaf through K2's flash backward and
    the scan."""
    _, _, m, params = pair
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.from_numpy(_tokens(m.cfg.vocab_size, (2, 20), seed=2))
    losses, _ = m.train_loss_per_example(params, {"tokens": tokens})
    losses.mean().backward()
    for p in leaves:
        assert p.grad is not None and torch.isfinite(p.grad).all()
        p.requires_grad_(False)
        p.grad = None


def test_bf16_serving_within_ulps():
    """bf16 weights and activations: prefill past the window and decode,
    the logits and the cache within a few bf16 ulps of the reference's."""
    jm, jparams, m, params = _pair(dtype="bfloat16")
    prompt = _tokens(m.cfg.vocab_size, (B, S), seed=7)
    _serve_both(jm, jparams, m, params, prompt, 3, bf16=True)


def test_converter_carries_every_leaf(pair):
    """The port's own initialization has the reference's tree (the
    stacked blocks with their mamba branch, the meta tokens), and the
    converted tree is the reference's leaf for leaf."""
    jm, jparams, m, params = pair
    mine = m.init_params(device="cpu")
    paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    names = ["/".join(str(k.key) for k in path) for path, _ in paths]
    assert "meta" in names and "blocks/mamba/a_log" in names
    assert len(tree_leaves(mine)) == len(tree_leaves(params)) == len(paths)
    for name, (_, ref), ours, conv in zip(names, paths, tree_leaves(mine),
                                          tree_leaves(params)):
        assert tuple(ours.shape) == ref.shape == tuple(conv.shape), name
        assert str(ours.dtype).split(".")[-1] == str(ref.dtype), name
        np.testing.assert_array_equal(conv.numpy(), np.asarray(ref))
    # A's initialization is deterministic: log(1..N) in every row
    np.testing.assert_allclose(mine["blocks"]["mamba"]["a_log"].numpy(),
                               np.asarray(jparams["blocks"]["mamba"]
                                          ["a_log"]), rtol=1e-7, atol=0)


def test_launcher_serves_the_arch(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                "--prompt-len", "20", "--new-tokens", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"arch={ARCH} generated (2, 2)"), line
