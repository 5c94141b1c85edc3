"""llama4-maverick-400b-a17b (S4: MoE) and deepseek-v3-671b (S5: MoE with
MLA and an MTP head) served and trained by the port against the JAX
reference, on the CPU.

Reduced configs (2 layers, d_model 256, 4 experts): maverick one (local
dense over a window of 16, global MoE top-1 with a shared expert) pair;
deepseek-v3 one dense and one MoE (top-2 sigmoid with a non-zero router
bias, a shared expert) layer, both through MLA; f32, the reference's
parameters carried across by `repro_torch.models.convert`.

* Prefill of 24 tokens (past maverick's window of 16 and not a multiple
  of it), then greedy decode steps: logits and the whole cache after
  each. The reference places a windowed ring's keys where its decode does
  not read them (ROADMAP §3 F14); its prefill cache is rolled into the
  ring's layout before comparing and decoding, as in
  `test_torch_serve_s2.py`. Capacity drops tokens in these prefills (the
  configs' own capacity factors: 14 of 48 token-slots for maverick, 25
  of 96 for deepseek-v3) in both packages alike.
* prefill(9) + decode against prefill(10), dropless (capacity factor
  100, as the reference's `tests/test_decode_consistency.py`: a grouped
  prefill and a one-token decode drop differently by design), at the
  reference's bars (2e-2 for deepseek's absorbed decode, 5e-3 otherwise,
  rtol 1e-2) and, for maverick, past the window.
* `train_loss_per_example` (the router's aux loss times its weight, and
  deepseek's MTP loss times 0.3, included) and its `aux_loss` within
  1e-5 relative; gradients reach the routers, the experts and the MTP
  head.
* Greedy tokens of `Engine.generate` equal to the reference engine's;
  `opt_int8_cache` with MoE builds and serves (maverick against the
  reference's int8 cache); `opt_shardmap_moe` changes no bit; the
  launcher; the converter (every leaf, `mtp` included).

Bars: f32 atol 1e-4 + rtol 1e-4 (as `test_torch_serve_s2.py`), `pos_ids`
exactly.
"""
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
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

ATOL = RTOL = 1e-4
ARCHS = ("llama4-maverick-400b-a17b", "deepseek-v3-671b")
# the reference's decode-vs-prefill bars (tests/test_decode_consistency.py)
DECODE_BARS = {"llama4-maverick-400b-a17b": 5e-3, "deepseek-v3-671b": 2e-2}
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
    if jcfg.router_scoring == "sigmoid":
        # deepseek's bias starts at 0; a non-zero one moves the choice
        moe_p = jparams["segments"]["seg1"]["sub0"]["moe"]
        rs = np.random.default_rng(5)
        moe_p["router_bias"] = jnp.asarray(
            0.05 * rs.standard_normal(moe_p["router_bias"].shape),
            jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(cfg), params


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _tokens(cfg, s, seed=1, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, s), dtype=np.int32)


def _close(ours, ref, what):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _ring_aligned(jcache, s: int):
    """The reference's cache after a prefill of `s` positions with each
    kept key of a windowed ring moved to slot p mod its length, where
    decode reads it and the port's prefill places it (F14). MLA's latent
    caches are as long as the prompt and need no move."""
    def align(kv):
        if "k" not in kv:
            return kv
        n = kv["pos_ids"].shape[-1]
        shift = (s - min(s, n)) % n
        return {**kv, "k": jnp.roll(kv["k"], shift, axis=-2),
                "v": jnp.roll(kv["v"], shift, axis=-2),
                "pos_ids": jnp.roll(kv["pos_ids"], shift, axis=-1)}

    return {seg: {sub: {**c, "kv": align(c["kv"])}
                  for sub, c in subs.items()}
            for seg, subs in jcache.items()}


def _assert_cache(cache, jcache):
    for seg, subs in jcache.items():
        for sub, jc in subs.items():
            kv, jkv = cache[seg][sub]["kv"], jc["kv"]
            assert sorted(kv) == sorted(jkv), (seg, sub)
            for name in jkv:
                if name == "pos_ids":
                    np.testing.assert_array_equal(kv[name].numpy(),
                                                  np.asarray(jkv[name]))
                elif kv[name].dtype == torch.int8:
                    # an int8 value within an f32 rounding of a half step
                    # may differ by 1 (test_torch_int8_cache.py)
                    diff = np.abs(kv[name].numpy().astype(np.int32)
                                  - np.asarray(jkv[name], np.int32))
                    assert diff.max() <= 1, (seg, sub, name)
                else:
                    _close(kv[name], jkv[name], f"{seg}/{sub} {name}")


def _serve_both(jm, jparams, m, params, prompt, steps=STEPS):
    s = prompt.shape[1]
    max_len = s + steps
    jlogits, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                 max_len=max_len)
    jcache = _ring_aligned(jcache, s)
    logits, cache = m.prefill(params, {"tokens": torch.from_numpy(prompt)},
                              max_len)
    _close(logits, jlogits, "prefill logits")
    _assert_cache(cache, jcache)
    nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)
    for pos in range(s, s + steps):
        jlogits, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt),
                                         jnp.asarray(pos, jnp.int32))
        logits, cache = m.decode_step(params, cache, torch.from_numpy(nxt),
                                      pos)
        _close(logits, jlogits, f"decode logits at {pos}")
        _assert_cache(cache, jcache)
        nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)


def test_arch_ids_resolve():
    for arch in ARCHS:
        cfg = get_config(arch)
        assert cfg.arch_id == arch and cfg.n_experts
        assert build_model(cfg).kind == "transformer"
    assert get_config("deepseek-v3-671b").use_mla


def test_prefill_and_decode_match_reference(pair):
    jm, jparams, m, params = pair
    _serve_both(jm, jparams, m, params, _tokens(m.cfg, S))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_a_prefill_equals_a_longer_prefill(arch):
    """Dropless, at the reference's own bars; maverick also past its
    window (a prompt of 20 against 21, the ring's keys where prefill
    placed them)."""
    _, _, m, params = _pair(arch, capacity_factor=100.0)
    bar = DECODE_BARS[arch]
    lengths = (9, 20) if m.cfg.sliding_window else (9,)
    for s in lengths:
        toks = torch.from_numpy(_tokens(m.cfg, s + 1, seed=9))
        _, cache = m.prefill(params, {"tokens": toks[:, :s]}, s + 3)
        inc, _ = m.decode_step(params, cache, toks[:, s], s)
        full, _ = m.prefill(params, {"tokens": toks}, s + 3)
        np.testing.assert_allclose(inc.numpy(), full.numpy(), atol=bar,
                                   rtol=1e-2)


def test_loss_and_aux_match_reference(pair):
    jm, jparams, m, params = pair
    batch = _tokens(m.cfg, 17, seed=17, batch=4)
    jloss, jmetrics = jm.train_loss_per_example(
        jparams, {"tokens": jnp.asarray(batch)})
    loss, metrics = m.train_loss_per_example(
        params, {"tokens": torch.from_numpy(batch)})
    jloss = np.asarray(jloss)
    rel = np.max(np.abs(loss.detach().numpy() - jloss) / np.abs(jloss))
    assert rel <= 1e-5, rel
    aux, jaux = metrics["aux_loss"].item(), float(jmetrics["aux_loss"])
    assert jaux > 0 and abs(aux - jaux) <= 1e-5 * jaux
    assert abs(metrics["loss"].item() - float(jmetrics["loss"])) \
        <= 1e-5 * float(jmetrics["loss"])


def test_gradients_reach_routers_experts_and_the_mtp_head(pair):
    _, _, m, params = pair
    moe_seg = params["segments"]["seg1" if m.cfg.first_dense_layers
                                 else "seg0"]
    moe_p = moe_seg["sub0" if m.cfg.first_dense_layers else "sub1"]["moe"]
    leaves = [moe_p["router"], moe_p["experts_wi"], moe_p["shared_wo"]]
    if m.cfg.mtp:
        leaves += [params["mtp"]["proj"],
                   params["mtp"]["block"]["attn"]["kv_b_k"]]
    for t in leaves:
        t.requires_grad_(True)
    try:
        losses, _ = m.train_loss_per_example(
            params, {"tokens": torch.from_numpy(_tokens(m.cfg, 9))})
        losses.sum().backward()
        for t in leaves:
            assert t.grad is not None and t.grad.abs().max() > 0
    finally:
        for t in leaves:
            t.requires_grad_(False)
            t.grad = None


def test_greedy_tokens_match_reference(pair):
    jm, jparams, m, params = pair
    prompt = _tokens(m.cfg, 14, seed=4)
    with jax_original_layout():
        jout = np.asarray(JaxEngine(jm, jparams, JaxServeConfig(
            max_new_tokens=5)).generate({"tokens": jnp.asarray(prompt)}))
    out = Engine(m, params, ServeConfig(max_new_tokens=5)).generate(
        {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_array_equal(out.numpy(), jout)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_with_moe_builds_and_serves(arch):
    """maverick's int8 KV cache against the reference's; deepseek's MLA
    cache keeps the model's dtype under `opt_int8_cache` (the reference's
    `init_mla_cache` reads no such flag), so it serves as without it."""
    jm, jparams, m, params = _pair(arch, opt_int8_cache=True)
    prompt = _tokens(m.cfg, 12, seed=6)
    if m.cfg.use_mla:
        plain = build_model(m.cfg.with_(opt_int8_cache=False))
        logits, cache = m.prefill(params, {"tokens": torch.from_numpy(
            prompt)}, 14)
        ref, _ = plain.prefill(params, {"tokens": torch.from_numpy(prompt)},
                               14)
        assert cache["seg0"]["sub0"]["kv"]["c"].dtype == torch.float32
        assert torch.equal(logits, ref)
        return
    assert m.init_cache(1, 4)["seg0"]["sub0"]["kv"]["k"].dtype == torch.int8
    _serve_both(jm, jparams, m, params, prompt, steps=2)


def test_shardmap_moe_changes_no_bit(pair):
    _, _, m, params = pair
    sm = build_model(m.cfg.with_(opt_shardmap_moe=True))
    toks = torch.from_numpy(_tokens(m.cfg, 10, seed=8))
    la, ca = m.prefill(params, {"tokens": toks}, 11)
    lb, cb = sm.prefill(params, {"tokens": toks}, 11)
    assert torch.equal(la, lb)
    la, _ = m.decode_step(params, ca, toks[:, 0], 10)
    lb, _ = sm.decode_step(params, cb, toks[:, 0], 10)
    assert torch.equal(la, lb)


def test_converter_carries_every_leaf(pair):
    jm, jparams, m, params = pair
    mine = m.init_params(device="cpu")
    paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    names = ["/".join(str(k.key) for k in path) for path, _ in paths]
    if m.cfg.mtp:
        assert "mtp/block/attn/kv_b_v" in names
    assert len(tree_leaves(mine)) == len(tree_leaves(params)) == len(paths)
    for name, (_, ref), ours, conv in zip(names, paths, tree_leaves(mine),
                                          tree_leaves(params)):
        assert tuple(ours.shape) == ref.shape == tuple(conv.shape), name
        assert str(ours.dtype).split(".")[-1] == str(ref.dtype), name
        np.testing.assert_array_equal(conv.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_arch(arch, capsys):
    serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                "--prompt-len", "20", "--new-tokens", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"arch={arch} generated (2, 2)"), line
