"""whisper-small and pixtral-12b (S7) served and trained by the port
against the JAX reference, on the CPU.

Reduced configs (2 layers, d_model 256; whisper with 2 encoder layers
over 16 frames, pixtral with 8 patches), in f32, the reference's
parameters carried across by `repro_torch.models.convert`; frames and
patch embeddings drawn f32 from a seeded numpy generator.

* whisper: the encoder's output (non-causal, through K2's plain version
  here), and its dtype in a bf16 model fed f32 frames: f32, as the
  reference's (JAX promotes bf16 + f32, and the encoder then computes in
  f32); prefill and decode logits; every sublayer's self-attention cache
  and cross-attention K and V; the loss.
* pixtral: prefill and decode logits against the reference's prefill
  called at max_len = n_patches + S + new, so its cache does not wrap;
  `test_vlm_prefill_cache_wraps_in_the_reference` pins ROADMAP §3 F15;
  the loss.
* The engine decodes pixtral at the reference's positions; the launcher
  serves both; the converter carries every leaf (`encoder/` included).

Bars: f32 atol 1e-4 + rtol 1e-4 (as `test_torch_serve_s2.py`), `pos_ids`
exactly, the loss 1e-5 relative.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

ATOL = RTOL = 1e-4
B, S, STEPS = 2, 12, 3
ARCHS = ("whisper-small", "pixtral-12b")


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


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _batch(cfg, s, seed=1, batch=B):
    """Prompt ids and, as the model takes them, f32 frames or patches."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, s),
                                  dtype=np.int32)}
    if cfg.n_patches:
        out["patch_embed"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(ours, ref, what):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref,
                                                                np.float32),
                               atol=ATOL, rtol=RTOL, err_msg=what)


def _assert_cache(cache, jcache):
    for seg, subs in jcache.items():
        for sub, jc in subs.items():
            c = cache[seg][sub]
            assert sorted(c) == sorted(jc), (seg, sub)
            for name in ("xk", "xv"):
                if name in jc:
                    assert c[name].dtype == getattr(torch, str(
                        jc[name].dtype)), name
                    _close(c[name], jc[name], f"{seg}/{sub} {name}")
            for leaf in ("k", "v"):
                _close(c["kv"][leaf], jc["kv"][leaf], f"{seg}/{sub} {leaf}")
            np.testing.assert_array_equal(c["kv"]["pos_ids"].numpy(),
                                          np.asarray(jc["kv"]["pos_ids"]))


def test_encoder_matches_reference():
    jm, jparams, m, params = _pair("whisper-small")
    frames = _batch(m.cfg, 4)["frames"]
    ref = jax_encdec.encoder_forward(jparams["encoder"], jnp.asarray(frames),
                                     m.cfg)
    ours = encdec.encoder_forward(params["encoder"],
                                  torch.from_numpy(frames), m.cfg)
    _close(ours, ref, "encoder states")


def test_encoder_computes_in_f32_from_f32_frames():
    """A bf16 model fed f32 frames: `frames.astype(bf16) + pos` promotes
    to f32, so the encoder's states are f32 in both packages, within the
    f32 bar of each other against the same bf16 weights."""
    jm, jparams, m, params = _pair("whisper-small", dtype="bfloat16")
    frames = _batch(m.cfg, 4)["frames"]
    ref = jax_encdec.encoder_forward(jparams["encoder"], jnp.asarray(frames),
                                     m.cfg)
    ours = encdec.encoder_forward(params["encoder"],
                                  torch.from_numpy(frames), m.cfg)
    assert ref.dtype == jnp.float32 and ours.dtype == torch.float32
    _close(ours, ref, "encoder states")
    bf16 = encdec.encoder_forward(params["encoder"],
                                  torch.from_numpy(frames).bfloat16(), m.cfg)
    assert bf16.dtype == torch.bfloat16


def test_prefill_and_decode_match_reference(pair):
    """The reference's VLM prefill is sized at n_patches + S + new so its
    cache does not wrap (F15); the port sizes it so itself."""
    jm, jparams, m, params = pair
    cfg = m.cfg
    batch = _batch(cfg, S)
    jlogits, jcache = jm.prefill(jparams, _jax(batch),
                                 max_len=cfg.n_patches + S + STEPS)
    logits, cache = m.prefill(params, _torch(batch), S + STEPS)
    _close(logits, jlogits, "prefill logits")
    _assert_cache(cache, jcache)
    nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)
    p0 = S + cfg.n_patches
    for pos in range(p0, p0 + STEPS):
        jlogits, jcache = jm.decode_step(jparams, jcache, jnp.asarray(nxt),
                                         jnp.asarray(pos, jnp.int32))
        logits, cache = m.decode_step(params, cache, torch.from_numpy(nxt),
                                      pos)
        _close(logits, jlogits, f"decode logits at {pos}")
        _assert_cache(cache, jcache)
        nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)


def test_decode_after_a_prefill_equals_a_longer_prefill(pair):
    _, _, m, params = pair
    cfg = m.cfg
    batch = _torch(_batch(cfg, 10, seed=9))
    head = {**batch, "tokens": batch["tokens"][:, :9]}
    _, cache = m.prefill(params, head, 10)
    inc, _ = m.decode_step(params, cache, batch["tokens"][:, 9],
                           9 + cfg.n_patches)
    full, _ = m.prefill(params, batch, 10)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_vlm_prefill_cache_wraps_in_the_reference():
    """ROADMAP §3 F15: the reference sizes the VLM's cache at
    max(max_len, n_patches + S), so with max_len = S + 1 a prefill of 9
    tokens after 8 patches leaves no slot for the next token: its decode
    at position 17 overwrites patch 0's key, and prefill(9) + decode is
    ~0.9 off prefill(10) against a largest logit of ~2.6. The port sizes
    the cache at n_patches + max(max_len, S): its prefill(9) + decode
    equals prefill(10)."""
    jm, jparams, m, params = _pair("pixtral-12b")
    cfg = m.cfg
    batch = _batch(cfg, 10, seed=9)
    head = {**batch, "tokens": batch["tokens"][:, :9]}
    pos = 9 + cfg.n_patches
    _, jcache = jm.prefill(jparams, _jax(head), max_len=10)
    assert jcache["seg0"]["sub0"]["kv"]["pos_ids"].shape[-1] == pos
    jinc, _ = jm.decode_step(jparams, jcache,
                             jnp.asarray(batch["tokens"][:, 9]),
                             jnp.asarray(pos, jnp.int32))
    jfull, _ = jm.prefill(jparams, _jax(batch), max_len=10)
    gap = float(np.max(np.abs(np.asarray(jinc) - np.asarray(jfull))))
    largest = float(np.max(np.abs(np.asarray(jfull))))
    print(f"reference: decode off the longer prefill by {gap:.4f}, "
          f"largest logit {largest:.4f}")
    assert gap > 0.1 * largest  # the reference's fault shows
    tb = _torch(batch)
    _, cache = m.prefill(params, {**tb, "tokens": tb["tokens"][:, :9]}, 10)
    assert cache["seg0"]["sub0"]["kv"]["pos_ids"].shape[-1] == pos + 1
    inc, _ = m.decode_step(params, cache, tb["tokens"][:, 9], pos)
    full, _ = m.prefill(params, tb, 10)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=ATOL,
                               rtol=RTOL)


def test_loss_matches_reference(pair):
    jm, jparams, m, params = pair
    cfg = m.cfg
    batch = _batch(cfg, 17, seed=17, batch=4)
    jloss, _ = jm.train_loss_per_example(jparams, _jax(batch))
    loss, _ = m.train_loss_per_example(params, _torch(batch))
    jloss = np.asarray(jloss)
    rel = np.max(np.abs(loss.detach().numpy() - jloss) / np.abs(jloss))
    assert rel <= 1e-5, rel


def test_greedy_tokens_and_positions_match_reference(pair, monkeypatch):
    """`Engine.generate` in both packages: equal greedy tokens, and the
    decode steps at prompt + n_patches + i (the reference's positions).
    The reference's engine sizes its VLM cache as F15 does, so its
    pixtral tokens after the first are not compared."""
    jm, jparams, m, params = pair
    cfg = m.cfg
    batch = _batch(cfg, 14, seed=4)
    positions: dict = {"ref": [], "port": []}

    def recording(decode, key):
        def wrapped(p, cache, token, pos):
            positions[key].append(int(pos))
            return decode(p, cache, token, pos)
        return wrapped

    with jax_original_layout():
        jeng = JaxEngine(jm, jparams, JaxServeConfig(max_new_tokens=6))
        jeng._decode = recording(jeng._decode, "ref")
        jout = np.asarray(jeng.generate(_jax(batch)))
    monkeypatch.setattr(m, "decode_step", recording(m.decode_step, "port"))
    out = Engine(m, params, ServeConfig(max_new_tokens=6)).generate(
        _torch(batch))
    upto = 1 if cfg.n_patches else 6
    np.testing.assert_array_equal(out.numpy()[:, :upto], jout[:, :upto])
    p0 = 14 + cfg.n_patches
    assert positions["port"] == positions["ref"] == list(range(p0, p0 + 6))


def test_converter_carries_every_leaf(pair):
    jm, jparams, m, params = pair
    mine = m.init_params(device="cpu")
    paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    names = ["/".join(str(k.key) for k in path) for path, _ in paths]
    if m.kind == "encdec":
        assert any(n.startswith("encoder/blocks/") for n in names)
        assert "segments/seg0/sub0/xattn/wq" in names
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
