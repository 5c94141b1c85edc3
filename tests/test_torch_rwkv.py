"""The port's RWKV6 serving path against the JAX reference, on the CPU.

Reduced rwkv6-7b (2 layers, d_model 256, 4 WKV heads of 64, d_ff 512,
vocab 512, f32; `reduced()` of the config), with the reference's
parameters carried across by `repro_torch.models.convert`. On the CPU the
port's WKV recurrence is the kernel's plain version and the reference's
is its chunked scan.

Bars: prefill and decode logits, and the whole state (`tm_shift`,
`cm_shift`, `wkv`) after prefill and after each of 3 decode steps, within
atol 1e-4 and rtol 1e-4 (f32 sums taken in another order); every
generated token exactly — greedy, and at temperature 0.8 with the same
seed through the port's threefry (the reference computed in the original
threefry layout, ROADMAP §3 R1).

The served dtype is bf16, so the same comparison runs on the bf16 model
too, within BF16_ULPS units in the last place of each tensor's largest
magnitude. The two sides round the same model-dtype values, but not
always the same way: JAX on the CPU computes its bf16 sigmoid (inside
the SiLU gate and channel-mix's receptance) otherwise than PyTorch,
which takes it in f32 and rounds once, so 30-40 % of those outputs
differ by one ulp; and XLA's CPU compiler keeps some fused bf16
intermediates in f32. The residual stream carries such flips on (up to
2 ulps after 2 layers). With those roundings made alike, the bf16
model is held within 1 ulp (0.1 ulp on average), which a cast put
anywhere the reference has none does not pass.
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
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.wkv import ops as wkv_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

ARCH = "rwkv6-7b"
ATOL = RTOL = 1e-4
BF16_ULPS = 4
OP_FOR_OP_MEAN_ULPS = 0.1
B, S = 2, 10
STATE_KEYS = ("tm_shift", "cm_shift", "wkv")


def _pair(dtype):
    jcfg = jax_get_config(ARCH).reduced().with_(dtype=dtype)
    cfg = get_config(ARCH).reduced().with_(dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = jax_build_model(jcfg)
    jparams = jm.init_params(jax.random.key(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(cfg), params


@pytest.fixture(scope="module")
def pair():
    return _pair("float32")


@pytest.fixture(scope="module")
def pair_bf16():
    return _pair("bfloat16")


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _bf16_ulp(want):
    """One bf16 ulp at the largest magnitude of `want`: 2^(e - 7) for
    2^e <= max|want| < 2^(e + 1)."""
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def _close_f32(got, want, name):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=name)


def _close_bf16(got, want, name):
    np.testing.assert_allclose(got, want, atol=BF16_ULPS * _bf16_ulp(want),
                               rtol=0, err_msg=name)


def _close_op_for_op(got, want, name):
    err = np.abs(got - want) / _bf16_ulp(want)
    assert err.max() <= 1.0 and err.mean() <= OP_FOR_OP_MEAN_ULPS, (
        f"{name}: max {err.max():.3f} ulp, mean {err.mean():.4f} ulp")


def _assert_close(got, want, name, close):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    close(got, want, name)


def _assert_state(state, jstate, close, dtype=torch.float32):
    assert set(state) == set(jstate) == set(STATE_KEYS)
    for name in STATE_KEYS:
        assert state[name].dtype == (
            torch.float32 if name == "wkv" else dtype), name
        _assert_close(state[name], jstate[name], name, close)


def test_reduced_config_is_the_references():
    cfg = get_config(ARCH).reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.dtype) == (
        2, 256, 4, "float32")
    assert cfg.d_model // cfg.n_heads == 64  # the WKV head size
    assert build_model(cfg).kind == "rwkv"


def test_prefill_and_decode_match_reference(pair):
    """Prefill, then 3 decode steps: logits and the whole state after
    each, the state updated in place (the same tensors throughout)."""
    _check_prefill_and_decode(pair, _close_f32)


def test_bf16_prefill_and_decode_match_reference(pair_bf16):
    """The same in the served dtype, within BF16_ULPS."""
    _check_prefill_and_decode(pair_bf16, _close_bf16)


def test_bf16_rounds_as_the_reference_op_for_op(pair_bf16, monkeypatch):
    """The same in bf16 with the reference's two CPU-only roundings made
    the port's: its sigmoid rounded once from f32, and its prefill and
    decode step each compiled whole with XLA's excess precision off (by
    default the CPU compiler keeps fused bf16 intermediates in f32). Then
    every tensor is within 1 ulp, by OP_FOR_OP_MEAN_ULPS on average: a
    cast anywhere the reference has none (or none where it has one) —
    around the decay, the head norm, the gate, the squared ReLU — moves
    the mean to 0.25 ulp or more."""
    jm = pair_bf16[0]
    for name in ("sigmoid", "silu"):
        fn = getattr(jax.nn, name)
        monkeypatch.setattr(jax.nn, name, lambda x, fn=fn: fn(
            x.astype(jnp.float32)).astype(x.dtype))
    opts = {"xla_allow_excess_precision": False}

    def compiled(fn):
        cache = {}

        def call(*args):
            if not cache:
                cache["fn"] = jax.jit(fn).lower(*args).compile(
                    compiler_options=opts)
            return cache["fn"](*args)
        return call

    _check_prefill_and_decode(
        pair_bf16, _close_op_for_op,
        jprefill=compiled(lambda p, t: jm.prefill(p, {"tokens": t},
                                                  max_len=S + 3)),
        jdecode=compiled(jm.decode_step))


def _check_prefill_and_decode(pair, close, jprefill=None, jdecode=None):
    jm, jparams, m, params = pair
    jprefill = jprefill or (lambda p, t: jm.prefill(p, {"tokens": t},
                                                    max_len=S + 3))
    jdecode = jdecode or jm.decode_step
    dtype = getattr(torch, m.cfg.dtype)
    toks = _tokens(m.cfg.vocab_size, (B, S))
    jlogits, jstate = jprefill(jparams, jnp.asarray(toks))
    logits, state = m.prefill(params, {"tokens": torch.from_numpy(toks)},
                              S + 3)
    _assert_close(logits, jlogits, "prefill logits", close)
    _assert_state(state, jstate, close, dtype)
    tensors = {k: state[k] for k in STATE_KEYS}
    nxt = _tokens(m.cfg.vocab_size, (B,), seed=2)
    for pos in range(S, S + 3):
        jlogits, jstate = jdecode(jparams, jstate, jnp.asarray(nxt),
                                  jnp.asarray(pos, jnp.int32))
        logits, out = m.decode_step(params, state, torch.from_numpy(nxt),
                                    pos)
        assert out is state
        assert all(state[k] is tensors[k] for k in STATE_KEYS)
        _assert_close(logits, jlogits, f"decode logits at {pos}", close)
        _assert_state(state, jstate, close, dtype)
        nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)


def test_decode_continues_prefill(pair):
    """prefill(S) + one decode step gives prefill(S + 1)'s last logits
    (the port alone, as tests/test_decode_consistency.py holds the
    reference)."""
    _, _, m, params = pair
    toks = torch.from_numpy(_tokens(m.cfg.vocab_size, (B, S)))
    ref, ref_state = m.prefill(params, {"tokens": toks})
    _, state = m.prefill(params, {"tokens": toks[:, :-1]})
    inc, state = m.decode_step(params, state, toks[:, -1], S - 1)
    np.testing.assert_allclose(inc.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)
    for name in STATE_KEYS:
        np.testing.assert_allclose(state[name].numpy(),
                                   ref_state[name].numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


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


def test_wkv_routes_agree_on_the_cpu(pair):
    """`impl='ref'` and 'auto' are the same plain version on CPU
    tensors, and neither launches the kernel."""
    _, _, m, params = pair
    plain = build_model(m.cfg, impl="ref")
    toks = torch.from_numpy(_tokens(m.cfg.vocab_size, (B, S), seed=5))
    before = wkv_ops.launch_count
    a, _ = m.prefill(params, {"tokens": toks})
    b, _ = plain.prefill(params, {"tokens": toks})
    assert wkv_ops.launch_count == before
    assert torch.equal(a, b)


def test_convert_carries_the_rwkv_tree_and_state():
    """bf16 leaves stacked on the layer dimension, with `decay_base` and
    `bonus` kept f32, and a reference decode state, cross bit for bit."""
    jcfg = jax_get_config(ARCH).reduced().with_(dtype="bfloat16")
    jparams = jax_rwkv.init_params(jax.random.key(1), jcfg)
    _, jstate = jax_rwkv.forward(
        jparams, jnp.asarray(_tokens(jcfg.vocab_size, (B, 3))), jcfg,
        state=jax_rwkv.init_state(B, jcfg))
    params = params_from_reference(jax.tree.map(np.asarray, jparams))
    state = params_from_reference(jax.tree.map(np.asarray, jstate))
    tm, cm = params["blocks"]["tm"], params["blocks"]["cm"]
    assert tm["decay_base"].dtype == tm["bonus"].dtype == torch.float32
    assert tm["wr"].dtype == cm["wk"].dtype == torch.bfloat16
    assert tm["bonus"].shape == (jcfg.n_layers, 4, 64)
    assert cm["wk"].shape == (jcfg.n_layers, jcfg.d_model, jcfg.d_ff)
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in leaves:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert state["wkv"].dtype == torch.float32
    assert state["tm_shift"].dtype == torch.bfloat16
    for name in STATE_KEYS:
        np.testing.assert_array_equal(state[name].float().numpy(),
                                      np.asarray(jstate[name], np.float32))


def test_launcher_prints_the_reference_summary(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                "--prompt-len", "4", "--new-tokens", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"arch=rwkv6-7b generated \(2, 2\) in "
                        r"[0-9.]+s \([0-9.]+ tok/s\)", line), line
