"""The MoE layer (S4), MLA (S5) and the blockwise attention twin of the
port against the JAX reference, on the CPU.

* `moe_apply` at the reference's cases (`tests/test_moe.py`): top_k 1
  and 2, softmax and sigmoid scoring, 0 and 1 shared experts, capacity
  factors 100 (dropless) and 0.25 (dropping), `opt_bf16_dispatch`, and a
  group size that halves (s = 24: groups of 8). The reference's dispatch
  mask (the first operand of its `gtec,gtd->gecd` einsum, read by a
  recording stand-in for its `jnp`) equals the port's `route` bit for
  bit; the combine weights, the output and the aux loss are held at f32
  bars. The smallest top-2 score margin of each case is printed beside
  the logit bar: a margin below it could flip a choice between the two
  packages.
* The router's bias moves the choice and never the gate; `opt_shardmap_
  moe` changes no bit; expert leaves drawn one expert at a time.
* `mla_apply`: a prefill at s <= 1024 (`full_attention`) and at s = 1040
  (`blockwise_attention`) into a cache, then absorbed decode steps:
  outputs and caches (latents, rotary keys, `pos_ids` exactly).
* `blockwise_attention` against the reference's: causal and not, GQA,
  v narrower than q, ragged blocks, and equal to the materializing
  `full_attention`.

Bars: the reference's MoE bar (tests/test_moe.py:68: atol 2e-4, rtol
1e-3) tightened to 1e-5 + 1e-5·|ref| in f32; attention and MLA 1e-5 +
1e-5·|ref|.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import attention, mla, moe  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

ATOL = RTOL = 1e-5
# (top_k, scoring, shared, capacity_factor, bf16 dispatch, B, S)
MOE_CASES = [
    (1, "softmax", 0, 100.0, False, 2, 8),
    (2, "softmax", 0, 100.0, False, 2, 8),
    (2, "sigmoid", 1, 100.0, False, 2, 8),
    (1, "softmax", 0, 0.25, False, 2, 32),
    (2, "sigmoid", 1, 0.25, False, 2, 32),
    (1, "softmax", 1, 1.25, True, 2, 32),
    (2, "sigmoid", 1, 1.0, True, 2, 24),
    (1, "softmax", 0, 1.25, False, 3, 300),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _moe_cfgs(top_k, scoring, shared, capacity, bf16, **extra):
    kw = dict(top_k=top_k, router_scoring=scoring, n_shared_experts=shared,
              capacity_factor=capacity, opt_bf16_dispatch=bf16,
              dtype="float32", **extra)
    arch = "llama4-maverick-400b-a17b"
    return (jax_get_config(arch).reduced().with_(**kw),
            get_config(arch).reduced().with_(**kw))


def _moe_params(jcfg, seed):
    with jax_original_layout():
        jp = jax_moe.moe_params(jax.random.key(seed), jcfg)
    if "router_bias" in jp:  # a non-zero bias, so it moves the choice
        rs = np.random.default_rng(seed)
        jp["router_bias"] = jnp.asarray(
            0.05 * rs.standard_normal(jp["router_bias"].shape), jnp.float32)
    return jp, params_from_reference(jax.tree.map(np.asarray, jp))


class _RecordingJnp:
    """`jax.numpy` whose einsum keeps the operands of the reference's
    dispatch and combine products."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec in ("gtec,gtd->gecd", "gtec,gecd->gtd"):
            self.seen[spec] = np.asarray(ops[0])
        return jnp.einsum(spec, *ops, **kw)


def _reference_moe(monkeypatch, x, jp, jcfg):
    rec = _RecordingJnp()
    with monkeypatch.context() as m:
        m.setattr(jax_moe, "jnp", rec)
        out, aux = jax_moe.moe_apply(jnp.asarray(x), jp, jcfg, n_groups=1)
    return (np.asarray(out), float(aux), rec.seen["gtec,gtd->gecd"],
            rec.seen["gtec,gecd->gtd"])


def _top2_margin(x, jp, jcfg) -> float:
    """The smallest gap between a token's k-th and (k+1)-th selection
    score over its rounds (the scores the argmax reads)."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ np.asarray(
        jp["router"], np.float64)
    if jcfg.router_scoring == "sigmoid":
        sel = 1 / (1 + np.exp(-logits)) + np.asarray(jp["router_bias"])
    else:
        z = np.exp(logits - logits.max(-1, keepdims=True))
        sel = z / z.sum(-1, keepdims=True)
    top = -np.sort(-sel, axis=-1)[:, :jcfg.top_k + 1]
    return float(np.min(top[:, :-1] - top[:, 1:]))


@pytest.mark.parametrize("top_k,scoring,shared,capacity,bf16,b,s",
                         MOE_CASES)
def test_moe_apply_matches_reference(monkeypatch, top_k, scoring, shared,
                                     capacity, bf16, b, s):
    jcfg, cfg = _moe_cfgs(top_k, scoring, shared, capacity, bf16)
    jp, p = _moe_params(jcfg, seed=s + top_k)
    x = np.random.default_rng(s).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    ref, ref_aux, ref_disp, ref_comb = _reference_moe(monkeypatch, x, jp,
                                                      jcfg)
    out, aux = moe.moe_apply(torch.from_numpy(x), p, cfg)
    tg = moe.group_size(s)
    dispatch, combine, _ = moe.route(torch.from_numpy(x).reshape(-1, tg,
                                                                 cfg.d_model),
                                     p, cfg)
    margin = _top2_margin(x, jp, jcfg)
    kept = int(ref_disp.sum())
    print(f"top-{top_k} {scoring}: smallest selection margin {margin:.3e} "
          f"(logit bar {ATOL}); {kept} of {b * s * top_k} token-slots kept")
    np.testing.assert_array_equal(dispatch.numpy(), ref_disp.astype(bool))
    # the reference's combine operand is cast to x's dtype (f32) first
    assert combine.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_allclose(combine.float().numpy(),
                               ref_comb.astype(np.float32), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(aux.item(), ref_aux, rtol=1e-6)
    if capacity < 1.0:
        assert kept < b * s * top_k  # the case drops tokens


def test_gate_comes_from_the_scores_not_the_biased_choice(monkeypatch):
    """A large bias on expert 0 sends every token there; the gate is the
    unbiased sigmoid score of expert 0, as in the reference."""
    jcfg, cfg = _moe_cfgs(1, "sigmoid", 0, 100.0, False)
    jp, p = _moe_params(jcfg, seed=3)
    bias = np.zeros(cfg.n_experts, np.float32)
    bias[0] = 10.0
    jp["router_bias"] = jnp.asarray(bias)
    p["router_bias"] = torch.from_numpy(bias)
    x = np.random.default_rng(3).standard_normal(
        (1, 8, cfg.d_model)).astype(np.float32)
    _, _, ref_disp, ref_comb = _reference_moe(monkeypatch, x, jp, jcfg)
    dispatch, combine, _ = moe.route(torch.from_numpy(x), p, cfg)
    assert dispatch[..., 0, :].any(-1).all()
    scores = torch.sigmoid(torch.from_numpy(x) @ p["router"])[..., 0]
    np.testing.assert_allclose(combine.sum((-1, -2)).numpy(),
                               scores.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(dispatch.numpy(), ref_disp.astype(bool))
    np.testing.assert_allclose(combine.numpy(), ref_comb, rtol=1e-6)


def test_capacity_goes_to_the_earlier_tokens_of_a_group():
    """All 8 tokens of a group route to one expert of capacity 4: the
    first 4 take slots 0..3 in order, the rest are dropped."""
    _, cfg = _moe_cfgs(1, "softmax", 0, 1.0, False)
    p = {"router": torch.zeros((cfg.d_model, cfg.n_experts))}
    p["router"][0, 2] = 1.0
    x = torch.ones((1, 8, cfg.d_model))
    dispatch, combine, _ = moe.route(x, p, cfg)
    assert moe._capacity(8, cfg) == 4
    slots = dispatch[0, :, 2]  # (Tg, C)
    assert torch.equal(slots[:4], torch.eye(4, dtype=torch.bool))
    assert not slots[4:].any() and not dispatch[0, :, [0, 1, 3]].any()
    assert (combine[0, 4:] == 0).all()


def test_shardmap_moe_changes_no_bit():
    _, cfg = _moe_cfgs(2, "sigmoid", 1, 1.0, False)
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_params(gen, cfg)
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    out, aux = moe.moe_apply(x, p, cfg)
    out2, aux2 = moe.moe_apply(x, p, cfg.with_(opt_shardmap_moe=True))
    assert torch.equal(out, out2) and torch.equal(aux, aux2)


def test_expert_leaves_are_drawn_one_expert_at_a_time(monkeypatch):
    """Each f32 draw is one expert's (d, f) matrix; the leaf has the
    reference's shape and dtype, and every draw is distinct."""
    from repro_torch.models import layers

    cfg = get_config("llama4-maverick-400b-a17b").reduced().with_(
        moe_d_ff=128)
    shapes = []
    real = layers.truncated_normal

    def recording(gen, shape):
        shapes.append(tuple(shape))
        return real(gen, shape)

    monkeypatch.setattr(layers, "truncated_normal", recording)
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_params(gen, cfg, lead=(2,))
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_ff
    assert p["experts_wi"].shape == (2, e, d, f)
    assert p["experts_wo"].shape == (2, e, f, d)
    assert p["router"].dtype == torch.float32
    assert shapes.count((d, f)) == 2 * 2 * e  # wi, wg a (layer, expert)
    assert shapes.count((f, d)) == 2 * e
    assert max(np.prod(s) for s in shapes) < e * d * f
    wi = p["experts_wi"].reshape(-1, d * f)
    assert len({tuple(r[:4].tolist()) for r in wi}) == 2 * e


# ---------------------------------------------------------------- MLA
def _mla_pair(seed=0):
    arch = "deepseek-v3-671b"
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    with jax_original_layout():
        jp = jax_mla.mla_params(jax.random.key(seed), jcfg)
    return jcfg, cfg, jp, params_from_reference(jax.tree.map(np.asarray,
                                                             jp))


def _close(ours, ref, what):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("s", [20, 1040])
def test_mla_prefill_and_absorbed_decode_match_reference(s):
    """Prefill of s positions into a cache of s + 3 (full_attention at
    20, the blockwise twin at 1040 past 1,024), then 3 absorbed decode
    steps; outputs and caches after each."""
    jcfg, cfg, jp, p = _mla_pair()
    b, steps = 2, 3
    rs = np.random.default_rng(s)
    x = rs.standard_normal((b, s + steps, cfg.d_model)).astype(np.float32)
    jcache = jax_mla.init_mla_cache(b, s + steps, jcfg)
    cache = mla.init_mla_cache(b, s + steps, cfg)
    ref, jcache = jax_mla.mla_apply(jnp.asarray(x[:, :s]), jp, jcfg,
                                    positions=jnp.arange(s), cache=jcache)
    out, cache = mla.mla_apply(torch.from_numpy(x[:, :s]), p, cfg,
                               positions=torch.arange(s), cache=cache)
    for pos in range(s, s + steps + 1):
        _close(out, ref, f"output before position {pos}")
        for name in ("c", "k_rope"):
            _close(cache[name], jcache[name], f"{name} before {pos}")
        np.testing.assert_array_equal(cache["pos_ids"].numpy(),
                                      np.asarray(jcache["pos_ids"]))
        if pos == s + steps:
            break
        ref, jcache = jax_mla.mla_apply(
            jnp.asarray(x[:, pos:pos + 1]), jp, jcfg,
            positions=jnp.asarray([pos]), cache=jcache,
            decode_pos=jnp.asarray(pos, jnp.int32))
        out, cache = mla.mla_apply(torch.from_numpy(x[:, pos:pos + 1]), p,
                                   cfg, positions=torch.tensor([pos]),
                                   cache=cache, decode_pos=pos)


def test_mla_prefill_places_position_p_in_slot_p():
    """A prefill's cache holds positions 0..S-1 in slots 0..S-1 and -1
    after, so decode's slot pos mod length is the next free one: with a
    cache at least as long as the prompt plus the new tokens (as
    `Model.prefill` sizes it) nothing wraps."""
    _, cfg, _, p = _mla_pair()
    x = torch.randn((1, 9, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    cache = mla.init_mla_cache(1, 12, cfg)
    _, cache = mla.mla_apply(x, p, cfg, positions=torch.arange(9),
                             cache=cache)
    assert cache["pos_ids"].tolist() == list(range(9)) + [-1] * 3
    c9 = cache["c"].clone()
    _, cache = mla.mla_apply(x[:, :1], p, cfg, positions=torch.tensor([9]),
                             cache=cache, decode_pos=9)
    assert cache["pos_ids"].tolist() == list(range(10)) + [-1] * 2
    assert torch.equal(cache["c"][:, :9], c9[:, :9])


# ------------------------------------------------- blockwise attention
# (B, Hq, Hkv, Sq, d, dv, causal, block_q, block_kv)
BLOCKWISE_CASES = [
    (2, 4, 4, 100, 48, 32, True, 32, 32),
    (1, 6, 2, 77, 16, 16, True, 16, 32),
    (2, 4, 1, 64, 32, 32, True, 32, 16),
    (1, 2, 2, 50, 16, 8, False, 16, 16),
]


@pytest.mark.parametrize("b,hq,hkv,s,d,dv,causal,bq,bk", BLOCKWISE_CASES)
def test_blockwise_attention_matches_reference(b, hq, hkv, s, d, dv, causal,
                                               bq, bk):
    rs = np.random.default_rng(s + d)
    q = rs.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rs.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rs.standard_normal((b, hkv, s, dv)).astype(np.float32)
    kw = dict(scale=d ** -0.5, causal=causal)
    ref = jax_attention.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=bq,
        block_kv=bk, **kw)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    out = attention.blockwise_attention(tq, tk, tv, block_q=bq,
                                        block_kv=bk, **kw)
    assert out.shape == (b, hq, s, dv)
    _close(out, ref, "blockwise attention")
    _close(out, attention.full_attention(tq, tk, tv, **kw).numpy(),
           "blockwise vs full attention")
