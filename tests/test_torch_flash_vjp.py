"""The port's flash attention with its hand-written backward
(`repro_torch.models.flash_vjp`), K2's log-sum-exp output on the CPU
(its plain version), and the training losses (T1) against the JAX
reference, on the CPU.

* `flash_attention`'s forward, `lse` and gradients against the
  reference's `flash_attention` (`src/repro/models/flash_vjp.py`) and
  against the port's materializing `full_attention` under autograd, at
  `tests/test_flash_vjp.py`'s cases (the padding case Sq = 100 and the
  GQA + window + softcap case included), with its tolerances: forward
  atol 2e-5 + rtol 1e-4, gradients atol 5e-4 + rtol 5e-3; `lse` within
  1e-5 + 1e-6·|lse| (K2's `lse` bar).
* `chunked_xent` and `train_loss_per_example` on the reduced repro-100m
  and olmo-1b (f32): losses within 1e-5 relative; parameter gradients
  (port autograd against `jax.grad`) within 1e-5 + 1e-4·|g| of the
  reference's `opt_flash_vjp=True` model, and within the reference's own
  bar (atol 2e-4, rtol 1e-2; `test_flash_vjp.py:80-81`) of its default
  blockwise model. Each check prints its margin.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import flash_vjp as jfv  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.kernels.attention.ops import \
    multi_head_attention  # noqa: E402
from repro_torch.kernels.attention.ref import NEG_INF  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.attention import full_attention  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.flash_vjp import flash_attention  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

FWD_BAR = (2e-5, 1e-4)
GRAD_BAR = (5e-4, 5e-3)
LSE_BAR = (1e-5, 1e-6)

# tests/test_flash_vjp.py's cases (sq, hq, hkv, d, options), its slow
# ones included
VJP_CASES = [
    (96, 2, 2, 16, {}),
    (128, 4, 2, 32, {}),                        # GQA
    (100, 2, 2, 16, {}),                        # padding
    (96, 2, 2, 16, {"window": 24}),
    (96, 2, 2, 16, {"softcap": 15.0}),
    (128, 2, 1, 16, {"window": 40, "softcap": 25.0}),
]



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' ops are small: one torch thread runs them as
    fast as eight here and leaves the other cores to the suite's other
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _margin(a, b, bar) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (bar[0] + bar[1] * np.abs(b))))


def _inputs(sq, hq, hkv, d):
    ks = jax.random.split(jax.random.key(sq * hq + d), 4)
    with jax_original_layout():
        arrs = [np.array(jax.random.normal(k, shape)) for k, shape in zip(
            ks, [(1, hq, sq, d), (1, hkv, sq, d), (1, hkv, sq, d),
                 (1, hq, sq, d)])]
    return arrs


@pytest.mark.parametrize("sq,hq,hkv,d,kw", VJP_CASES)
def test_flash_attention_matches_reference(sq, hq, hkv, d, kw):
    q, k, v, t = _inputs(sq, hq, hkv, d)
    scale = d ** -0.5
    opts = dict(scale=scale, causal=True, block_q=32, block_kv=32, **kw)

    def loss(q, k, v):
        return jnp.sum(jfv.flash_attention(q, k, v, **opts) * t)

    ref_out = jfv.flash_attention(q, k, v, **opts)
    ref_grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    _, ref_lse = jfv._fwd_impl(
        jnp.asarray(q).reshape(1, hkv, hq // hkv, sq, d), k, v, scale, True,
        kw.get("window"), kw.get("softcap"), 0, 32, 32)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, **opts)
    (out * torch.from_numpy(t)).sum().backward()
    _, lse = multi_head_attention(tq.detach(), tk.detach(), tv.detach(),
                                  scale=scale, causal=True,
                                  window=kw.get("window"),
                                  softcap=kw.get("softcap"), return_lse=True)
    margins = {"out": _margin(out.detach().numpy(), ref_out, FWD_BAR),
               "lse": _margin(lse.numpy(),
                              np.asarray(ref_lse).reshape(1, hq, sq),
                              LSE_BAR)}
    for name, ours, ref in zip("qkv", (tq, tk, tv), ref_grads):
        margins[f"d{name}"] = _margin(ours.grad.numpy(), ref, GRAD_BAR)
    print(f"flash_attention {sq, hq, hkv, d, kw}: fractions of the bar "
          f"{margins}")
    assert max(margins.values()) <= 1.0


@pytest.mark.parametrize("sq,hq,hkv,d,kw", VJP_CASES)
def test_flash_attention_gradients_match_full_attention(sq, hq, hkv, d,
                                                        kw):
    """The reference test's own check, on the port alone: the flash
    backward against autograd through the materializing oracle."""
    q, k, v, t = (torch.from_numpy(x) for x in _inputs(sq, hq, hkv, d))
    grads = {}
    for name, fn in (("flash", lambda *a: flash_attention(
            *a, scale=d ** -0.5, causal=True, block_q=32, block_kv=32,
            **kw)), ("full", lambda *a: full_attention(
                *a, scale=d ** -0.5, causal=True, **kw))):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        (out * t).sum().backward()
        grads[name] = (out.detach(), [x.grad for x in leaves])
    margins = [_margin(grads["flash"][0], grads["full"][0], FWD_BAR)] + [
        _margin(a, b, GRAD_BAR)
        for a, b in zip(grads["flash"][1], grads["full"][1])]
    print(f"flash vs full {sq, hq, hkv, d, kw}: {margins}")
    assert max(margins) <= 1.0


def test_masked_rows_and_tile_skips():
    """A row with no live key (a negative q_offset under the causal
    mask) has lse = NEG_INF + ln Skv in the plain version, as the
    reference's, and gets zero gradients; a tile the causal mask hides
    is skipped without changing a gradient (blocks of 16 against one
    block)."""
    from repro_torch.kernels.attention.ref import attention_ref

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 48, 16), generator=gen) for _ in range(3))
    _, lse = attention_ref(q[0], k[0], v[0], scale=0.25, q_offset=-5,
                           return_lse=True)
    assert torch.all(lse[:, :5] == np.float32(NEG_INF + np.log(48)))
    assert torch.all(lse[:, 5:] > -1e3)
    grads = []
    for block in (16, 48):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = flash_attention(*leaves, scale=0.25, q_offset=-5,
                              block_q=block, block_kv=block)
        out.square().sum().backward()
        grads.append([x.grad for x in leaves])
    assert torch.all(grads[0][0][:, :, :5] == 0)
    for a, b in zip(*grads):
        assert _margin(a, b, (1e-6, 1e-5)) <= 1.0


def test_kernel_route_refuses_cpu_and_q_offset():
    q = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, q, q, scale=1.0, impl="kernel")
    with pytest.raises(ValueError, match="no q_offset"):
        flash_attention(q, q, q, scale=1.0, impl="kernel", q_offset=3)
    with pytest.raises(ValueError, match="impl must be"):
        flash_attention(q, q, q, scale=1.0, impl="pallas")


# --------------------------------------------------------------------------
# training losses (T1)
# --------------------------------------------------------------------------
LOSS_RTOL = 1e-5
FLASH_GRAD_BAR = (1e-5, 1e-4)
BLOCKWISE_GRAD_BAR = (2e-4, 1e-2)


def _model_pair(arch, **overrides):
    jcfg = jax_get_config(arch).reduced().with_(**overrides)
    with jax_original_layout():
        jparams = jax_build_model(jcfg).init_params(jax.random.key(0))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 33), dtype=np.int32)
    cfg = get_config(arch).reduced().with_(**overrides)
    return jcfg, jparams, cfg, params_from_reference(
        jax.tree.map(np.asarray, jparams)), tokens


@pytest.mark.parametrize("arch", ["repro-100m", "olmo-1b"])
def test_train_loss_and_gradients_match_reference(arch):
    jcfg, jparams, cfg, params, tokens = _model_pair(arch)
    batch = {"tokens": jnp.asarray(tokens)}

    def mean_loss(model):
        return lambda p: jnp.mean(model.train_loss_per_example(p, batch)[0])

    ref = {}
    for tag, c in (("flash", jcfg.with_(opt_flash_vjp=True)),
                   ("blockwise", jcfg)):
        m = jax_build_model(c)
        losses = m.train_loss_per_example(jparams, batch)[0]
        ref[tag] = (np.asarray(losses), [np.asarray(g) for g in
                    jax.tree_util.tree_leaves(
                        jax.grad(mean_loss(m))(jparams))])

    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    losses, metrics = build_model(cfg).train_loss_per_example(
        params, {"tokens": torch.from_numpy(tokens)})
    torch.mean(losses).backward()
    ours = [p.grad.numpy() for p in leaves]
    loss_rel = float(np.max(np.abs(losses.detach().numpy()
                                   - ref["flash"][0]) / ref["flash"][0]))
    flash = max(_margin(a, b, FLASH_GRAD_BAR)
                for a, b in zip(ours, ref["flash"][1]))
    block = max(_margin(a, b, BLOCKWISE_GRAD_BAR)
                for a, b in zip(ours, ref["blockwise"][1]))
    print(f"{arch}: losses {loss_rel:.2e} rel (bar {LOSS_RTOL}); gradients "
          f"at {flash:.3f} of the flash bar, {block:.3f} of the blockwise "
          "bar")
    assert loss_rel <= LOSS_RTOL
    assert float(metrics["loss"]) == pytest.approx(
        float(np.mean(ref["flash"][0])), rel=LOSS_RTOL)
    assert float(metrics["aux_loss"]) == 0.0
    assert flash <= 1.0 and block <= 1.0


@pytest.mark.parametrize("s,chunk", [(32, 64), (40, 16), (33, 8)])
def test_chunked_xent_matches_reference(s, chunk):
    """Chunks that do and do not divide the sequence (padding), and a
    mask with dropped positions."""
    jcfg = jax_get_config("repro-100m").reduced().with_(logit_chunk=chunk)
    cfg = get_config("repro-100m").reduced().with_(logit_chunk=chunk)
    rs = np.random.default_rng(s)
    embed = rs.standard_normal((cfg.vocab_size, cfg.d_model)) \
        .astype(np.float32) * 0.02
    h = rs.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    labels = rs.integers(0, cfg.vocab_size, (2, s), dtype=np.int32)
    mask = (rs.random((2, s)) > 0.2).astype(np.int32)
    ref = jtfm.chunked_xent({"embed": jnp.asarray(embed)}, jnp.asarray(h),
                            jnp.asarray(labels), jnp.asarray(mask), jcfg)
    ours = tfm.chunked_xent({"embed": torch.from_numpy(embed)},
                            torch.from_numpy(h), torch.from_numpy(labels),
                            torch.from_numpy(mask), cfg)
    rel = float(np.max(np.abs(ours.numpy() - np.asarray(ref))
                       / np.abs(np.asarray(ref))))
    print(f"chunked_xent S={s} chunk={chunk}: {rel:.2e} rel")
    assert rel <= LOSS_RTOL


def test_chunked_xent_recomputes_chunk_logits_in_the_backward():
    """No chunk's (B, chunk, V) logits are saved for the backward: the
    tensors autograd keeps are the chunk inputs, not the logits."""
    cfg = get_config("repro-100m").reduced().with_(logit_chunk=8)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), requires_grad=True)
    h = torch.randn((2, 32, cfg.d_model), requires_grad=True)
    labels = torch.randint(0, cfg.vocab_size, (2, 32))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        loss = tfm.chunked_xent({"embed": embed}, h, labels,
                                torch.ones_like(labels), cfg).sum()
    assert (2, 8, cfg.vocab_size) not in saved
    loss.backward()
    assert torch.isfinite(embed.grad).all() and torch.isfinite(h.grad).all()


def test_bf16_training_on_the_kernel_route_raises_naming_its_item(
        monkeypatch):
    """bf16 attention with grad takes the kernel route's forward, and
    since the bf16 kernel writes the row log-sum-exp (ROADMAP T4, done)
    that route no longer raises: `_launch` hands the bf16 kernel an f32
    (B·H, S) `lse` buffer and returns it as (B, H, S) — here the launch
    is recorded instead of run, as the CPU has no kernel; the plain
    route trains bf16."""
    from repro_torch.kernels.attention import kernel, ops

    seen = {}

    def record(q, k, v, out, *, lse=None, **kw):
        seen.update(dtype=q.dtype, lse=lse)
        out.zero_()
        lse.fill_(0.5)

    monkeypatch.setattr(kernel, "launch", record)
    q = torch.zeros((1, 2, 8, 32), dtype=torch.bfloat16)
    out, lse = ops._launch(q, q, q, scale=1.0, causal=True, window=None,
                           softcap=None, return_lse=True)
    assert seen["dtype"] == torch.bfloat16
    assert seen["lse"].dtype == torch.float32
    assert seen["lse"].shape == (2, 8) and seen["lse"].is_contiguous()
    assert out.dtype == torch.bfloat16 and lse.shape == (1, 2, 8)
    assert torch.all(lse == 0.5)
    leaf = q.clone().float().requires_grad_(True)
    out = flash_attention(leaf.bfloat16(), q, q, scale=1.0)
    out.float().sum().backward()
    assert leaf.grad is not None
