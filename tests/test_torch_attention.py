"""The port's attention and layer functions against the JAX reference, on
the CPU.

`multi_head_attention(impl="ref")` — the plain version the CUDA kernel is
held to on the card — against the reference's Pallas kernel run in
interpret mode, at the shapes and bars of `tests/test_kernels.py`'s
attention cases: f32 within atol 5e-5 and rtol 1e-4 (GQA, sliding window,
softcap, padded S = 200, non-causal, d = 256), bf16 within atol 3e-2.
Inputs are made with numpy and handed to both. The layer functions on
the serving path (RoPE, the two norms, the activations and the MLP) and
the GQA oracle `full_attention` are held to atol 1e-6 / rtol 1e-5: the
same f32 arithmetic, summed in another order. Two take atol 1e-5: the
MLP, a sum of d_ff = 512 products, and RoPE at positions up to 2048,
where an ulp of the f32 angle is ~1e-4 rad.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.kernels.attention.ops import \
    multi_head_attention as jax_mha  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.attention import kernel, ops  # noqa: E402
from repro_torch.kernels.attention.ops import \
    multi_head_attention  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402

# tests/test_kernels.py::test_attention_kernel_matches_ref's cases
F32_CASES = [
    (2, 4, 4, 256, 64, {}),
    (1, 8, 2, 256, 64, {}),                      # GQA
    (1, 4, 4, 384, 128, {"window": 100}),        # sliding window
    (1, 4, 4, 256, 64, {"softcap": 30.0}),       # gemma2 softcap
    (1, 2, 2, 200, 64, {}),                      # padding path
    (1, 2, 2, 256, 32, {"causal": False}),
    (1, 4, 4, 512, 256, {"window": 128, "softcap": 50.0}),
]


def _normal(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("b,hq,hkv,s,d,kw", F32_CASES)
def test_plain_version_matches_pallas_kernel(b, hq, hkv, s, d, kw):
    kw = {"causal": True, **kw}
    q = _normal((b, hq, s, d), 1)
    k = _normal((b, hkv, s, d), 2)
    v = _normal((b, hkv, s, d), 3)
    ker = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  scale=d ** -0.5, impl="pallas", interpret=True, **kw)
    before = ops.launch_count
    out = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), scale=d ** -0.5, **kw)
    assert ops.launch_count == before  # the CPU never counts a launch
    np.testing.assert_allclose(out.numpy(), np.asarray(ker), atol=5e-5,
                               rtol=1e-4)


def test_plain_version_matches_pallas_kernel_bf16():
    q, k, v = (_normal((1, 4, 256, 64), i, ml_dtypes.bfloat16)
               for i in (4, 5, 6))
    ker = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  scale=0.125, impl="pallas", interpret=True)
    tq, tk, tv = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                  for a in (q, k, v))
    out = multi_head_attention(tq, tk, tv, scale=0.125, impl="ref")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ker, np.float32), atol=3e-2)


@pytest.mark.parametrize("hq,hkv,kw", [(8, 2, {}), (8, 2, {"window": 100}),
                                       (4, 4, {"softcap": 30.0})])
@pytest.mark.parametrize("score_bytes", [0, ops.PLAIN_SCORE_BYTES])
def test_plain_attention_by_kv_head_matches_pallas_kernel(
        monkeypatch, hq, hkv, kw, score_bytes):
    """`plain_attention` one kv head at a time (no score budget) and all
    heads together, against the Pallas kernel at the f32 bar."""
    monkeypatch.setattr(ops, "PLAIN_SCORE_BYTES", score_bytes)
    q = _normal((2, hq, 256, 64), 7)
    k = _normal((2, hkv, 256, 64), 8)
    v = _normal((2, hkv, 256, 64), 9)
    ker = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  scale=0.125, impl="pallas", interpret=True, **kw)
    out = ops.plain_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=0.125, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ker), atol=5e-5,
                               rtol=1e-4)


def _bf16(a):
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def _tiled_numerics(q, k, v, *, scale, bq, bk, causal, window, softcap,
                    round_p, d_chunk=None, return_lse=False):
    """The arithmetic the flash-attention kernels share, in PyTorch on the
    CPU, in f32: q tiles of `bq` queries against kv tiles of `bk` keys with
    the causal break and the window skip, the online softmax on logits in
    their own units (q·k, or the capped logit; masked ones NEG_INF) with
    exp2 of x·c − m·c, c = scale·log2 e (log2 e under a softcap), and c
    taken as 0 in a row that holds NEG_INF alone, the row sum over the
    unrounded P, P rounded to bf16 before the PV product (`round_p`), the
    output divided by l (l == 0 guard). QKᵀ sums d in one product, or
    (`d_chunk`) in chunks of that many columns added one after another.
    The kernels fuse x·c − m·c into one FMA. With `return_lse`, also the
    f32 kernel's row log-sum-exp from its row state: m·scale + ln l (m +
    ln l under a softcap), NEG_INF where the row holds NEG_INF alone."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    c = 1.4426950408889634 * (1.0 if softcap else scale)
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    out = torch.empty_like(qf)
    lse = torch.empty((b, hq, sq))
    n_tiles = -(-skv // bk)
    chunks = [(0, d)] if d_chunk is None else [
        (i, i + d_chunk) for i in range(0, d, d_chunk)]
    for q0 in range(0, sq, bq):
        rows = torch.arange(q0, q0 + bq)[:, None]
        qt = torch.zeros((b, hq, bq, d))
        qt[:, :, :min(bq, sq - q0)] = qf[:, :, q0:q0 + bq]
        t_end = min(n_tiles, (q0 + bq - 1) // bk + 1) if causal else n_tiles
        x0 = q0 - (window or 0) - bk + 1
        t_begin = x0 // bk + 1 if window and x0 >= 0 else 0
        m = torch.full((b, hq, bq), -1e30)
        l = torch.zeros((b, hq, bq))
        o = torch.zeros((b, hq, bq, d))
        for t in range(t_begin, t_end):
            k0 = t * bk
            kt, vt = (torch.zeros((b, hq, bk, d)) for _ in range(2))
            kt[:, :, :min(bk, skv - k0)] = kf[:, :, k0:k0 + bk]
            vt[:, :, :min(bk, skv - k0)] = vf[:, :, k0:k0 + bk]
            x = torch.zeros((b, hq, bq, bk))
            for lo, hi in chunks:
                x = x + qt[..., lo:hi] @ kt[..., lo:hi].transpose(-1, -2)
            if softcap:
                x = softcap * torch.tanh(x * scale / softcap)
            cols = torch.arange(k0, k0 + bk)[None, :]
            live = cols < skv
            if causal:
                live = live & (rows >= cols)
            if window:
                live = live & (rows - cols < window)
            x = torch.where(live, x, -1e30)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2((m - m_new) * c)
            cr = torch.where(m_new == -1e30, 0.0, c)[..., None]
            p = torch.exp2(x * cr - m_new[..., None] * cr)
            l = l * alpha + p.sum(-1)
            if round_p:
                p = p.bfloat16().float()
            o = o * alpha[..., None] + p @ vt
            m = m_new
        l = torch.where(l == 0, 1.0, l)
        out[:, :, q0:q0 + bq] = (o / l[..., None])[:, :, :sq - q0]
        mx = torch.where(m == -1e30, -1e30, m if softcap else m * scale)
        lse[:, :, q0:q0 + bq] = (mx + torch.log(l))[:, :, :sq - q0]
    return (out, lse) if return_lse else out


def _sm90_numerics(q, k, v, *, scale, causal=True, window=None,
                   softcap=None, round_p=True, return_lse=False):
    """The arithmetic of the bf16 Hopper kernel (`csrc/
    flash_attention_sm90.cu`): `_tiled_numerics` at its 128-query tiles
    and kv tiles of 128 keys (64 at d = 256), P rounded to bf16 before PV
    (`round_p`), the output rounded to bf16. Products are f32 sums of
    exact bf16 products, as wgmma's are (in another order). With
    `return_lse`, also the row log-sum-exp its epilogue writes from the
    row state (m·scale + ln l, m + ln l under a softcap), in f32."""
    bk = 64 if q.shape[-1] == 256 else 128
    out = _tiled_numerics(q, k, v, scale=scale, bq=128, bk=bk,
                          causal=causal, window=window, softcap=softcap,
                          round_p=round_p, return_lse=return_lse)
    if return_lse:
        return out[0].bfloat16(), out[1]
    return out.bfloat16()


def _f32_numerics(q, k, v, *, scale, causal=True, window=None,
                  softcap=None, return_lse=False):
    """The arithmetic of the f32 CUDA-core kernel (`csrc/
    flash_attention.cu`): `_tiled_numerics` at its q tiles of 128 queries
    (64 at d > 64) and kv tiles of 64 keys (32 at d = 256), QKᵀ summed
    over d in chunks of 4 (the kernel's float4 steps), P kept in f32."""
    d = q.shape[-1]
    return _tiled_numerics(q, k, v, scale=scale, bq=128 if d <= 64 else 64,
                           bk=32 if d == 256 else 64, causal=causal,
                           window=window, softcap=softcap, round_p=False,
                           d_chunk=4, return_lse=return_lse)


@pytest.mark.parametrize("b,hq,hkv,s,d,kw", F32_CASES)
def test_bf16_kernel_numerics_hold_the_bar(b, hq, hkv, s, d, kw):
    """The rounding budget of the bf16 Hopper kernel, before the card: its
    numerics (`_sm90_numerics`) against the plain version at the
    reference's bf16 bar (atol 3e-2) over the seven reference cases.
    Rounding P to bf16 is the one rounding the reference does not make;
    the emulation with and without it measures what it costs. Measured on
    these inputs: at most 1.56e-2 with P rounded (two bf16 ulps of an
    output in [1, 2)), 1.95e-3 with P kept in f32, so rounding P takes
    most of the budget and leaves a margin of 1.9x to the bar."""
    kw = {"causal": True, **kw}
    q, k, v = (_bf16(_normal((b, h, s, d), 20 + i, ml_dtypes.bfloat16))
               for i, h in enumerate((hq, hkv, hkv)))
    plain = multi_head_attention(q, k, v, scale=d ** -0.5, impl="ref",
                                 **kw).float()
    errs = {}
    for round_p in (True, False):
        emu = _sm90_numerics(q, k, v, scale=d ** -0.5, round_p=round_p,
                             **kw)
        assert emu.dtype == torch.bfloat16
        errs[round_p] = (emu.float() - plain).abs().max().item()
    print(f"bf16 kernel numerics vs plain, max abs error: P rounded "
          f"{errs[True]:.3e}, P in f32 {errs[False]:.3e} (bar 3e-2)")
    assert errs[True] <= 3e-2 and errs[False] <= 3e-2


@pytest.mark.parametrize("b,hq,hkv,s,d,kw", F32_CASES)
def test_bf16_kernel_lse_numerics_hold_the_bar(b, hq, hkv, s, d, kw):
    """The bf16 kernel's row log-sum-exp (ROADMAP T4), written in its
    epilogue from the row state as the emulation computes it, against the
    plain version's logsumexp of the same bf16 inputs at 1e-5 +
    1e-6·|lse| over the seven reference cases; its output is the
    emulation's without `lse`, with P rounded to bf16 as the kernel
    does (l sums the unrounded P, so lse does not see that rounding)."""
    kw = {"causal": True, **kw}
    q, k, v = (_bf16(_normal((b, h, s, d), 40 + i, ml_dtypes.bfloat16))
               for i, h in enumerate((hq, hkv, hkv)))
    _, plain = multi_head_attention(q, k, v, scale=d ** -0.5, impl="ref",
                                    return_lse=True, **kw)
    emu_out, emu = _sm90_numerics(q, k, v, scale=d ** -0.5, return_lse=True,
                                  **kw)
    assert emu.dtype == torch.float32 and emu.shape == (b, hq, s)
    assert torch.equal(emu_out, _sm90_numerics(q, k, v, scale=d ** -0.5,
                                               **kw))
    err = (emu - plain).abs()
    bar = 1e-5 + 1e-6 * plain.abs()
    print(f"bf16 kernel lse numerics vs plain, max abs error "
          f"{err.max().item():.3e}, margin to the bar "
          f"{(bar / err.clamp_min(1e-30)).min().item():.1f}x")
    assert torch.all(err <= bar)


@pytest.mark.parametrize("b,hq,hkv,s,d,kw", F32_CASES)
def test_f32_kernel_numerics_hold_the_bar(b, hq, hkv, s, d, kw):
    """The rounding budget of the f32 CUDA-core kernel, before the card:
    its numerics (`_f32_numerics`: its q and kv tiles, d summed in chunks
    of 4, exp2 with the scale folded in, the online rescaling per kv tile,
    the l == 0 guard) against the plain version at the reference's f32 bar
    (atol 5e-5 + rtol 1e-4) over the seven reference cases. The margin is
    how many times the error fits under the bar at the tightest
    element."""
    kw = {"causal": True, **kw}
    q, k, v = (torch.from_numpy(_normal((b, h, s, d), 30 + i))
               for i, h in enumerate((hq, hkv, hkv)))
    plain = multi_head_attention(q, k, v, scale=d ** -0.5, impl="ref", **kw)
    emu = _f32_numerics(q, k, v, scale=d ** -0.5, **kw)
    assert emu.dtype == torch.float32
    err = (emu - plain).abs()
    bar = 5e-5 + 1e-4 * plain.abs()
    margin = (bar / err.clamp_min(1e-30)).min().item()
    print(f"f32 kernel numerics vs plain, max abs error "
          f"{err.max().item():.3e}, margin to the bar {margin:.1f}x")
    assert torch.all(err <= bar)


@pytest.mark.parametrize("b,hq,hkv,s,d,kw", F32_CASES)
def test_f32_kernel_lse_numerics_hold_the_bar(b, hq, hkv, s, d, kw):
    """The f32 kernel's row log-sum-exp, written in its epilogue from the
    row state (m in q·k units, or the capped logit; l the exp2 sum), as
    the emulation computes it, against the plain version's logsumexp at
    1e-5 + 1e-6·|lse| over the seven reference cases; its output is the
    emulation's without `lse`."""
    kw = {"causal": True, **kw}
    q, k, v = (torch.from_numpy(_normal((b, h, s, d), 30 + i))
               for i, h in enumerate((hq, hkv, hkv)))
    _, plain = multi_head_attention(q, k, v, scale=d ** -0.5, impl="ref",
                                    return_lse=True, **kw)
    emu_out, emu = _f32_numerics(q, k, v, scale=d ** -0.5, return_lse=True,
                                 **kw)
    assert torch.equal(emu_out, _f32_numerics(q, k, v, scale=d ** -0.5,
                                              **kw))
    err = (emu - plain).abs()
    bar = 1e-5 + 1e-6 * plain.abs()
    print(f"f32 kernel lse numerics vs plain, max abs error "
          f"{err.max().item():.3e}, margin to the bar "
          f"{(bar / err.clamp_min(1e-30)).min().item():.1f}x")
    assert torch.all(err <= bar)


def test_f32_kernel_copy_width_follows_the_view():
    """The f32 kernel stages q, k, v with 16-byte copies where every base
    address is 16-byte aligned and every (batch, head, seq) stride of a
    dimension longer than 1 is a multiple of 4 floats, else with the
    4-byte copies of the same kernel (`kernel.copy_bytes`): a (B, S, H, d)
    view takes 16, the same view offset by one float, or sliced from
    68-wide rows at column 1, takes 4, and one such tensor sets the width
    of the launch."""
    aligned = torch.zeros((2, 100, 4, 64)).transpose(1, 2)
    offset = torch.zeros(2 * 100 * 4 * 64 + 1)[1:].view(2, 100, 4, 64)
    sliced = torch.zeros((2, 100, 4, 68))[..., 1:65]
    odd_stride_len1 = torch.zeros((1, 4, 100, 64)).as_strided(
        (1, 4, 100, 64), (3, 6400, 64, 1))
    assert aligned.data_ptr() % 16 == 0
    assert kernel.copy_bytes(aligned) == 16
    assert kernel.copy_bytes(odd_stride_len1) == 16
    assert kernel.copy_bytes(offset.transpose(1, 2)) == 4
    assert kernel.copy_bytes(sliced.transpose(1, 2)) == 4
    assert kernel.copy_bytes(aligned, aligned, sliced.transpose(1, 2)) == 4


@pytest.mark.parametrize("fault", ["base", "stride"])
def test_bf16_kernel_route_refuses_what_tma_cannot_load(fault):
    """The bf16 kernel loads q, k, v by TMA, which refuses a base address
    off 16 bytes and a (batch, head, seq) stride that is not a multiple of
    16 bytes. Such an operand, and only it, goes to the kernel as a
    contiguous copy (`ops.tma_ready`, a function of address and strides
    alone): the copy is 16-byte aligned with whole-row strides and holds
    the same values; aligned views, strided ones included, pass as they
    are. On CPU tensors the kernel route raises for the device, in
    either dtype."""
    if fault == "base":
        q = torch.arange(2 * 4 * 64 + 1, dtype=torch.bfloat16)[1:]
        q = q.view(1, 2, 4, 64)
    else:
        q = torch.arange(2 * 4 * 68, dtype=torch.bfloat16).view(
            1, 2, 4, 68)[..., :64]
    kv = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16)
    kv_t = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert not ops.tma_loadable(q)
    assert ops.tma_loadable(kv) and ops.tma_loadable(kv_t)
    for args, faulty in (((q, kv, kv_t), 0), ((kv, kv_t, q), 2)):
        ready = ops.tma_ready(*args)
        for i, (t, r) in enumerate(zip(args, ready)):
            if i != faulty:
                assert r is t
                continue
            assert r is not t and r.data_ptr() != t.data_ptr()
            assert r.data_ptr() % 16 == 0 and r.is_contiguous()
            assert ops.tma_loadable(r)
            assert torch.equal(r, t)
    with pytest.raises(ValueError, match="CUDA tensors"):
        multi_head_attention(q, kv, kv, scale=1.0, impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        multi_head_attention(q.float(), kv.float(), kv.float(), scale=1.0,
                             impl="kernel")


def test_kernel_route_refuses_cpu_tensors():
    q = torch.zeros((1, 1, 4, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        multi_head_attention(q, q, q, scale=1.0, impl="kernel")
    kv = torch.zeros((1, 2, 4, 32))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        multi_head_attention(torch.zeros((1, 3, 4, 32)), kv, kv, scale=1.0)


@pytest.mark.parametrize("window", [None, 3])
def test_full_attention_matches_reference_gqa(window):
    q, k, v = (_normal((2, h, 7, 16), i) for i, h in ((7, 4), (8, 2),
                                                        (9, 2)))
    ref = jax_attn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), scale=0.25, window=window)
    out = attn.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=0.25, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-5)
    # the dispatching wrapper (no repeat copies in its kernel route) agrees
    via_ops = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), scale=0.25,
                                   window=window)
    np.testing.assert_allclose(via_ops.numpy(), out.numpy(), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("pos_shape", [(12,), (2, 12)])
def test_rope_matches_reference(pos_shape):
    x = _normal((2, 12, 3, 32), 10)
    pos = np.random.default_rng(11).integers(0, 2048, pos_shape)
    ref = jax_layers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    out = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_norms_match_reference():
    x = 3.0 + 2.0 * _normal((4, 5, 64), 12)
    scale = _normal((64,), 13)
    np.testing.assert_allclose(
        layers.nonparam_layer_norm(torch.from_numpy(x)).numpy(),
        np.asarray(jax_layers.nonparam_layer_norm(jnp.asarray(x))),
        atol=1e-6, rtol=1e-5)
    for plus_one in (False, True):
        np.testing.assert_allclose(
            layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            plus_one=plus_one).numpy(),
            np.asarray(jax_layers.rms_norm(jnp.asarray(x),
                                           jnp.asarray(scale),
                                           plus_one=plus_one)),
            atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_activation_and_mlp_match_reference(act):
    cfg = get_config("olmo-1b").reduced().with_(act=act)
    jcfg = jax_get_config("olmo-1b").reduced().with_(act=act)
    x = _normal((2, 3, cfg.d_model), 14)
    p = {name: _normal(shape, 15 + i) * 0.05 for i, (name, shape) in
         enumerate((("wi", (cfg.d_model, cfg.d_ff)),
                    ("wg", (cfg.d_model, cfg.d_ff)),
                    ("wo", (cfg.d_ff, cfg.d_model))))}
    np.testing.assert_allclose(
        layers.activation(torch.from_numpy(x), act).numpy(),
        np.asarray(jax_layers.activation(jnp.asarray(x), act)),
        atol=1e-6, rtol=1e-5)
    out = layers.mlp_apply(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in p.items()},
                           cfg)
    ref = jax_layers.mlp_apply(jnp.asarray(x),
                               {k: jnp.asarray(v) for k, v in p.items()},
                               jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_initializers_draw_truncated_normals():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, 64, (256, 512), torch.float32)
    e = layers.embed_init(gen, (512, 256), torch.bfloat16)
    assert w.dtype == torch.float32 and e.dtype == torch.bfloat16
    assert float(w.abs().max()) <= 2.0 / 8.0
    # the [-2, 2]-truncated standard normal has std 0.8796
    assert abs(float(w.std()) * 8.0 - 0.8796) < 0.01
    assert abs(float(e.float().std()) / 0.02 - 0.8796) < 0.02
