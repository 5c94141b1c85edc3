"""The port's gain samplers against the reference's: the engine sampler
`repro_torch.core.mc.sampling._sample_gains` against
`repro.core.mc.sampling._sample_gains` for all four fading families ×
{phase 0 with `phase_zero`, phase error 0.3} × N in {1, 6, 500}, and the
host-side `channel.sample_gains` twin — within 1e-6 relative (normals
carry an ulp of erf_inv rounding; log/cos/exp round per library)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import (jax_original_layout, port_channel,  # noqa: E402
                                rel_err)

from repro.core import channel as jchannel  # noqa: E402
from repro.core.mc import sampling as jsampling  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core.mc import sampling as tsampling  # noqa: E402

FADINGS = ["equal", "rayleigh", "rician", "lognormal"]
PARAMS = {"scale": 0.8, "rician_k": 4.0}


def _keys(n_keys: int = 3):
    with jax_original_layout():
        keys = [jax.random.fold_in(jax.random.key(11), i)
                for i in range(n_keys)]
        data = np.stack([np.asarray(jax.random.key_data(k)) for k in keys])
    return keys, torch.tensor(data.astype(np.int64))


@pytest.mark.parametrize("fading", FADINGS)
@pytest.mark.parametrize("phase_error_max,phase_zero", [(0.0, True),
                                                         (0.3, False)])
@pytest.mark.parametrize("n", [1, 6, 500])
def test_sample_gains_matches_reference(fading, phase_error_max, phase_zero,
                                        n):
    p = {**PARAMS, "phase_error_max": phase_error_max}
    keys, tkeys = _keys()
    with jax_original_layout():
        pj = {k: jnp.float32(v) for k, v in p.items()}
        ref = np.stack([np.asarray(jsampling._sample_gains(
            k, fading, pj, (n,), phase_zero)) for k in keys])
    pt = {k: torch.full((len(keys),), v, dtype=torch.float32)
          for k, v in p.items()}
    out = tsampling._sample_gains(tkeys, fading, pt, (n,), phase_zero)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert rel_err(out.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("fading", FADINGS)
def test_magnitude_m2_matches_channel_config(fading):
    cfg = tchannel.ChannelConfig(fading=fading, scale=0.8, rician_k=4.0)
    p = {"scale": torch.tensor([0.8]), "rician_k": torch.tensor([4.0])}
    assert float(tsampling._magnitude_m2(fading, p)[0]) == pytest.approx(
        cfg.magnitude_m2, rel=1e-6)


@pytest.mark.parametrize("fading", FADINGS)
@pytest.mark.parametrize("phase_error_max", [0.0, 0.3])
def test_channel_sample_gains_matches_reference(fading, phase_error_max):
    cfg = jchannel.ChannelConfig(fading=fading, scale=0.8,
                                 phase_error_max=phase_error_max)
    keys, tkeys = _keys()
    with jax_original_layout():
        ref = np.stack([np.asarray(jchannel.sample_gains(k, cfg, (4, 90)))
                        for k in keys])
    out = tchannel.sample_gains(tkeys, port_channel(cfg), (4, 90))
    assert rel_err(out.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("fading", FADINGS)
@pytest.mark.parametrize("phase_error_max", [0.0, 0.3])
def test_channel_config_pure_python_identical(fading, phase_error_max):
    ref = jchannel.ChannelConfig(fading=fading, scale=1.3, rician_k=3.0,
                                 phase_error_max=phase_error_max,
                                 noise_std=0.7, energy=0.25)
    port = port_channel(ref)
    for name in ("mu_h", "sigma_h2", "dispersion", "magnitude_m2"):
        assert getattr(port, name) == getattr(ref, name), name
    assert tchannel.edge_noise_std(port, 37) == \
        jchannel.edge_noise_std(ref, 37)
    assert tchannel.received_snr_db(port, 37, 2.0) == \
        jchannel.received_snr_db(ref, 37, 2.0)


# ------------------------------------------------ dynamic-N (counts as data)
from repro_torch.core import rng  # noqa: E402

N_MAX = 13
# odd and even counts, a lone node and N = n_max, one per trajectory
COUNTS = (1, 6, 9, N_MAX)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in f32 units in the last place."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(ia - ib)))


def _padded(rows, width):
    return np.stack([np.pad(r, [(0, width - r.shape[0])]
                            + [(0, 0)] * (r.ndim - 1)) for r in rows])


def test_dynamic_bits_match_shaped_bits():
    keys, tkeys = _keys(len(COUNTS))
    with jax_original_layout():
        ref = [np.asarray(jax.random.bits(k, (n,))).astype(np.int64)
               for k, n in zip(keys, COUNTS)]
        # the reference's own counts-as-data bits, lanes < n
        jdyn = [np.asarray(jsampling._dynamic_bits(
            jax.random.key_data(k), jnp.int32(n), N_MAX)).astype(np.int64)
            for k, n in zip(keys, COUNTS)]
    out = rng.dynamic_bits(tkeys, torch.tensor(COUNTS), N_MAX).numpy()
    assert out.shape == (len(COUNTS), N_MAX)
    for b, n in enumerate(COUNTS):
        np.testing.assert_array_equal(out[b, :n], ref[b])
        np.testing.assert_array_equal(out[b, :n], jdyn[b][:n])


def test_dynamic_uniforms_and_normals_match_shaped_draws():
    """Uniforms bit for bit; normals and the fdm noise within 3 ulps
    (R2), zero past each trajectory's count."""
    d = 5
    keys, tkeys = _keys(len(COUNTS))
    sizes = torch.tensor(COUNTS)
    with jax_original_layout():
        uni = [np.asarray(jax.random.uniform(k, (n,))) for k, n in
               zip(keys, COUNTS)]
        nrm = [np.asarray(jax.random.normal(k, (n, d))) for k, n in
               zip(keys, COUNTS)]
    u = rng.bits_to_u01(rng.dynamic_bits(tkeys, sizes, N_MAX)).numpy()
    for b, n in enumerate(COUNTS):
        np.testing.assert_array_equal(u[b, :n], uni[b])
    z = tsampling._normal_dynamic_n(tkeys, sizes, N_MAX, d).numpy()
    ref = _padded(nrm, N_MAX)
    assert z.shape == ref.shape
    assert _ulps(z, ref) <= 3
    for b, n in enumerate(COUNTS):
        assert not z[b, n:].any()


@pytest.mark.parametrize("fading", FADINGS)
@pytest.mark.parametrize("phase_error_max,phase_zero", [(0.0, True),
                                                         (0.3, False)])
def test_dynamic_gains_match_shaped_draws(fading, phase_error_max,
                                          phase_zero):
    """The dynamic-N gains against the reference's shaped per-N draws
    (and its own dynamic-N sampler) within 1e-6 relative, bit for bit
    against the port's shaped draws, exactly 0 past each count."""
    p = {**PARAMS, "phase_error_max": phase_error_max}
    keys, tkeys = _keys(len(COUNTS))
    with jax_original_layout():
        pj = {k: jnp.float32(v) for k, v in p.items()}
        ref = _padded([np.asarray(jsampling._sample_gains(
            k, fading, pj, (n,), phase_zero)) for k, n in zip(keys, COUNTS)],
            N_MAX)
        jdyn = np.stack([np.asarray(jsampling._sample_gains_dynamic_n(
            k, fading, {**pj, "n_nodes": jnp.float32(n)}, N_MAX,
            phase_zero)) for k, n in zip(keys, COUNTS)])
    pt = {k: torch.full((len(keys),), v, dtype=torch.float32)
          for k, v in p.items()}
    out = tsampling._sample_gains_dynamic_n(
        tkeys, fading, pt, torch.tensor(COUNTS), N_MAX, phase_zero)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert rel_err(out.numpy(), ref) <= 1e-6
    assert rel_err(out.numpy(), jdyn) <= 1e-6
    for b, n in enumerate(COUNTS):
        shaped = tsampling._sample_gains(tkeys[b:b + 1], fading,
                                         {k: v[b:b + 1] for k, v in
                                          pt.items()}, (n,), phase_zero)
        assert torch.equal(out[b, :n], shaped[0])
        assert not out[b, n:].any()


def test_row_gains_takes_the_shaped_draw_for_one_count():
    keys, tkeys = _keys(2)
    pt = {k: torch.full((2,), v, dtype=torch.float32)
          for k, v in {**PARAMS, "phase_error_max": 0.3}.items()}
    n = torch.tensor([N_MAX, N_MAX])
    one = tsampling._row_gains(tkeys, "rayleigh", pt, n, (N_MAX,), N_MAX)
    assert torch.equal(one, tsampling._sample_gains(tkeys, "rayleigh", pt,
                                                    (N_MAX,)))
    dyn = tsampling._row_gains(tkeys, "rayleigh", pt, n, (6, N_MAX), N_MAX)
    assert torch.equal(dyn, one)


# ------------------------------------- complex gains, antenna keys (blind)
@pytest.mark.parametrize("fading", FADINGS)
@pytest.mark.parametrize("n", [1, 6, 500])
def test_complex_gains_match_reference(fading, n):
    """Both parts of h·e^{jφ} with the full uniform phase, within 1e-6
    relative (its cos and sin round per library)."""
    keys, tkeys = _keys()
    with jax_original_layout():
        pj = {k: jnp.float32(v) for k, v in PARAMS.items()}
        ref = [np.stack([np.asarray(x) for x in
                         jsampling._sample_complex_gains(k, fading, pj,
                                                         (n,))])
               for k in keys]
    pt = {k: torch.full((len(keys),), v, dtype=torch.float32)
          for k, v in PARAMS.items()}
    re, im = tsampling._sample_complex_gains(tkeys, fading, pt, (n,))
    assert re.dtype == torch.float32 and tuple(re.shape) == (len(keys), n)
    assert rel_err(re.numpy(), np.stack([r[0] for r in ref])) <= 1e-6
    assert rel_err(im.numpy(), np.stack([r[1] for r in ref])) <= 1e-6


@pytest.mark.parametrize("fading", FADINGS)
def test_dynamic_complex_gains_match_shaped_draws(fading):
    """The dynamic-N complex gains against the reference's shaped per-N
    draws within 1e-6 relative, bit for bit against the port's shaped
    draws, 0 past each count; `_row_complex_gains` picks the tier."""
    keys, tkeys = _keys(len(COUNTS))
    with jax_original_layout():
        pj = {k: jnp.float32(v) for k, v in PARAMS.items()}
        ref = [jsampling._sample_complex_gains(k, fading, pj, (n,))
               for k, n in zip(keys, COUNTS)]
        ref_re = _padded([np.asarray(r[0]) for r in ref], N_MAX)
        ref_im = _padded([np.asarray(r[1]) for r in ref], N_MAX)
    pt = {k: torch.full((len(keys),), v, dtype=torch.float32)
          for k, v in PARAMS.items()}
    counts = torch.tensor(COUNTS)
    re, im = tsampling._row_complex_gains(tkeys, fading, pt, counts,
                                          COUNTS, N_MAX)
    assert rel_err(re.numpy(), ref_re) <= 1e-6
    assert rel_err(im.numpy(), ref_im) <= 1e-6
    for b, n in enumerate(COUNTS):
        shaped = tsampling._sample_complex_gains(
            tkeys[b:b + 1], fading, {k: v[b:b + 1] for k, v in pt.items()},
            (n,))
        assert torch.equal(re[b, :n], shaped[0][0])
        assert torch.equal(im[b, :n], shaped[1][0])
        assert not re[b, n:].any() and not im[b, n:].any()
    one = tsampling._row_complex_gains(tkeys, fading, pt, counts, (N_MAX,),
                                       N_MAX)
    shaped = tsampling._sample_complex_gains(tkeys, fading, pt, (N_MAX,))
    assert all(torch.equal(a, b) for a, b in zip(one, shaped))


@pytest.mark.parametrize("m_sizes", [(1, 4), (3, 5, 8), (2, 64)])
def test_antenna_keys_replay_split_per_row(m_sizes):
    """Per-row antenna keys: lanes [0, m) equal `split(key, m)` for each
    row's own m (equal bits), the reference's counts-as-data replay (its
    fast path under the original layout) included; one count is the
    plain split."""
    keys, tkeys = _keys(len(m_sizes))
    m_max = max(m_sizes)
    with jax_original_layout():
        ref = [np.asarray(jax.random.key_data(jax.random.split(k, m)))
               for k, m in zip(keys, m_sizes)]
        jrep = [np.asarray(jax.random.key_data(jsampling._antenna_keys(
            k, tuple(sorted(set(m_sizes))),
            {"n_antennas": jnp.float32(m),
             "m_idx": jnp.int32(sorted(set(m_sizes)).index(m))})))
            for k, m in zip(keys, m_sizes)]
    m = torch.tensor(m_sizes, dtype=torch.float32)
    out = tsampling._antenna_keys(tkeys, tuple(sorted(set(m_sizes))), m,
                                  m_max)
    assert tuple(out.shape) == (len(m_sizes), m_max, 2)
    for b, mb in enumerate(m_sizes):
        np.testing.assert_array_equal(out[b, :mb].numpy(), ref[b])
        np.testing.assert_array_equal(out[b, :mb].numpy(), jrep[b][:mb])
    np.testing.assert_array_equal(
        tsampling._antenna_keys(tkeys, (m_max,), m, m_max).numpy(),
        rng.split(tkeys, m_max).numpy())
