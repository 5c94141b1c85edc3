"""The port's baselines (`repro_torch.core.baselines`) and waveform check
(`repro_torch.core.waveform`) against the live reference, on the CPU.

Trajectories run the reference's key splits on a least-squares problem
with unit-scale iterates; reference values under the original threefry
layout (R1). Bars: the three baselines' 30-step trajectories within 1e-6
absolute (f32 steps of size ~1; the draws differ by R2's 1-ulp erf_inv
gap at most, and the node means are summed in another order); the
waveforms and the received waveform within 1e-6 (f32 cos and matrix
products in another order); the reference's own round-trip bars
(`tests/test_waveform.py`) for the waveform model.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout, port_channel  # noqa: E402

from repro.core import baselines as jb  # noqa: E402
from repro.core import waveform as jwf  # noqa: E402
from repro.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core import waveform as twf  # noqa: E402

STEPS, N, D = 30, 6, 5
CH = ChannelConfig(fading="rayleigh", noise_std=0.3, energy=1.5,
                   phase_error_max=0.2)


def _problem():
    """Per-node least squares: g_n(θ) = (x_n·θ − y_n) x_n + 0.1 θ."""
    rs = np.random.default_rng(0)
    X = (rs.standard_normal((N, D)) / np.sqrt(D)).astype(np.float32)
    y = rs.standard_normal(N).astype(np.float32)
    return X, y


def _grad_fns():
    X, y = _problem()
    jX, jy = jnp.asarray(X), jnp.asarray(y)
    tX, ty = torch.from_numpy(X), torch.from_numpy(y)
    return (lambda th: (jX @ th - jy)[:, None] * jX + 0.1 * th[None, :],
            lambda th: (tX @ th - ty)[:, None] * tX + 0.1 * th[None, :])


def _run_both(make_j, make_t, key=3):
    jfn, tfn = _grad_fns()
    with jax_original_layout():
        ref = np.asarray(make_j(jfn).run(jnp.zeros(D, jnp.float32), STEPS,
                                         jax.random.key(key)))
    out = make_t(tfn).run(torch.zeros(D), STEPS, rng.key(key))
    assert out.shape == (STEPS + 1, D) and out.dtype == torch.float32
    assert np.isfinite(out.numpy()).all()
    return out.numpy(), ref


def test_centralized_gd_matches_reference():
    out, ref = _run_both(lambda f: jb.CentralizedGD(f, 0.5),
                         lambda f: tb.CentralizedGD(f, 0.5))
    assert np.abs(out - ref).max() <= 1e-6


@pytest.mark.parametrize("invert_channel", [True, False])
def test_fdm_gd_matches_reference(invert_channel):
    out, ref = _run_both(
        lambda f: jb.FDMGD(f, CH, 0.5, invert_channel=invert_channel),
        lambda f: tb.FDMGD(f, port_channel(CH), 0.5,
                           invert_channel=invert_channel))
    assert np.abs(out - ref).max() <= 1e-6


@pytest.mark.parametrize("h_min", [0.3, 1.2])
def test_power_control_matches_reference(h_min):
    """h_min 1.2 silences most nodes and some slots entirely (A clamped
    to 1)."""
    out, ref = _run_both(
        lambda f: jb.PowerControlOTA(f, CH, 0.5, h_min=h_min),
        lambda f: tb.PowerControlOTA(f, port_channel(CH), 0.5, h_min=h_min))
    assert np.abs(out - ref).max() <= 1e-6


def test_fdm_slot_energy_matches_reference():
    g = np.random.default_rng(1).standard_normal((N, D)).astype(np.float32)
    ref = float(jb.FDMGD(None, CH, 0.1).slot_energy(jnp.asarray(g)))
    out = float(tb.FDMGD(None, port_channel(CH), 0.1).slot_energy(
        torch.from_numpy(g)))
    np.testing.assert_allclose(out, ref, rtol=1e-6)


# --------------------------------------------------------------------------
# waveform
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d,T,n", [(4, 16, 3), (8, 32, 5), (16, 64, 20)])
def test_matched_filter_equals_abstract_model(d, T, n):
    """The reference's round trip on the port (orthonormality atol 1e-5,
    edge estimate vs the abstract Eq. (8) atol 1e-4), and each stage
    against the reference's at 1e-6."""
    rs = np.random.default_rng(d * T * n)
    g = rs.standard_normal((n, d)).astype(np.float32)
    gains = np.abs(rs.standard_normal(n)).astype(np.float32)
    s = twf.shaping_waveforms(d, T, device="cpu")
    np.testing.assert_allclose((s @ s.T).numpy(), np.eye(d), atol=1e-5)
    rx = twf.transmit(torch.from_numpy(g), torch.from_numpy(gains), s,
                      energy=2.0, noise_std=0.0, key=rng.key(2))
    v = twf.edge_estimate(rx, s, n, 2.0)
    expected = np.einsum("n,nd->d", gains, g) / n
    np.testing.assert_allclose(v.numpy(), expected, atol=1e-4)
    with jax_original_layout():
        js = jwf.shaping_waveforms(d, T)
        jrx = jwf.transmit(jnp.asarray(g), jnp.asarray(gains), js,
                           energy=2.0, noise_std=0.4,
                           key=jax.random.key(2))
        jv = np.asarray(jwf.edge_estimate(jrx, js, n, 2.0))
    assert np.abs(s.numpy() - np.asarray(js)).max() <= 1e-6
    rx = twf.transmit(torch.from_numpy(g), torch.from_numpy(gains), s,
                      energy=2.0, noise_std=0.4, key=rng.key(2))
    assert np.abs(rx.numpy() - np.asarray(jrx)).max() <= 1e-5 * max(
        1.0, float(np.abs(np.asarray(jrx)).max()))
    assert np.abs(twf.edge_estimate(rx, s, n, 2.0).numpy() - jv).max() \
        <= 1e-6 * max(1.0, float(np.abs(jv).max()))


def test_noise_statistics_after_matched_filter():
    """Projected noise must be N(0, sigma_w^2 I_d) (Eq. 7): 2,000 slots'
    keys drawn in one batched call, the reference's bars (mean atol
    0.02, variance rtol 0.2)."""
    d, T, sigma = 8, 32, 0.7
    s = twf.shaping_waveforms(d, T, device="cpu")
    keys = rng.split(rng.key(0), 2000)
    w = twf.matched_filter((sigma * rng.normal(keys, (T,))).T, s).T
    assert w.shape == (2000, d)
    np.testing.assert_allclose(float(w.mean()), 0.0, atol=0.02)
    np.testing.assert_allclose(w.var(dim=0).numpy(), sigma**2 * np.ones(d),
                               rtol=0.2)


def test_shaping_waveforms_needs_enough_samples():
    with pytest.raises(ValueError, match="at least d samples"):
        twf.shaping_waveforms(8, 4, device="cpu")
