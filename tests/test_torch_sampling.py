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
