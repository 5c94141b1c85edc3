"""The port's GBMA tiers (`repro_torch.core.gbma`) and complex gains
against the live reference, on the CPU.

Tier (i): `ota_aggregate` (both routes), `GBMASimulator`, the
multi-antenna and blind veneers; tier (ii): `node_weights`,
`gbma_value_and_grad`, `perturb_gradients` in f32 and bf16; tier (iii):
`shard_map_aggregate` over `torch.distributed` with gloo at world size 1
(in this process) and 2 (two spawned processes on a FileStore), with
the reference's tier (ii)/(iii) cross-check (`tests/test_gbma_equivalence.py`);
`slot_energy`; `channel.sample_complex_gains`.

Reference values under the original threefry layout (R1). Bars: the
veneers <= 1e-6 absolute at unit-scale inputs (the reference's own bar
for them, `tests/test_transport.py::TestGoldenCompat`); a 20-step
simulator trajectory <= 1e-6 (its f32 steps of size ~1 round alike);
the tier cross-checks at the reference's rtol 1e-5 + atol 1e-6; bf16
noise and complex gains as stated per test.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import (jax_original_layout, port_channel,  # noqa: E402
                                rel_err)

from repro.core import gbma as jg  # noqa: E402
from repro.core.channel import ChannelConfig  # noqa: E402
from repro.core.channel import \
    sample_complex_gains as j_complex  # noqa: E402
from repro.core.channel import sample_gains as j_sample_gains  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core import gbma as tg  # noqa: E402
from repro_torch.core import rng  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

CHANNELS = {
    "rayleigh": ChannelConfig(fading="rayleigh", noise_std=1.0, energy=2.0,
                              phase_error_max=0.3),
    "equal": ChannelConfig(fading="equal", noise_std=0.5, energy=1.0),
    "rician": ChannelConfig(fading="rician", scale=0.8, noise_std=0.7,
                            energy=1.5),
    "lognormal": ChannelConfig(fading="lognormal", scale=0.5, noise_std=0.3,
                               energy=0.7),
}


def _grads(n=8, d=33, seed=7):
    return np.random.default_rng(seed).standard_normal((n, d)) \
        .astype(np.float32)


def _quad_loss_jax(params, batch):
    X, y = batch
    r = X @ params["w"] - y
    return 0.5 * r * r


def _quad_loss_torch(params, batch):
    X, y = batch
    r = X @ params["w"] - y
    return 0.5 * r * r


# --------------------------------------------------------------------------
# tier (i)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CHANNELS))
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ota_aggregate_matches_reference(name, use_kernel):
    """The veneer against the reference's (both routes: on CPU tensors
    `use_kernel` takes the kernel's plain version, False the plain
    version itself): <= 1e-6."""
    g = _grads()
    with jax_original_layout():
        ref = np.asarray(jg.ota_aggregate(jnp.asarray(g), jax.random.key(11),
                                          CHANNELS[name]))
    out = tg.ota_aggregate(torch.from_numpy(g), rng.key(11),
                           port_channel(CHANNELS[name]),
                           use_kernel=use_kernel)
    assert out.dtype == torch.float32 and out.shape == (33,)
    assert np.abs(out.numpy() - ref).max() <= 1e-6


def test_simulator_matches_reference():
    """`GBMASimulator`: the 20-step trajectory (21 rows) within 1e-6 of
    the reference's scan (the reference pinned its own veneer at 1e-5
    against the pre-transport capture)."""
    target = np.linspace(-1.0, 1.0, 12).astype(np.float32)
    wts = np.linspace(0.5, 1.5, 6).astype(np.float32)
    cfg = ChannelConfig(fading="rayleigh", noise_std=1.0, energy=1.0)
    with jax_original_layout():
        jt_, jw = jnp.asarray(target), jnp.asarray(wts)
        sim = jg.GBMASimulator(
            grad_fn=lambda th: jw[:, None] * (th - jt_)[None, :],
            channel=cfg, stepsize=0.2)
        ref = np.asarray(sim.run(jnp.zeros(12), 20, jax.random.key(5)))
    tt, tw = torch.from_numpy(target), torch.from_numpy(wts)
    out = tg.GBMASimulator(
        grad_fn=lambda th: tw[:, None] * (th - tt)[None, :],
        channel=port_channel(cfg), stepsize=0.2).run(
            torch.zeros(12), 20, rng.key(5))
    assert out.shape == (21, 12)
    assert np.abs(out.numpy() - ref).max() <= 1e-6


@pytest.mark.parametrize("m", [1, 4])
def test_multiantenna_matches_reference(m):
    g = _grads(n=6, d=20)
    cfg = CHANNELS["rayleigh"]
    with jax_original_layout():
        ref = np.asarray(jg.ota_aggregate_multiantenna(
            jnp.asarray(g), jax.random.key(4), cfg, m))
    out = tg.ota_aggregate_multiantenna(torch.from_numpy(g), rng.key(4),
                                        port_channel(cfg), m)
    assert np.abs(out.numpy() - ref).max() <= 1e-6


@pytest.mark.parametrize("m", [2, 8])
@pytest.mark.parametrize("name", ["rayleigh", "rician"])
def test_blind_matches_reference(m, name):
    g = _grads(n=5, d=17)
    cfg = CHANNELS[name]
    with jax_original_layout():
        ref = np.asarray(jg.blind_ota_aggregate(
            jnp.asarray(g), jax.random.key(9), cfg, m))
    out = tg.blind_ota_aggregate(torch.from_numpy(g), rng.key(9),
                                 port_channel(cfg), m)
    assert np.abs(out.numpy() - ref).max() <= 1e-6


def test_slot_energy_matches_reference():
    g = _grads()
    cfg = CHANNELS["rician"]
    ref = float(jg.slot_energy(jnp.asarray(g), cfg))
    out = float(tg.slot_energy(torch.from_numpy(g), port_channel(cfg)))
    np.testing.assert_allclose(out, ref, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CHANNELS))
def test_sample_complex_gains_matches_reference(name):
    """Both parts within 1e-6 relative of the largest |h| (a magnitude
    normal carries R2's erf_inv ulp; cos and sin round per library), the
    magnitude draw shared with `sample_gains` (same key half)."""
    cfg = CHANNELS[name]
    with jax_original_layout():
        ra, rb = (np.asarray(x) for x in j_complex(jax.random.key(3), cfg,
                                                    (4, 6)))
    a, b = tchannel.sample_complex_gains(rng.key(3), port_channel(cfg),
                                         (4, 6))
    assert a.shape == b.shape == (4, 6) and a.dtype == torch.float32
    scale = np.abs(np.hypot(ra, rb)).max()
    assert np.abs(a.numpy() - ra).max() <= 1e-6 * scale
    assert np.abs(b.numpy() - rb).max() <= 1e-6 * scale
    mag = torch.hypot(a, b)
    np.testing.assert_allclose(mag.numpy(), np.hypot(ra, rb), rtol=1e-6)


# --------------------------------------------------------------------------
# tier (ii)
# --------------------------------------------------------------------------
def test_node_weights_matches_reference():
    gcfg_j = jg.GBMAConfig(n_nodes=4, channel=CHANNELS["rayleigh"])
    gcfg_t = tg.GBMAConfig(n_nodes=4, channel=port_channel(
        CHANNELS["rayleigh"]))
    with jax_original_layout():
        ref = np.asarray(jg.node_weights(jax.random.key(3), gcfg_j, 12))
    out = tg.node_weights(rng.key(3), gcfg_t, 12)
    assert out.shape == (12,)
    assert rel_err(out.numpy(), ref) <= 1e-6
    assert torch.equal(out.view(4, 3), out.view(4, 3)[:, :1].expand(4, 3))
    off = tg.GBMAConfig(n_nodes=4, enabled=False)
    assert torch.equal(tg.node_weights(rng.key(3), off, 12), torch.ones(12))
    with pytest.raises(ValueError, match="not divisible"):
        tg.node_weights(rng.key(3), gcfg_t, 10)


def _problem(seed=0, n_nodes=8, per=4, d=6):
    rs = np.random.default_rng(seed)
    X = rs.standard_normal((n_nodes * per, d)).astype(np.float32)
    y = rs.standard_normal(n_nodes * per).astype(np.float32)
    w = rs.standard_normal(d).astype(np.float32)
    return X, y, w


def test_loss_weighting_equals_manual_superposition():
    """d/dw [mean_n h_n f_n] == (1/N) sum h_n g_n (rtol 1e-5 + atol 1e-6,
    the reference's bar), and both equal the reference's tier (ii) at
    1e-6; the caller's params are left as they were."""
    d, n_nodes, per = 6, 8, 4
    X, y, w0 = _problem()
    gcfg = tg.GBMAConfig(n_nodes=n_nodes, channel=port_channel(
        ChannelConfig(noise_std=0.0)))
    weights = tg.node_weights(rng.key(3), gcfg, n_nodes * per)
    params = {"w": torch.from_numpy(w0)}
    batch = (torch.from_numpy(X), torch.from_numpy(y))
    loss, grads = tg.gbma_value_and_grad(_quad_loss_torch)(params, batch,
                                                           weights)
    assert not params["w"].requires_grad
    h = weights.view(n_nodes, per)[:, 0]
    manual = torch.zeros(d)
    for i in range(n_nodes):
        sl = slice(i * per, (i + 1) * per)
        Xi, yi = batch[0][sl], batch[1][sl]
        manual += h[i] * (Xi.T @ (Xi @ params["w"] - yi)) / per
    manual /= n_nodes
    np.testing.assert_allclose(grads["w"].numpy(), manual.numpy(),
                               rtol=1e-5, atol=1e-6)
    with jax_original_layout():
        jl, jgr = jg.gbma_value_and_grad(_quad_loss_jax)(
            {"w": jnp.asarray(w0)}, (jnp.asarray(X), jnp.asarray(y)),
            jnp.asarray(weights.numpy()))
    assert np.abs(grads["w"].numpy() - np.asarray(jgr["w"])).max() <= 1e-6
    assert abs(float(loss) - float(jl)) <= 1e-6


def test_value_and_grad_gives_unused_leaves_zero_gradients():
    X, y, w0 = _problem()
    params = {"w": torch.from_numpy(w0), "unused": torch.ones(3)}
    _, grads = tg.gbma_value_and_grad(_quad_loss_torch)(
        params, (torch.from_numpy(X), torch.from_numpy(y)),
        torch.ones(X.shape[0]))
    assert torch.equal(grads["unused"], torch.zeros(3))


@pytest.mark.parametrize("noise_dtype", ["float32", "bfloat16"])
def test_perturb_gradients_matches_reference(noise_dtype):
    """The edge noise on an unsorted tree with an f32 and a bf16 leaf, in
    the config's noise dtype, the std in host f64 as the reference keeps
    it. f32 leaves with f32 noise within 1e-6 (R2); bf16 noise is JAX's
    own 8-bit bf16 draw (`rng.normal`), so with it every leaf is bit for
    bit, and bf16 leaves are bit for bit under either noise dtype."""
    gcfg_j = jg.GBMAConfig(n_nodes=4, noise_dtype=noise_dtype,
                           channel=ChannelConfig(fading="rayleigh",
                                                 noise_std=0.7, energy=2.0))
    gcfg_t = tg.GBMAConfig(n_nodes=4, noise_dtype=noise_dtype,
                           channel=port_channel(gcfg_j.channel))
    a = np.random.default_rng(2).standard_normal((5, 3)).astype(np.float32)
    with jax_original_layout():
        ref = jg.perturb_gradients(
            {"b": {"c": jnp.full((4,), 2.0, jnp.bfloat16)},
             "a": jnp.asarray(a)}, jax.random.key(21), gcfg_j)
        ref_a = np.asarray(ref["a"], np.float32)
        ref_c = np.asarray(ref["b"]["c"].astype(jnp.float32))
    out = tg.perturb_gradients(
        {"b": {"c": torch.full((4,), 2.0, dtype=torch.bfloat16)},
         "a": torch.from_numpy(a)}, rng.key(21), gcfg_t)
    assert out["a"].dtype == torch.float32
    assert out["b"]["c"].dtype == torch.bfloat16
    assert np.array_equal(out["b"]["c"].float().numpy(), ref_c)
    if noise_dtype == "bfloat16":
        assert np.array_equal(out["a"].numpy(), ref_a)
    else:
        assert np.abs(out["a"].numpy() - ref_a).max() <= 1e-6
    off = tg.GBMAConfig(enabled=False)
    tree = {"a": torch.ones(2)}
    assert tg.perturb_gradients(tree, rng.key(0), off) is tree


# --------------------------------------------------------------------------
# tier (iii): torch.distributed
# --------------------------------------------------------------------------
def _gloo_world_1(tmp_path):
    import torch.distributed as dist

    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    return dist


def test_shard_map_tier_matches_loss_weighting(tmp_path):
    """The explicit protocol over gloo at world size 1 (one node) ==
    the weighted-loss tier plus `perturb_gradients` (rtol 1e-5 + atol
    1e-6, the reference's bar), and both within 1e-6 of the reference's
    tier (ii)."""
    d, n_nodes, per = 4, 1, 8
    X, y, _ = _problem(seed=5, n_nodes=n_nodes, per=per, d=d)
    ch = ChannelConfig(noise_std=0.4, energy=1.0)
    gcfg = tg.GBMAConfig(n_nodes=n_nodes, channel=port_channel(ch))
    k_h, k_w = rng.split(rng.key(7))
    gain = tchannel.sample_gains(k_h, gcfg.channel, (n_nodes,))
    weights = gain.repeat_interleave(per)
    params = {"w": torch.zeros(d)}
    batch = (torch.from_numpy(X), torch.from_numpy(y))
    _, g1 = tg.gbma_value_and_grad(_quad_loss_torch)(params, batch, weights)
    g1 = tg.perturb_gradients(g1, k_w, gcfg)

    dist = _gloo_world_1(tmp_path)
    try:
        _, local = tg.gbma_value_and_grad(_quad_loss_torch)(
            params, batch, torch.ones(per))
        g2 = tg.shard_map_aggregate(local, gain[0], k_w, gcfg)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(g2["w"].numpy(), g1["w"].numpy(), rtol=1e-5,
                               atol=1e-6)
    with jax_original_layout():
        jk_h, jk_w = jax.random.split(jax.random.key(7))
        jgcfg = jg.GBMAConfig(n_nodes=n_nodes, channel=ch)
        jw = jnp.repeat(j_sample_gains(jk_h, ch, (n_nodes,)), per)
        _, jg1 = jg.gbma_value_and_grad(_quad_loss_jax)(
            {"w": jnp.zeros(d)}, (jnp.asarray(X), jnp.asarray(y)), jw)
        jg1 = jg.perturb_gradients(jg1, jk_w, jgcfg)
    assert np.abs(g2["w"].numpy() - np.asarray(jg1["w"])).max() <= 1e-6


_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core import gbma, rng
from repro_torch.core.channel import ChannelConfig

rank, store_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
try:
    rs = np.random.default_rng(rank)
    local = {"w": torch.from_numpy(rs.standard_normal((3, 5))
                                   .astype(np.float32)),
             "b": [torch.from_numpy(rs.standard_normal(4)
                                    .astype(np.float32))]}
    gain = torch.tensor(0.5 + rank, dtype=torch.float32)
    gcfg = gbma.GBMAConfig(n_nodes=2, channel=ChannelConfig(
        noise_std=0.3, energy=1.2))
    v = gbma.shard_map_aggregate(local, gain, rng.key(13), gcfg)
    np.savez(out_path, w=v["w"].numpy(), b=v["b"][0].numpy())
finally:
    dist.destroy_process_group()
"""


def test_shard_map_aggregate_over_two_gloo_ranks(tmp_path):
    """Two spawned ranks (gloo, FileStore, no network): each returns the
    same tree, bit for bit, equal to (h_0 g_0 + h_1 g_1) / N + the edge
    noise of `perturb_gradients` within 1e-6 (the all-reduce's sum of two
    terms is exact up to one rounding)."""
    env = {**os.environ, "PYTHONPATH": SRC}
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), store,
         str(tmp_path / f"rank{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    res = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for name in ("w", "b"):
        assert np.array_equal(res[0][name], res[1][name])
    locals_ = []
    for rank in range(2):
        rs = np.random.default_rng(rank)
        locals_.append((rs.standard_normal((3, 5)).astype(np.float32),
                        rs.standard_normal(4).astype(np.float32)))
    gcfg = tg.GBMAConfig(n_nodes=2, channel=port_channel(ChannelConfig(
        noise_std=0.3, energy=1.2)))
    sup = {"w": torch.from_numpy((0.5 * locals_[0][0] + 1.5 * locals_[1][0])
                                 / 2),
           "b": [torch.from_numpy((0.5 * locals_[0][1]
                                   + 1.5 * locals_[1][1]) / 2)]}
    want = tg.perturb_gradients(sup, rng.key(13), gcfg)
    assert np.abs(res[0]["w"] - want["w"].numpy()).max() <= 1e-6
    assert np.abs(res[0]["b"] - want["b"][0].numpy()).max() <= 1e-6
