"""Training hymba-1.5b, whisper-small and pixtral-12b over the MAC (T8):
the port's 4-step trajectories against the reference's jitted train
step, on the CPU, on their reduced (f32) configs.

From the reference's initialization (`models.convert`, drawn inside
`jax.threefry_partitionable(False)`, ROADMAP §3 R1), 4 steps of the
fused gbma route and of gbma through the transport, at the bars of
`test_torch_train.py`: losses within 1e-5 relative, parameters within
1e-6 + 1e-5·|p|. The batches are the launcher's (`launch.train.
train_batches`, held to the reference launcher's in
`test_torch_train_batches.py`): 16 tokens a sequence after a VLM's
patches, with zero f32 frames for whisper, B = 8 over 4 nodes.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout, port_channel  # noqa: E402
from test_torch_train import LR, NODES, STEPS, _channel, _hold  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import transport as jt  # noqa: E402
from repro.core.gbma import GBMAConfig as JaxGBMAConfig  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import gd as jgd  # noqa: E402
from repro.training.loop import run_training as jax_run  # noqa: E402
from repro.training.train_step import \
    TrainConfig as JaxTrainConfig  # noqa: E402
from repro.training.train_step import \
    build_train_step as jax_build_step  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import transport  # noqa: E402
from repro_torch.core.gbma import GBMAConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch.train import train_batches  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import gd  # noqa: E402
from repro_torch.training.loop import run_training  # noqa: E402
from repro_torch.training.train_step import (TrainConfig,  # noqa: E402
                                             build_train_step)

ARCHS = ["hymba-1.5b", "whisper-small", "pixtral-12b"]
ROUTES = {"gbma fused": "auto", "gbma transport": "transport"}
TOKENS, BATCH, NOISE = 16, 8, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(cfg) -> list:
    it = train_batches(cfg, BATCH, TOKENS + cfg.n_patches)
    return [next(it) for _ in range(STEPS)]


def _reference(arch: str, route: str, batches) -> tuple:
    ch = _channel(NOISE)
    jcfg = jax_get_config(arch).reduced()
    tp = None if route == "auto" else jt.TransportConfig(
        n_nodes=NODES, channel=ch, gamma=0.9, stepsize=LR)
    tcfg = JaxTrainConfig(aggregator="gbma",
                          gbma=JaxGBMAConfig(n_nodes=NODES, channel=ch),
                          route=route, transport=tp)
    with jax_original_layout():
        m = jax_build_model(jcfg)
        step = jax_build_step(m, tcfg, jgd.momentum(LR))
        params = m.init_params(jax.random.key(0))
        init = jax.tree.map(np.asarray, params)
        params, _, hist = jax_run(
            step, params, step.init_state(params),
            ({k: jnp.asarray(v) for k, v in b.items()} for b in batches),
            STEPS, log_every=1)
        leaves = [np.asarray(x, np.float32)
                  for x in jax.tree_util.tree_leaves(params)]
    return init, np.asarray([h["loss"] for h in hist], np.float32), leaves


def _port(arch: str, route: str, init, batches) -> tuple:
    ch = port_channel(_channel(NOISE))
    cfg = get_config(arch).reduced()
    tp = None if route == "auto" else transport.TransportConfig(
        n_nodes=NODES, channel=ch, gamma=0.9, stepsize=LR)
    tcfg = TrainConfig(aggregator="gbma",
                       gbma=GBMAConfig(n_nodes=NODES, channel=ch),
                       route=route, transport=tp)
    step = build_train_step(build_model(cfg), tcfg, gd.momentum(LR))
    params = params_from_reference(init)
    params, _, hist = run_training(step, params, step.init_state(params),
                                   iter(batches), STEPS, log_every=1)
    return (np.asarray([h["loss"] for h in hist], np.float32),
            [x.float().numpy() for x in tree_leaves(params)], hist)


@pytest.mark.parametrize("name", sorted(ROUTES))
@pytest.mark.parametrize("arch", ARCHS)
def test_trajectory_matches_reference(arch, name):
    route = ROUTES[name]
    batches = _batches(get_config(arch).reduced())
    init, ref_losses, ref_leaves = _reference(arch, route, batches)
    losses, leaves, hist = _port(arch, route, init, batches)
    _hold(f"{arch} {name}", losses, leaves, ref_losses, ref_leaves)
    assert all(np.isfinite(h["grad_norm"]) for h in hist)
    if route == "transport":
        assert all(np.isfinite(h["tx_energy"]) and h["tx_energy"] > 0
                   for h in hist)


@pytest.mark.parametrize("algo", ["gbma", "blind_ec"])
def test_transport_energy_in_chunks(algo, monkeypatch):
    """The transport sums a leaf's transmitted energy by chunks of
    `ENERGY_CHUNK` values once the leaf is larger (a whole f32 copy of
    pixtral-12b's (8, 671 M) embedding gradient, squared, took 40 GiB):
    shrunk to 64 here, the energy is the whole-leaf sum's within 1e-6
    relative and the update is unchanged bit for bit."""
    gen = torch.Generator().manual_seed(3)
    grads = {"a": torch.randn((4, 30, 7), generator=gen),
             "b": torch.randn((4, 5), generator=gen)}
    tp = transport.TransportConfig(n_nodes=4, n_antennas=2
                                   if algo == "blind_ec" else None,
                                   power_budget=10.0)
    params = {k: v[0] for k, v in grads.items()}
    key = torch.tensor([0, 7])
    out = {}
    for chunk in (transport.ENERGY_CHUNK, 64):
        monkeypatch.setattr(transport, "ENERGY_CHUNK", chunk)
        state = transport.init_state(algo, params, tp) \
            if transport.has_state(algo) else None
        out[chunk] = transport.aggregate(algo, grads, key, tp, state)
    (whole, _, aux), (chunked, _, aux64) = out.values()
    for k in whole:
        assert torch.equal(whole[k], chunked[k])
    np.testing.assert_allclose(float(aux64["tx_energy"]),
                               float(aux["tx_energy"]), rtol=1e-6)
