"""The port's training stack (`repro_torch.training`, `optim`,
`launch.train`) against the JAX reference's, on the CPU.

4-step `build_train_step` + `run_training` trajectories from the same
parameters (the reference's initialization carried across by
`models.convert`) and the same `SyntheticTokens` batches, on the
reference's `test_transport.py::_tiny_model()` and on the reduced
repro-100m: the fused gbma, fdm, centralized and gbma-with-clip cases of
`TestGoldenCompat`, gbma with 2 microbatches, and the transport route
for momentum, nesterov, power_control, blind (M = 2), blind_ec (M = 2,
budget 10) and gbma (`route='transport'`). The reference runs inside
`jax.threefry_partitionable(False)` (ROADMAP §3, R1); the port's keys
are its threefry twin.

Bars: the logged losses within 1e-5 relative, every parameter within
1e-6 + 1e-5·|p| (each printed with its margin). The attention differs
in its f32 sums only (the port's plain forward and flash backward
against the reference's checkpointed blockwise jnp), and the noise
draws match to the normals' ulps (R2). The port's fused trajectories on
the tiny model are also held to the frozen `tests/golden/train_head.npz`
at the same bar (read, not edited).
"""
import dataclasses
import math
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout, port_channel  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import transport as jt  # noqa: E402
from repro.core.channel import ChannelConfig  # noqa: E402
from repro.core.gbma import GBMAConfig as JaxGBMAConfig  # noqa: E402
from repro.data.synthetic import SyntheticTokens as JaxTokens  # noqa: E402
from repro.data.synthetic import \
    TokenDatasetConfig as JaxTokenConfig  # noqa: E402
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
from repro_torch.core.mc.slots import ALGO_REGISTRY  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data.synthetic import (SyntheticTokens,  # noqa: E402
                                        TokenDatasetConfig)
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import gd  # noqa: E402
from repro_torch.training.loop import run_training  # noqa: E402
from repro_torch.training.train_step import (TrainConfig,  # noqa: E402
                                             build_train_step,
                                             resolve_route)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
STEPS, NODES, LR = 4, 4, 0.05
LOSS_RTOL = 1e-5
PARAM_BAR = (1e-6, 1e-5)  # atol + rtol * |p|

# the reference's tiny transport-test model (test_transport.py::_tiny_model)
TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab_size=64, logit_chunk=32, attn_block_q=16,
            attn_block_kv=32)

# TestGoldenCompat's fused cases: (aggregator, noise_std, clip)
FUSED = {"gbma": ("gbma", 0.05, None), "fdm": ("fdm", 0.05, None),
         "centralized": ("centralized", 0.0, None),
         "gbma_clip": ("gbma", 0.05, 0.5)}
# the transport route: (aggregator, TransportConfig extras)
TRANSPORT = {"momentum": ("momentum", {}), "nesterov": ("nesterov", {}),
             "power_control": ("power_control", {}),
             "blind": ("blind", {"n_antennas": 2}),
             "blind_ec": ("blind_ec", {"n_antennas": 2,
                                       "power_budget": 10.0}),
             "gbma_transport": ("gbma", {})}


def _configs(model: str):
    """(reference, port) configs: 'tiny', 'reduced' (repro-100m), or an
    architecture's id for its reduced config."""
    if model == "tiny":
        return (jax_get_config("repro-100m").with_(**TINY),
                get_config("repro-100m").with_(**TINY))
    arch = "repro-100m" if model == "reduced" else model
    return jax_get_config(arch).reduced(), get_config(arch).reduced()


def _case(name: str):
    """(aggregator, noise_std, clip, microbatches, route, transport
    extras or None)."""
    if name in FUSED:
        return (*FUSED[name], 1, "auto", None)
    if name == "gbma_mb2":
        return ("gbma", 0.05, None, 2, "auto", None)
    algo, extra = TRANSPORT[name]
    return (algo, 0.05, None, 1, "transport", extra)


def _channel(noise_std):
    return ChannelConfig(fading="rayleigh", noise_std=noise_std, energy=1.0,
                         phase_error_max=0.3)


def _reference_step(model: str, name: str) -> tuple:
    """(the reference's model, train step and token stream of case
    `name`); call inside `jax_original_layout()`."""
    algo, noise, clip, mb, route, extra = _case(name)
    jcfg, _ = _configs(model)
    ch = _channel(noise)
    m = jax_build_model(jcfg)
    tp = None if extra is None else jt.TransportConfig(
        n_nodes=NODES, channel=ch, gamma=0.9, stepsize=LR, **extra)
    tcfg = JaxTrainConfig(
        aggregator=algo, gbma=JaxGBMAConfig(n_nodes=NODES, channel=ch),
        clip_norm=clip, microbatches=mb, route=route, transport=tp)
    step = jax_build_step(m, tcfg, jgd.momentum(LR))
    ds = JaxTokens(JaxTokenConfig(vocab_size=jcfg.vocab_size,
                                  seq_len=16, global_batch=8, seed=3))
    return m, step, ds


def _reference(model: str, name: str) -> tuple:
    """(initial params as numpy, logged losses, final params as numpy
    leaves) of the reference's 4-step run."""
    with jax_original_layout():
        m, step, ds = _reference_step(model, name)
        params = m.init_params(jax.random.key(0))
        init = jax.tree.map(np.asarray, params)
        params, _, hist = jax_run(
            step, params, step.init_state(params),
            ({"tokens": t} for t in ds), STEPS, log_every=1)
        leaves = [np.asarray(x, np.float32)
                  for x in jax.tree_util.tree_leaves(params)]
    return init, np.asarray([h["loss"] for h in hist], np.float32), leaves


def _port_step(model: str, name: str) -> tuple:
    """(the port's train step of case `name`, its token stream)."""
    algo, noise, clip, mb, route, extra = _case(name)
    _, cfg = _configs(model)
    ch = port_channel(_channel(noise))
    tp = None if extra is None else transport.TransportConfig(
        n_nodes=NODES, channel=ch, gamma=0.9, stepsize=LR, **extra)
    tcfg = TrainConfig(aggregator=algo, gbma=GBMAConfig(n_nodes=NODES,
                                                        channel=ch),
                       clip_norm=clip, microbatches=mb, route=route,
                       transport=tp)
    step = build_train_step(build_model(cfg), tcfg, gd.momentum(LR))
    ds = SyntheticTokens(TokenDatasetConfig(vocab_size=cfg.vocab_size,
                                            seq_len=16, global_batch=8,
                                            seed=3))
    return step, ds


def _port(model: str, name: str, init) -> tuple:
    """(logged losses, final params as numpy leaves in JAX's order, the
    run's history) of the port's 4-step run from the same parameters."""
    step, ds = _port_step(model, name)
    params = params_from_reference(init)
    params, _, hist = run_training(step, params, step.init_state(params),
                                   ({"tokens": t} for t in ds), STEPS,
                                   log_every=1)
    return (np.asarray([h["loss"] for h in hist], np.float32),
            [x.float().numpy() for x in tree_leaves(params)], hist)


def _hold(tag, losses, leaves, ref_losses, ref_leaves) -> None:
    assert len(losses) == len(ref_losses) == STEPS
    loss_rel = float(np.max(np.abs(losses - ref_losses)
                            / np.abs(ref_losses)))
    margin = max(float(np.max(np.abs(a - b) / (PARAM_BAR[0]
                                               + PARAM_BAR[1] * np.abs(b))))
                 for a, b in zip(leaves, ref_leaves))
    print(f"{tag}: losses {loss_rel:.3e} rel (bar {LOSS_RTOL}); params at "
          f"{margin:.3f} of the bar")
    assert loss_rel <= LOSS_RTOL, tag
    assert [a.shape for a in leaves] == [b.shape for b in ref_leaves]
    assert margin <= 1.0, tag


CASES = [*FUSED, "gbma_mb2", *TRANSPORT]



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' ops are small: one torch thread runs them as
    fast as eight here and leaves the other cores to the suite's other
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("model", ["tiny", "reduced"])
def test_trajectory_matches_reference(model, name):
    init, ref_losses, ref_leaves = _reference(model, name)
    losses, leaves, hist = _port(model, name, init)
    _hold(f"{model} {name}", losses, leaves, ref_losses, ref_leaves)
    assert all(math.isfinite(h["grad_norm"]) for h in hist)
    if _case(name)[4] == "transport":
        assert all(math.isfinite(h["tx_energy"]) and h["tx_energy"] > 0
                   for h in hist)


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_trajectory_matches_golden(name):
    """The frozen pre-transport captures: the port from the reference's
    initialization (original threefry layout) lands on them."""
    gold = np.load(GOLDEN / "train_head.npz")
    with jax_original_layout():
        init = jax.tree.map(np.asarray, jax_build_model(
            _configs("tiny")[0]).init_params(jax.random.key(0)))
    losses, leaves, _ = _port("tiny", name, init)
    flat = np.concatenate([x.ravel() for x in leaves])
    _hold(f"golden {name}", losses, [flat], gold[f"{name}_losses"],
          [gold[f"{name}_params"]])


def test_routes_resolve_as_the_reference():
    from repro.training.train_step import resolve_route as jax_resolve

    for algo in ALGO_REGISTRY:
        for route in ("auto", "transport"):
            assert resolve_route(TrainConfig(aggregator=algo, route=route)) \
                == jax_resolve(JaxTrainConfig(aggregator=algo, route=route))
    with pytest.raises(ValueError, match="route must be"):
        resolve_route(TrainConfig(route="fused"))
    with pytest.raises(ValueError, match="unknown algo"):
        resolve_route(TrainConfig(aggregator="nope"))


def test_train_config_defaults_match_the_reference():
    ours = dataclasses.asdict(TrainConfig())
    ref = dataclasses.asdict(JaxTrainConfig())
    assert ours.keys() == ref.keys()
    for key in ours:
        if key != "gbma":
            assert ours[key] == ref[key], key
    assert ours["gbma"]["n_nodes"] == ref["gbma"]["n_nodes"]


def test_step_refusals():
    """The reference's refusals: a transport config on the fused route,
    microbatches on the transport route; an unknown key kind. rbg and
    unsafe_rbg keys build and step on both routes (their trajectories:
    `test_torch_rbg.py`, `test_torch_unsafe_rbg.py`)."""
    _, cfg = _configs("tiny")
    model = build_model(cfg)
    with pytest.raises(ValueError, match="fused route ignores it"):
        build_train_step(model, TrainConfig(
            transport=transport.TransportConfig()), gd.gd(0.1))
    with pytest.raises(ValueError, match="microbatch"):
        build_train_step(model, TrainConfig(aggregator="momentum",
                                            microbatches=2), gd.gd(0.1))
    params = model.init_params(device="cpu")
    tokens = torch.zeros((4, 9), dtype=torch.long)
    for impl, route in (("rbg", "auto"), ("unsafe_rbg", "auto"),
                        ("unsafe_rbg", "transport")):
        tp = transport.TransportConfig(n_nodes=2) \
            if route == "transport" else None
        step = build_train_step(model, TrainConfig(
            rng_impl=impl, gbma=GBMAConfig(n_nodes=2), route=route,
            transport=tp), gd.gd(0.1))
        new, _, metrics = step(params, step.init_state(params),
                               {"tokens": tokens}, 0)
        assert math.isfinite(float(metrics["loss"])), (impl, route)
        assert not torch.equal(new["embed"], params["embed"])
    with pytest.raises(ValueError, match="rng_impl"):
        build_train_step(model, TrainConfig(rng_impl="philox"), gd.gd(0.1))


@pytest.mark.parametrize("algo", sorted(ALGO_REGISTRY))
def test_launcher_aggregator_matrix(algo, monkeypatch, capsys):
    """`repro_torch.launch.train` accepts every registered aggregator and
    runs two steps at the tiny size on the CPU."""
    tiny = _configs("tiny")[1]
    monkeypatch.setattr(launch, "get_config", lambda name: tiny)
    argv = ["--steps", "2", "--batch", "4", "--seq", "16", "--nodes", "4",
            "--aggregator", algo, "--optimizer", "gd", "--noise-std",
            "0.05", "--device", "cpu"]
    if ALGO_REGISTRY[algo].blind:
        argv += ["--antennas", "2"]
    if algo == "blind_ec":
        argv += ["--power-budget", "10"]
    launch.main(argv)
    out = capsys.readouterr().out
    assert "final loss" in out
    assert math.isfinite(float(out.rsplit("final loss", 1)[1].split()[0]))


def test_launcher_checkpoint_reads_back(tmp_path, capsys):
    """`--checkpoint` writes the trained parameters through the port's
    `checkpoint/ckpt.save`; `restore` reads them back bit for bit."""
    from repro_torch.checkpoint import ckpt

    path = str(tmp_path / "params.npz")
    launch.main(["--reduced", "--steps", "1", "--batch", "2", "--seq", "8",
                 "--nodes", "2", "--device", "cpu", "--checkpoint", path])
    assert "saved checkpoint" in capsys.readouterr().out
    cfg = get_config("repro-100m").reduced()
    template = build_model(cfg).init_params(device="cpu")
    restored = ckpt.restore(path, template)
    assert [tuple(x.shape) for x in tree_leaves(restored)] == \
        [tuple(x.shape) for x in tree_leaves(template)]
