"""Training olmo-1b and rwkv6-7b over the MAC: the port against the JAX
reference, on the CPU, on their reduced (f32) configs.

For each model, from the reference's initialization carried across by
`models.convert` (drawn inside `jax.threefry_partitionable(False)`, ROADMAP
§3 R1):

* `train_loss_per_example` on the same tokens: the per-example losses
  within 1e-5 relative;
* the gradient of the mean loss against `jax.grad`'s, every leaf within
  1e-4 of its largest magnitude (the port's plain flash backward or plain
  WKV backward against the reference's autodiff of its blockwise
  attention or checkpointed scan: the same f32 functions, summed in
  another order);
* 4-step `build_train_step` + `run_training` trajectories on the fused
  gbma route and on the transport route with receiver momentum, through
  `test_torch_train.py`'s harness at its bars (losses 1e-5 relative,
  parameters 1e-6 + 1e-5·|p|), for olmo-1b from the same start;
* for both models, each of those 4 steps started from the reference's
  own parameters and state of that step, the loss within 1e-5 relative
  and the next parameters within the same bar, or within twice what the
  reference itself moves (in units of that bar) when its input
  parameters are scaled by 1 ± 1e-7, where that is larger.

The second bar is for rwkv6-7b, whose steps are ill-conditioned: its
per-head group norm (RMS, eps 1e-6) at the first position, where the
output is (Σ_i r_i u_i k_i) v_0 and that sum can sit near zero, has a
slope of up to 1 / sqrt(eps), so f32 rounding of the sum is amplified
about a thousandfold. Measured on these inputs: the reference's own
steps move by 0.83 and 12.9 times the 1e-6 + 1e-5·|p| bar (gbma steps 2
and 4) under the 1e-7 nudge, the port's by 1.23 and 13.5 times; olmo-1b
stays within the plain bar. So rwkv6-7b's free 4-step run (past the bar
at step 4 for any f32 summation order) is not held; its steps are.

bf16 is not held here: JAX's CPU bf16 products and the port's round at
other places; the card holds the bf16 models against their plain route.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout  # noqa: E402
from test_torch_train import (PARAM_BAR, STEPS, _hold,  # noqa: E402
                              _port, _port_step, _reference,
                              _reference_step)

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCHS = ["olmo-1b", "rwkv6-7b"]
LOSS_RTOL = 1e-5
GRAD_BAR = 1e-4  # of each leaf's largest |g|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' ops are small: one torch thread runs them as
    fast as eight here and leaves the other cores to the suite's other
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_loss_and_grads(arch: str, tokens) -> tuple:
    """(initial params as numpy, per-example losses, gradient leaves of
    the mean loss) of the reference."""
    jcfg = jax_get_config(arch).reduced()
    with jax_original_layout():
        model = jax_build_model(jcfg)
        params = model.init_params(jax.random.key(0))

    def mean_loss(p):
        losses, _ = model.train_loss_per_example(
            p, {"tokens": jnp.asarray(tokens)})
        return jnp.mean(losses), losses

    (_, losses), grads = jax.value_and_grad(mean_loss, has_aux=True)(params)
    return (jax.tree.map(np.asarray, params), np.asarray(losses),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg = get_config(arch).reduced()
    tokens = np.random.default_rng(17).integers(
        0, cfg.vocab_size, (4, 33), dtype=np.int32)
    init, ref_losses, ref_grads = _reference_loss_and_grads(arch, tokens)
    model = build_model(cfg)
    params = params_from_reference(init)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    losses, metrics = model.train_loss_per_example(
        params, {"tokens": torch.from_numpy(tokens)})
    torch.mean(losses).backward()
    assert losses.shape == (4,) and float(metrics["aux_loss"]) == 0.0
    loss_rel = float(np.max(np.abs(losses.detach().numpy() - ref_losses)
                            / np.abs(ref_losses)))
    print(f"{arch}: losses {loss_rel:.3e} rel (bar {LOSS_RTOL})")
    assert loss_rel <= LOSS_RTOL
    assert len(leaves) == len(ref_grads)
    worst = 0.0
    for p, g in zip(leaves, ref_grads):
        assert p.grad is not None and p.grad.shape == g.shape
        err = float(np.max(np.abs(p.grad.numpy() - g)))
        rel = err / max(float(np.max(np.abs(g))), 1e-30)
        worst = max(worst, rel)
        assert err <= GRAD_BAR * float(np.max(np.abs(g))), (arch, p.shape)
    print(f"{arch}: gradients within {worst:.3e} of each leaf's largest "
          f"(bar {GRAD_BAR})")


@pytest.mark.parametrize("name", ["gbma", "momentum"])
def test_trajectory_matches_reference(name):
    init, ref_losses, ref_leaves = _reference("olmo-1b", name)
    losses, leaves, hist = _port("olmo-1b", name, init)
    _hold(f"olmo-1b {name}", losses, leaves, ref_losses, ref_leaves)
    assert all(np.isfinite(h["grad_norm"]) for h in hist)


def _to_port(tree):
    """A reference tree (dicts, tuples, None, arrays) as the port's."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_port(v) for v in tree)
    return None if tree is None else params_from_reference(np.asarray(tree))


def _margin(leaves, ref_leaves) -> float:
    """The largest |a - b| / (1e-6 + 1e-5·|b|) over every leaf."""
    return max(float(np.max(np.abs(np.asarray(a, np.float64) - b)
                            / (PARAM_BAR[0] + PARAM_BAR[1] * np.abs(b))))
               for a, b in zip(leaves, ref_leaves))


@pytest.mark.parametrize("name", ["gbma", "momentum"])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_step_matches_reference(arch, name):
    """Step i of the port from the reference's parameters and optimizer
    (and transport) state after i steps, against the reference's step i,
    for i = 0 .. 3: the loss within 1e-5 relative, the next parameters
    within the trajectory bar or twice the reference's own spread under a
    1 ± 1e-7 scaling of its input parameters (module docstring)."""
    with jax_original_layout():
        model, jstep, jds = _reference_step(arch, name)
        params = model.init_params(jax.random.key(0))
        state = jstep.init_state(params)
        tokens = [t for _, t in zip(range(STEPS), jds)]
        trail = [(params, state)]
        ref_losses, spread = [], []
        for i, t in enumerate(tokens):
            nxt, state_n, metrics = jstep(params, state, {"tokens": t}, i)
            ref = [np.asarray(x, np.float64)
                   for x in jax.tree_util.tree_leaves(nxt)]
            spread.append(max(_margin(jax.tree_util.tree_leaves(jstep(
                jax.tree.map(lambda x, e=e: x * (1 + e), params), state,
                {"tokens": t}, i)[0]), ref) for e in (1e-7, -1e-7)))
            params, state = nxt, state_n
            trail.append((params, state))
            ref_losses.append(float(metrics["loss"]))
    step, _ = _port_step(arch, name)
    for i, t in enumerate(tokens):
        p, st = _to_port(jax.tree.map(np.asarray, trail[i]))
        p, _, metrics = step(p, st, {"tokens": torch.from_numpy(
            np.asarray(t))}, i)
        loss_rel = abs(float(metrics["loss"]) - ref_losses[i]) \
            / abs(ref_losses[i])
        margin = _margin([x.float().numpy() for x in tree_leaves(p)],
                         [np.asarray(x, np.float64) for x in
                          jax.tree_util.tree_leaves(trail[i + 1][0])])
        bar = max(1.0, 2.0 * spread[i])
        print(f"{arch} {name} step {i}: loss {loss_rel:.3e} rel (bar "
              f"{LOSS_RTOL}); params at {margin:.3f} of the trajectory bar "
              f"(the reference's own spread {spread[i]:.3f}; bar {bar:.3f})")
        assert loss_rel <= LOSS_RTOL
        assert margin <= bar, (arch, name, i)


@pytest.mark.parametrize("aggregator", ["gbma", "momentum"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_model(arch, aggregator, capsys):
    """`python -m repro_torch.launch.train --arch <arch> --reduced` runs on
    the CPU for both models, on the fused route and through the
    transport, with no new flag; the loss is finite."""
    from repro_torch.launch import train as launch

    launch.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "4",
                 "--seq", "16", "--nodes", "2", "--aggregator", aggregator,
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith(f"arch={arch} ")
    assert np.isfinite(float(out.rsplit("final loss", 1)[1].split()[0]))


@pytest.mark.parametrize("aggregator,route", [("gbma", "auto"),
                                              ("momentum", "transport")])
def test_train_step_leaves_no_tensor_in_reference_cycles(aggregator, route):
    """A training step on the reduced olmo-1b leaves no tensor for the
    cyclic garbage collector: with it off, nothing the step allocated
    outlives the step's return values (on the card, tensors held in
    cycles between collections ran rwkv6-7b's transport step out of
    memory)."""
    import gc

    from repro_torch.core.gbma import GBMAConfig
    from repro_torch.core import transport
    from repro_torch.optim.gd import momentum
    from repro_torch.training.train_step import TrainConfig, build_train_step

    cfg = get_config("olmo-1b").reduced()
    tp = transport.TransportConfig(n_nodes=2) if route == "transport" \
        else None
    step = build_train_step(build_model(cfg), TrainConfig(
        aggregator=aggregator, gbma=GBMAConfig(n_nodes=2), route=route,
        transport=tp), momentum(0.05))
    params = build_model(cfg).init_params(device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 17), dtype=np.int32))
    state = step.init_state(params)
    step(params, state, {"tokens": tokens}, 0)  # imports and first calls
    gc.collect()
    gc.disable()
    try:
        out = step(params, state, {"tokens": tokens}, 1)
        del out
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []
