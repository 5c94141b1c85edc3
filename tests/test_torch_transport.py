"""The port's channel-transport layer (`repro_torch.core.transport`)
against the live reference (`repro.core.transport`), on the CPU.

Reference values are computed under the original threefry layout
(`jax_original_layout`, ROADMAP §3 R1); inputs cross as numpy arrays.
Bars, each stated where it is used:

* port vs reference, every registered algorithm, every tiling, f32 and
  bf16 transmit: <= 1e-6 absolute at unit-scale inputs (updates of size
  1-3; the draws are bit-exact but for R2's 1-ulp erf_inv gap, and the
  node sums are taken in another order);
* tiled vs untiled (the reference's own bar): <= 1e-6, the draws bitwise
  equal; `tx_energy` rtol 1e-5 (the reference's);
* the transport loop vs the port's `run_mc`: rtol 1e-4 + atol 5e-6 (the
  reference's `test_transport_loop_matches_run_mc`).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout, port_channel  # noqa: E402

from repro.core import transport as jt  # noqa: E402
from repro.core.channel import ChannelConfig  # noqa: E402
from repro.core.mc.slots import ALGO_REGISTRY as J_REGISTRY  # noqa: E402
from repro_torch.core import rng, transport  # noqa: E402
from repro_torch.core.mc import engine  # noqa: E402
from repro_torch.core.mc.problems import quadratic_mc_problem  # noqa: E402
from repro_torch.core.mc.slots import (ALGO_REGISTRY,  # noqa: E402
                                       slot_update_block)
from repro_torch.core.tree import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.kernels.ota import ops  # noqa: E402

# the reference tests' (run_mc kwargs, TransportConfig kwargs) per algo
ALGO_SETUPS = {
    "gbma": ({}, {}),
    "centralized": ({}, {}),
    "fdm": ({}, {}),
    "power_control": ({}, {}),
    "momentum": ({"momentum": 0.9}, {"gamma": 0.9}),
    "nesterov": ({"momentum": 0.9}, {"gamma": 0.9}),
    "blind": ({"n_antennas": 3}, {"n_antennas": 3}),
    "blind_ec": ({"n_antennas": 3, "power_budget": 2.0},
                 {"n_antennas": 3, "power_budget": 2.0}),
}
N = 4


def _chan(**kw):
    kw.setdefault("fading", "rayleigh")
    kw.setdefault("noise_std", 0.4)
    kw.setdefault("energy", 1.5)
    return ChannelConfig(**kw)


def _tree_np(n=N, seed=5):
    """Per-node gradients; the dict's insertion order is not sorted, so a
    flatten in insertion order would give the leaves other streams."""
    rs = np.random.default_rng(seed)
    return {"b": {"c": rs.standard_normal((n, 7)).astype(np.float32)},
            "a": rs.standard_normal((n, 5, 3)).astype(np.float32)}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _numpy_leaves(tree, jax_tree: bool) -> list:
    if jax_tree:
        return [np.asarray(x, np.float32)
                for x in jax.tree_util.tree_leaves(tree)]
    return [x.float().numpy() for x in tree_leaves(tree)]


def _max_diff(a: list, b: list) -> float:
    assert [x.shape for x in a] == [y.shape for y in b]
    return max(float(np.max(np.abs(x - y))) for x, y in zip(a, b))


def _state_np(algo, n=N):
    """A non-zero transport state (m = 0.5, e = 0.25), as numpy, or
    None: the momentum and error-feedback carries enter the update."""
    spec = ALGO_REGISTRY[algo]
    if not (spec.uses_gamma or spec.error_feedback):
        return None
    st = {}
    if spec.uses_gamma:
        st["m"] = {"b": {"c": np.full((7,), 0.5, np.float32)},
                   "a": np.full((5, 3), 0.5, np.float32)}
    if spec.error_feedback:
        st["e"] = {"b": {"c": np.full((n, 7), 0.25, np.float32)},
                   "a": np.full((n, 5, 3), 0.25, np.float32)}
    return st


def _both(algo, **cfg_kw):
    """(reference's (update, state, aux), port's) for one slot."""
    kw = {**ALGO_SETUPS[algo][1], **cfg_kw}
    ch = _chan(phase_error_max=0.25)
    tree = _tree_np()
    st = _state_np(algo)
    with jax_original_layout():
        jcfg = jt.TransportConfig(n_nodes=N, channel=ch, **kw)
        ref = jt.aggregate(algo, _jax(tree), jax.random.key(3), jcfg,
                           None if st is None else _jax(st))
    tcfg = transport.TransportConfig(n_nodes=N, channel=port_channel(ch),
                                     **kw)
    out = transport.aggregate(algo, _torch(tree), rng.key(3), tcfg,
                              None if st is None else _torch(st))
    return ref, out


def test_algo_setups_cover_both_registries():
    assert set(ALGO_SETUPS) == set(ALGO_REGISTRY) == set(J_REGISTRY)


@pytest.mark.parametrize("algo", sorted(ALGO_SETUPS))
@pytest.mark.parametrize("block_d", [None, 2, 4, 64, transport.FULL_CONCAT])
@pytest.mark.parametrize("transmit_dtype", [None, "bfloat16"])
def test_aggregate_matches_reference(algo, block_d, transmit_dtype):
    """Update, carried state and tx_energy against the reference's slot,
    for every algorithm, tiling and transmit dtype: <= 1e-6 absolute
    (tx_energy rtol 1e-5). The tree's dict is unsorted, so leaf order is
    checked too: the concatenated D axis, which keys each column's
    draws, follows JAX's sorted order."""
    (jv, jst, jaux), (tv, tst, taux) = _both(
        algo, block_d=block_d, transmit_dtype=transmit_dtype)
    out = _numpy_leaves(tv, False)
    assert all(x.dtype == np.float32 for x in out)
    assert _max_diff(out, _numpy_leaves(jv, True)) <= 1e-6
    np.testing.assert_allclose(float(taux["tx_energy"]),
                               float(jaux["tx_energy"]), rtol=1e-5)
    if jst is not None:
        for name in jst:
            assert _max_diff(_numpy_leaves(tst[name], False),
                             _numpy_leaves(jst[name], True)) <= 1e-6
    else:
        assert tst is None


@pytest.mark.parametrize("algo", sorted(ALGO_SETUPS))
@pytest.mark.parametrize("block_d", [None, 2, 4, 64])
def test_tiled_matches_untiled(algo, block_d):
    """Every block_d (per leaf, narrow tiles, tiles wider than any leaf)
    matches the single FULL_CONCAT slot call to <= 1e-6 (the reference's
    bar), tx_energy at rtol 1e-5, the residual at 1e-6."""
    _, tkw = ALGO_SETUPS[algo]
    ch = port_channel(_chan())
    tree = _tree_np()
    st = _state_np(algo)
    res = {}
    for bd in (transport.FULL_CONCAT, block_d):
        cfg = transport.TransportConfig(n_nodes=N, channel=ch, block_d=bd,
                                        **tkw)
        res[bd] = transport.aggregate(algo, _torch(tree), rng.key(0), cfg,
                                      None if st is None else _torch(st))
    (ref, ref_st, ref_aux), (out, out_st, aux) = \
        res[transport.FULL_CONCAT], res[block_d]
    assert _max_diff(_numpy_leaves(out, False),
                     _numpy_leaves(ref, False)) <= 1e-6
    np.testing.assert_allclose(float(aux["tx_energy"]),
                               float(ref_aux["tx_energy"]), rtol=1e-5)
    if out_st is not None and "e" in out_st:
        assert _max_diff(_numpy_leaves(out_st["e"], False),
                         _numpy_leaves(ref_st["e"], False)) <= 1e-6


def _gbma_ctx(n, d, key):
    cfg = transport.TransportConfig(n_nodes=n, channel=port_channel(_chan()))
    spec = transport.resolve("gbma")
    ctx = transport.make_ctx(cfg, spec, device="cpu")
    draws = spec.hoist_draws(key[None, None], ctx, n, d)
    return dataclasses.replace(ctx, draws={k: v[0] for k, v in draws.items()})


def test_tiled_draws_are_bitwise_same_stream():
    """Block [lo, hi) of a slot takes exactly coordinates [lo, hi) of THE
    slot's draws: with zero gradients the update is the noise alone, and
    the block equals the full slot's columns bit for bit. The block is a
    strided view of the full matrix, as the transport passes it."""
    n, d = N, 12
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, n, d)).astype(np.float32))
    key = rng.key(2)
    ctx = _gbma_ctx(n, d, key)
    lo, hi = 3, 9
    full = slot_update_block("gbma", g, key[None], ctx, 0, d)
    blk = slot_update_block("gbma", g[:, :, lo:hi], key[None], ctx, lo, hi)
    z = torch.zeros_like(g)
    z_full = slot_update_block("gbma", z, key[None], ctx, 0, d)
    z_blk = slot_update_block("gbma", z[:, :, lo:hi], key[None], ctx, lo, hi)
    assert torch.equal(z_full[:, lo:hi], z_blk)
    assert torch.allclose(full[:, lo:hi], blk, rtol=0.0, atol=1e-6)


def test_block_guard_rejects_random_algo_without_draws():
    cfg = transport.TransportConfig(n_nodes=N, channel=port_channel(_chan()))
    ctx = transport.make_ctx(cfg, transport.resolve("gbma"), device="cpu")
    with pytest.raises(ValueError, match="pre-materialized draws"):
        slot_update_block("gbma", torch.ones((1, N, 3)), rng.key(0)[None],
                          ctx, 0, 3)
    # a draw-free algorithm needs none
    out = slot_update_block("centralized", torch.ones((1, N, 3)),
                            rng.key(0)[None], ctx, 0, 3)
    assert torch.equal(out, torch.ones((1, 3)))


def test_bf16_transmit_accumulates_f32():
    """bf16 transmit: the update stays f32, a bf16-quantization-sized
    step from the f32 path (nonzero, < 0.05, the reference's bounds);
    `centralized` is exempt and stays bitwise."""
    tree = _torch(_tree_np())
    for algo in ("gbma", "blind", "fdm", "power_control"):
        _, tkw = ALGO_SETUPS[algo]
        cfg = transport.TransportConfig(n_nodes=N, channel=port_channel(
            _chan()), **tkw)
        cfg_bf = dataclasses.replace(cfg, transmit_dtype="bfloat16")
        ref, _, _ = transport.aggregate(algo, tree, rng.key(3), cfg)
        out, _, _ = transport.aggregate(algo, tree, rng.key(3), cfg_bf)
        assert all(x.dtype == torch.float32 for x in tree_leaves(out))
        dev = _max_diff(_numpy_leaves(out, False), _numpy_leaves(ref, False))
        assert 0 < dev < 0.05, f"{algo}: bf16 dev {dev}"
    cfg = transport.TransportConfig(n_nodes=N, channel=port_channel(_chan()))
    ref, _, _ = transport.aggregate("centralized", tree, rng.key(3), cfg)
    out, _, _ = transport.aggregate(
        "centralized", tree, rng.key(3),
        dataclasses.replace(cfg, transmit_dtype=torch.bfloat16))
    assert _max_diff(_numpy_leaves(out, False),
                     _numpy_leaves(ref, False)) == 0.0


def test_blind_ec_budget_saturates_tx_energy():
    """With every node over budget, the transmitted energy is E_N · N · B
    (each node truncated onto the budget sphere), rtol 1e-6 as the
    reference holds it; and the residual carries what was cut."""
    tree = _torch(_tree_np())
    cfg = transport.TransportConfig(n_nodes=N, channel=port_channel(_chan()),
                                    n_antennas=3, power_budget=0.5)
    params = {"b": {"c": tree["b"]["c"][0]}, "a": tree["a"][0]}
    state = transport.init_state("blind_ec", params, cfg)
    _, st, aux = transport.aggregate("blind_ec", tree, rng.key(0), cfg,
                                     state)
    np.testing.assert_allclose(float(aux["tx_energy"]),
                               cfg.channel.energy * N * 0.5, rtol=1e-6)
    sent = [g.reshape(N, -1) - e.reshape(N, -1) for g, e in
            zip(tree_leaves(tree), tree_leaves(st["e"]))]
    norms = sum((x * x).sum(dim=1) for x in sent)
    np.testing.assert_allclose(norms.numpy(), 0.5, rtol=1e-5)


def test_init_state_shapes_and_device():
    cfg = transport.TransportConfig(n_nodes=N, n_antennas=2)
    params = {"w": torch.ones((3, 2)), "b": [torch.ones(4), None]}
    st = transport.init_state("blind_ec", params, cfg)
    assert set(st) == {"e"}
    assert [tuple(x.shape) for x in tree_leaves(st["e"])] == [(N, 4),
                                                             (N, 3, 2)]
    st = transport.init_state("nesterov", params, cfg)
    assert set(st) == {"m"} and st["m"]["b"][1] is None
    assert all(x.dtype == torch.float32 and not x.any()
               for x in tree_leaves(st["m"]))
    assert transport.init_state("gbma", params, cfg) == {}
    assert [transport.has_state(a) for a in sorted(ALGO_SETUPS)] == [
        ALGO_REGISTRY[a].uses_gamma or ALGO_REGISTRY[a].error_feedback
        for a in sorted(ALGO_SETUPS)]


@pytest.mark.parametrize("algo", ["momentum", "nesterov", "blind_ec"])
def test_stateful_aggregators_require_state(algo):
    _, tkw = ALGO_SETUPS[algo]
    cfg = transport.TransportConfig(n_nodes=N, **tkw)
    with pytest.raises(ValueError, match="transport state"):
        transport.aggregate(algo, _torch(_tree_np()), rng.key(0), cfg, None)


def test_resolve_unknown_algo_and_bad_inputs():
    with pytest.raises(ValueError, match="unknown algo"):
        transport.resolve("nope")
    with pytest.raises(ValueError, match="unknown algo"):
        transport.aggregate("nope", _torch(_tree_np()), rng.key(0),
                            transport.TransportConfig(n_nodes=N))
    cfg = transport.TransportConfig(n_nodes=N)
    with pytest.raises(ValueError, match="leading node axis"):
        transport.aggregate("gbma", {"a": torch.ones((N + 1, 2))},
                            rng.key(0), cfg)
    with pytest.raises(ValueError, match="non-empty"):
        transport.aggregate("gbma", {}, rng.key(0), cfg)
    with pytest.raises(ValueError, match="n_antennas"):
        transport.aggregate("blind", _torch(_tree_np()), rng.key(0), cfg)
    with pytest.raises(ValueError, match="ota_impl"):
        transport.aggregate("gbma", _torch(_tree_np()), rng.key(0),
                            dataclasses.replace(cfg, ota_impl="pallas2"))


def test_ota_impl_names_and_cpu_routes():
    """'inline' (the reference's name) is the plain version, bit for bit
    the default 'auto' route on CPU tensors, and no kernel launches there;
    'kernel' and its reference name 'pallas' refuse CPU tensors (the
    kernel runs on the card only), with no fallback."""
    tree = _torch(_tree_np())
    cfg = transport.TransportConfig(n_nodes=N, channel=port_channel(_chan()))
    before = ops.launch_count
    auto, _, _ = transport.aggregate("gbma", tree, rng.key(1), cfg)
    for name in ("ref", "inline"):
        out, _, _ = transport.aggregate(
            "gbma", tree, rng.key(1), dataclasses.replace(cfg, ota_impl=name))
        assert all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(out), tree_leaves(auto)))
    assert ops.launch_count == before
    for name in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            transport.aggregate("gbma", tree, rng.key(1),
                                dataclasses.replace(cfg, ota_impl=name))


def test_step_key_replays_both_schedules():
    with jax_original_layout():
        base = jax.random.key(7)
        ref = np.asarray(jax.random.key_data(jax.random.split(base, 10)))
        fold = np.asarray(jax.random.key_data(jax.random.fold_in(base, 4)))
    tbase = rng.key(7)
    for k in (0, 3, 9):
        assert np.array_equal(
            transport.step_key(tbase, k, mc_steps=10).numpy(), ref[k])
    assert np.array_equal(transport.step_key(tbase, 4).numpy(), fold)


def test_lookahead_params_matches_reference():
    """θ − βγm for nesterov (<= 1e-7: one f32 product and difference),
    the identity for every other algorithm."""
    theta = np.linspace(-1, 1, 6).astype(np.float32)
    m = np.linspace(0.3, -0.2, 6).astype(np.float32)
    with jax_original_layout():
        jcfg = jt.TransportConfig(n_nodes=N, gamma=0.9, stepsize=0.05)
        ref = jt.lookahead_params("nesterov", {"t": jnp.asarray(theta)},
                                  {"m": {"t": jnp.asarray(m)}}, jcfg)
    cfg = transport.TransportConfig(n_nodes=N, gamma=0.9, stepsize=0.05)
    params = {"t": torch.from_numpy(theta)}
    out = transport.lookahead_params("nesterov", params,
                                     {"m": {"t": torch.from_numpy(m)}}, cfg)
    assert np.abs(out["t"].numpy() - np.asarray(ref["t"])).max() <= 1e-7
    assert transport.lookahead_params("momentum", params, {"m": params},
                                      cfg) is params


@pytest.mark.parametrize("noise_dtype", ["float32", "bfloat16"])
def test_add_tree_noise_keys_leaves_in_jax_order(noise_dtype):
    """`add_tree_noise` on an unsorted dict with a list and a None: leaf
    i in JAX's order draws from `split(key, n)[i]`. f32 leaves are held
    at 1e-6 (R2's erf_inv ulp); the bf16 noise is JAX's own 8-bit bf16
    draw and bf16 leaves round the same sum, so they are bit for bit."""
    rs = np.random.default_rng(3)
    tree = {"z": rs.standard_normal((3, 2)).astype(np.float32),
            "a": [rs.standard_normal(4).astype(np.float32), None,
                  rs.standard_normal((2, 2)).astype(np.float32)]}
    bf = rs.standard_normal(5).astype(np.float32)
    std = 0.7 / (4 * 2.0 ** 0.5)
    with jax_original_layout():
        jtree = {"z": jnp.asarray(tree["z"]),
                 "a": [jnp.asarray(tree["a"][0]), None,
                       jnp.asarray(tree["a"][2])],
                 "m": jnp.asarray(bf).astype(jnp.bfloat16)}
        ref = jt.add_tree_noise(jtree, jax.random.key(21), std,
                                noise_dtype=jnp.dtype(noise_dtype))
        ref_leaves = [np.asarray(x.astype(jnp.float32))
                      for x in jax.tree_util.tree_leaves(ref)]
    ttree = {"z": torch.from_numpy(tree["z"]),
             "a": [torch.from_numpy(tree["a"][0]), None,
                   torch.from_numpy(tree["a"][2])],
             "m": torch.from_numpy(bf).to(torch.bfloat16)}
    out = transport.add_tree_noise(ttree, rng.key(21), std,
                                   noise_dtype=noise_dtype)
    assert list(out) == ["z", "a", "m"] and out["a"][1] is None
    assert out["m"].dtype == torch.bfloat16
    leaves = [x.float().numpy() for x in tree_leaves(out)]
    assert len(leaves) == len(ref_leaves) == 4
    for x, y, is_bf16 in zip(leaves, ref_leaves, (False, False, True, False)):
        if is_bf16 or noise_dtype == "bfloat16":
            assert np.array_equal(x, y)
        else:
            assert np.abs(x - y).max() <= 1e-6


def test_tree_flatten_is_jax_order():
    tree = {"b": 1, "a": {"y": 2, "x": [3, (4, 5)], "w": None}, "c": ()}
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree) == [3, 4, 5, 2, 1]
    from repro_torch.core.tree import tree_map, tree_unflatten

    back = tree_unflatten(treedef, leaves)
    assert back == tree and list(back) == ["b", "a", "c"]
    assert tree_map(lambda x, y: x + y, tree, tree)["a"]["x"] == [6, (8, 10)]
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(treedef, leaves + [6])


def test_tree_functions_hold_no_leaf_after_return():
    """Flattening, mapping and rebuilding a tree leave no reference cycle
    behind: with the cyclic collector off, every leaf tensor is freed as
    soon as the caller drops it (recursive closures once kept each leaf
    they visited alive until a collection: GBs of gradients on the card
    after a training step, enough to run a full-width step out of
    memory)."""
    import gc
    import weakref

    from repro_torch.core.tree import tree_map, tree_unflatten

    gc.collect()
    gc.disable()
    try:
        tree = {"b": torch.ones(3), "a": {"x": [torch.ones(2)],
                                          "y": (torch.zeros(1), None)}}
        leaves, treedef = tree_flatten(tree)
        mapped = tree_map(lambda x: x * 2, tree)
        rebuilt = tree_unflatten(treedef, [x + 1 for x in leaves])
        refs = [weakref.ref(x) for x in
                leaves + tree_leaves(mapped) + tree_leaves(rebuilt)]
        del tree, leaves, treedef, mapped, rebuilt
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# --------------------------------------------------------------------------
# engine parity: the transport loop against the port's run_mc
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def quad():
    rs = np.random.default_rng(0)
    n, d = 6, 9
    X = rs.normal(size=(n, d)).astype(np.float32)
    theta_star = rs.normal(size=(d,)).astype(np.float32)
    y = X @ theta_star
    return quadratic_mc_problem(X, y, 0.1, theta_star, device="cpu"), n, d


@pytest.mark.parametrize("algo", sorted(ALGO_SETUPS))
def test_transport_loop_matches_run_mc(quad, algo):
    """A GD loop over `transport.aggregate` (gradients at the nesterov
    lookahead, theta <- theta - beta * update, the engine's slot keys
    through `mc_steps`) reproduces the port's `run_mc` risk and
    cumulative-energy curves at the reference's bars (rtol 1e-4 + atol
    5e-6; energy rtol 1e-4)."""
    prob, n, d = quad
    ch = port_channel(_chan(noise_std=0.4, phase_error_max=0.25))
    steps, beta, seed = 12, 0.05, 7
    mkw, tkw = ALGO_SETUPS[algo]
    res = engine.run_mc(prob, [ch], algo, [beta], steps, 1, seed0=seed,
                        device="cpu", **mkw)
    curve = np.asarray(res.risks)[0, 0]
    cum_e = np.asarray(res.cum_energy)[0, 0]

    cfg = transport.TransportConfig(n_nodes=n, channel=ch, mc_steps=steps,
                                    stepsize=beta, **tkw)
    base = rng.key(seed)
    theta = torch.zeros((d,), dtype=torch.float32)
    state = transport.init_state(algo, theta, cfg) \
        if transport.has_state(algo) else None
    H, ts = prob.data["H"], prob.data["theta_star"]
    X, y = prob.data["X"], prob.data["y"]
    risks, energies = [], []
    for k in range(steps):
        th = transport.lookahead_params(algo, theta, state, cfg)
        g = (X @ th - y)[:, None] * X + 0.1 * th[None, :]
        diff = theta - ts
        risks.append(float(0.5 * diff @ (H @ diff)))
        u, state, aux = transport.aggregate(
            algo, g, transport.step_key(base, k, mc_steps=steps), cfg, state)
        energies.append(float(aux["tx_energy"]))
        theta = theta - beta * u
    diff = theta - ts
    risks.append(float(0.5 * diff @ (H @ diff)))
    np.testing.assert_allclose(np.asarray(risks, np.float32), curve,
                               rtol=1e-4, atol=5e-6)
    np.testing.assert_allclose(np.cumsum(energies), cum_e, rtol=1e-4)
