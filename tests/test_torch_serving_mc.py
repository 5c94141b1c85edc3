"""The port's MC sweep server (`repro_torch.serving.mc_server`) on the CPU.

Part 1 holds the port to the reference's own serving cases
(`tests/test_serving_mc.py`, the same names and assertions), driven by
the port's deterministic harness (`tests/test_torch_helpers.py`:
`ManualClock`, `TracingExecutor`, `ScriptedClient`, `submit_all`,
`run`): coalescing to one program shape per signature (`trace_count()`,
the port's counterpart of a compile) with each demuxed result within
1e-6 of a solo port `run_mc`; signature-distinct requests never merged;
seed-quantum round robin; cancellation, admission, malformed payloads,
engine failures; N-buckets, the merge decision and the measured layout
loop; the router loop; deadlines, quarantine and retry. The property
tests run as fixed parametrized examples.

Part 2 holds the port's server to the reference's `McSweepServer` on the
same requests (JAX inside `jax_original_layout()`), both with the
inline executor and the analytic cost model: the same batches (signature
groups, rows, layouts, buckets, pad ratios), `ServeStats` counters and
`trace_count()`, each request's mean and ci95 within the engine bars of
`tests/test_torch_engine.py` (rtol 1e-5; ci95 at F3's), and a deadline's
`PartialResult` with the same completed seeds and values. One case shows
the port splitting, and rejecting, by its draw scratch what the
reference admits, with both prices asserted.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.mc import (MCProblem, MCProblemBatch,  # noqa: E402
                                 clear_cache, logistic_mc_problem,
                                 quadratic_mc_problem, run_mc, trace_count)
from repro_torch.core.mc.costmodel import (CostModel,  # noqa: E402
                                           analytic_cost_model)
from repro_torch.core.mc.plan import RetryPolicy  # noqa: E402
from repro_torch.serving.mc_server import (AdmissionError,  # noqa: E402
                                           InlineExecutor, McServeConfig,
                                           McSweepServer, PartialResult,
                                           QuarantinedError, RequestError,
                                           ServeError, SweepRequest,
                                           serve_sync)
from tests.test_torch_helpers import (ClockJump, FlakyOnce,  # noqa: E402
                                      ManualClock, ScriptedClient,
                                      TracingExecutor, jax_original_layout,
                                      port_channel, port_problem, run,
                                      submit_all)

STEPS, SEEDS, DIM = 6, 4, 3


# --------------------------------------------------------------------------
# request builders
# --------------------------------------------------------------------------
def _quad_arrays(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    return x, y


def _quad(n: int, seed: int = 0):
    x, y = _quad_arrays(n, seed)
    return quadratic_mc_problem(x, y, 0.1, np.zeros(DIM, np.float32),
                                device="cpu")


def _logistic_arrays(n: int, seed: int = 0, k: int = 4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n * k, DIM))
    y = np.sign(rng.normal(size=(n * k,))) + (rng.normal(size=(n * k,)) == 0)
    return x, y


def _logistic(n: int, seed: int = 0, k: int = 4):
    x, y = _logistic_arrays(n, seed, k)
    return logistic_mc_problem(x, y, n, 0.1, device="cpu")


def _req(n=8, noise=0.5, beta=0.08, *, kind="quadratic", algo="gbma",
         fading="rayleigh", steps=STEPS, seeds=SEEDS, seed0=0,
         batch_frac=1.0, n_antennas=None, data_seed=0, **kw):
    prob = _quad(n, data_seed) if kind == "quadratic" \
        else _logistic(n, data_seed)
    return SweepRequest(
        problem=prob, channels=[ChannelConfig(fading=fading,
                                              noise_std=noise)],
        algo=algo, betas=[beta], steps=steps, seeds=seeds, seed0=seed0,
        batch_frac=batch_frac, n_antennas=n_antennas, **kw)


def _solo(req: SweepRequest):
    """Dedicated-call reference on the same row-based engine path."""
    probs = list(req.problem) if isinstance(req.problem, (list, tuple)) \
        else [req.problem] * len(req.channels)
    return run_mc(MCProblemBatch.stack(probs), req.channels, req.algo,
                  req.betas, req.steps, req.seeds, seed0=req.seed0,
                  batch_frac=req.batch_frac, n_antennas=req.n_antennas,
                  power_budget=req.power_budget, momentum=req.momentum,
                  theta0=req.theta0, shard_seeds=False, device="cpu")


def _assert_matches_solo(res, req, tol=1e-6):
    solo = _solo(req)
    np.testing.assert_allclose(res.risks, solo.risks, rtol=tol, atol=tol)
    np.testing.assert_allclose(res.mean, solo.mean, rtol=tol, atol=tol)
    np.testing.assert_allclose(res.ci95, solo.ci95, rtol=tol, atol=tol)
    np.testing.assert_allclose(res.cum_energy, solo.cum_energy,
                               rtol=tol, atol=tol)


def _server(cfg=McServeConfig(), **kw) -> McSweepServer:
    return McSweepServer(cfg, device="cpu", **kw)


def _sync(reqs, cfg=None, server=None) -> list:
    return serve_sync(reqs, cfg, server=server, device="cpu")


def _sig(req) -> str:
    return _server()._normalize(req).signature


# --------------------------------------------------------------------------
# Part 1: the reference's cases — coalescing correctness
# --------------------------------------------------------------------------
def test_compatible_requests_coalesce_to_one_compile_and_demux():
    """Three requests differing only in row data (N, noise, stepsize) are
    one batch, one program shape, and each client's slice matches its
    dedicated solo run."""
    reqs = [_req(6, 0.5, 0.08, data_seed=0),
            _req(12, 1.0, 0.05, data_seed=1),
            _req(9, 0.1, 0.10, data_seed=2)]
    assert len({_sig(r) for r in reqs}) == 1
    clear_cache()
    results = _sync(reqs, McServeConfig(quantum_seeds=SEEDS))
    assert trace_count() == 1
    stats = serve_sync.last_stats
    assert [b["requests"] for b in stats.batches] == [3]
    assert stats.batches[0]["rows"] == 3
    for res, req in zip(results, reqs):
        assert res.risks.shape == (1, SEEDS, STEPS + 1)
        _assert_matches_solo(res, req)


def test_one_compile_per_distinct_signature():
    """Five mixed requests spanning three static signatures (steps, algo)
    run exactly three program shapes."""
    reqs = [
        _req(6, 0.5, 0.08, data_seed=0),
        _req(10, 1.0, 0.05, data_seed=1),
        _req(8, 0.3, 0.08, algo="momentum", data_seed=2),
        _req(8, 0.5, 0.08, steps=STEPS + 4, data_seed=3),
        _req(7, 0.2, 0.06, data_seed=4),
    ]
    assert len({_sig(r) for r in reqs}) == 3
    clear_cache()
    _sync(reqs, McServeConfig(quantum_seeds=SEEDS))
    assert trace_count() == 3
    stats = serve_sync.last_stats
    assert sorted(b["requests"] for b in stats.batches) == [1, 1, 3]


COALESCE_EXAMPLES = [("quadratic", 6, 10, "gbma", "rayleigh", False),
                     ("logistic", 10, 6, "momentum", "equal", True),
                     ("logistic", 6, 6, "gbma", "rayleigh", False),
                     ("quadratic", 10, 10, "momentum", "equal", True)]


@pytest.mark.parametrize("kind,n_a,n_b,algo,fading,minibatch",
                         COALESCE_EXAMPLES)
def test_property_coalescing_equivalence(kind, n_a, n_b, algo, fading,
                                         minibatch):
    """Any two compatible requests (same problem kind, algo, fading,
    steps, seeds, batch_frac mode; any N mix) coalesce into one batch
    whose demuxed curves match solo runs <= 1e-6; a request whose
    signature differs (longer horizon) is never merged with them."""
    frac = 0.5 if (minibatch and kind == "logistic") else 1.0
    a = _req(n_a, 0.5, 0.08, kind=kind, algo=algo, fading=fading,
             batch_frac=frac, data_seed=0)
    b = _req(n_b, 1.0, 0.05, kind=kind, algo=algo, fading=fading,
             batch_frac=frac, data_seed=1)
    other = _req(n_a, 0.5, 0.08, kind=kind, algo=algo, fading=fading,
                 batch_frac=frac, steps=STEPS + 4, data_seed=2)
    assert _sig(a) == _sig(b) != _sig(other)
    results = _sync([a, b, other], McServeConfig(quantum_seeds=SEEDS))
    stats = serve_sync.last_stats
    assert [b_["requests"] for b_ in stats.batches] == [2, 1]
    assert stats.batches[0]["rows"] == 2
    for res, req in zip(results, [a, b, other]):
        _assert_matches_solo(res, req)


def test_full_batch_never_merges_with_minibatch():
    """batch_frac=1.0 rides the exact no-sampling path, so the stochastic
    mode is a signature facet."""
    exact = _req(6, kind="logistic", batch_frac=1.0)
    mini = _req(6, kind="logistic", batch_frac=0.5)
    assert _sig(exact) != _sig(mini)
    _sync([exact, mini], McServeConfig(quantum_seeds=SEEDS))
    assert [b["requests"] for b in serve_sync.last_stats.batches] == [1, 1]


def test_multi_row_requests_and_antenna_rows_coalesce():
    """Requests carrying several rows each and per-row antenna counts
    still pack into one batch and demux whole."""
    a = SweepRequest(problem=_quad(6, 0), algo="gbma",
                     channels=[ChannelConfig(noise_std=0.5),
                               ChannelConfig(noise_std=1.0)],
                     betas=[0.08, 0.05], steps=STEPS, seeds=SEEDS,
                     n_antennas=[1, 4])
    b = SweepRequest(problem=_quad(9, 1), algo="gbma",
                     channels=[ChannelConfig(noise_std=0.2)],
                     betas=[0.1], steps=STEPS, seeds=SEEDS,
                     n_antennas=2)
    assert _sig(a) == _sig(b)
    results = _sync([a, b], McServeConfig(quantum_seeds=SEEDS))
    stats = serve_sync.last_stats
    assert [s["requests"] for s in stats.batches] == [2]
    assert stats.batches[0]["rows"] == 3
    assert results[0].risks.shape == (2, SEEDS, STEPS + 1)
    assert results[1].risks.shape == (1, SEEDS, STEPS + 1)
    for res, req in zip(results, [a, b]):
        _assert_matches_solo(res, req)


def test_row_cap_splits_batches_of_one_signature():
    reqs = [_req(6, 0.1 * (i + 1), data_seed=i) for i in range(4)]
    _sync(reqs, McServeConfig(quantum_seeds=SEEDS, max_batch_rows=3))
    stats = serve_sync.last_stats
    assert [b["requests"] for b in stats.batches] == [3, 1]


# --------------------------------------------------------------------------
# scheduling: seed-quantum preemption
# --------------------------------------------------------------------------
def test_whale_cannot_starve_minnows():
    """One 24-seed whale and two 6-seed minnows, quantum 6: the round
    robin runs the whale's first quantum, then lets each minnow finish
    before the whale's remaining quanta."""
    whale = _req(6, 0.5, seeds=24, data_seed=0)
    m1 = _req(6, 1.0, seeds=6, data_seed=1)
    m2 = _req(6, 0.3, seeds=6, seed0=100, data_seed=2)
    s_w, s_1, s_2 = (_sig(r)[:12] for r in (whale, m1, m2))
    assert len({s_w, s_1, s_2}) == 3
    ex = TracingExecutor()
    srv = _server(McServeConfig(quantum_seeds=6), executor=ex)

    async def inner():
        tasks = await submit_all(srv, [whale, m1, m2])
        await srv.drain()
        return await asyncio.gather(*tasks)

    res_w, res_1, res_2 = run(inner())
    assert [c["signature"] for c in ex.calls] == \
        [s_w, s_1, s_2, s_w, s_w, s_w]
    assert [c["off"] for c in ex.calls] == [0, 0, 0, 6, 12, 18]
    assert [b["signature"] for b in srv.stats.batches] == [s_1, s_2, s_w]
    for res, req in ((res_w, whale), (res_1, m1), (res_2, m2)):
        _assert_matches_solo(res, req)


def test_ragged_final_quantum_completes_exactly():
    """A seed count that is not a multiple of the quantum: the tail
    quantum is smaller, and the stitched curves still match solo."""
    req = _req(6, 0.5, seeds=10, data_seed=0)
    ex = TracingExecutor()
    srv = _server(McServeConfig(quantum_seeds=4), executor=ex)

    async def inner():
        (task,) = await submit_all(srv, [req])
        await srv.drain()
        return await task

    res = run(inner())
    assert [c["quantum"] for c in ex.calls] == [4, 4, 2]
    _assert_matches_solo(res, req)


# --------------------------------------------------------------------------
# fault injection
# --------------------------------------------------------------------------
def test_cancel_mid_batch_batchmates_unaffected():
    """A client cancelling after the batch's first quantum detaches; the
    batch completes and the other clients' slices match their solos."""
    reqs = [_req(6, 0.5, seeds=8, data_seed=0),
            _req(9, 1.0, seeds=8, data_seed=1),
            _req(7, 0.2, seeds=8, data_seed=2)]
    ex = TracingExecutor()
    srv = _server(McServeConfig(quantum_seeds=4), executor=ex)

    async def inner():
        clients = [ScriptedClient(srv, r).submit() for r in reqs]
        await asyncio.sleep(0)
        ex.after_call(0, clients[1].cancel)
        await srv.drain()
        await asyncio.gather(*(c.task for c in clients),
                             return_exceptions=True)
        return clients

    clients = run(inner())
    assert len(ex.calls) == 2
    assert clients[1].task.cancelled()
    assert srv.stats.cancelled == 1
    assert srv.stats.batches[0]["requests"] == 3
    assert srv.stats.batches[0]["cancelled"] == 1
    for i in (0, 2):
        _assert_matches_solo(clients[i].result(), reqs[i])


def test_cancel_all_drops_remaining_quanta():
    """When every client of a batch cancels, its remaining quanta are
    dropped."""
    reqs = [_req(6, 0.5, seeds=8, data_seed=0),
            _req(9, 1.0, seeds=8, data_seed=1)]
    ex = TracingExecutor()
    srv = _server(McServeConfig(quantum_seeds=4), executor=ex)

    async def inner():
        clients = [ScriptedClient(srv, r).submit() for r in reqs]
        await asyncio.sleep(0)
        ex.after_call(0, clients[0].cancel)
        ex.after_call(0, clients[1].cancel)
        await srv.drain()
        await asyncio.gather(*(c.task for c in clients),
                             return_exceptions=True)

    run(inner())
    assert len(ex.calls) == 1
    assert srv.stats.cancelled == 2
    assert srv.stats.batches == []


def test_over_budget_request_rejected_small_one_served():
    """Admission: an over-budget request gets a typed AdmissionError at
    submit, and an affordable one submitted right after is served."""
    small = _req(6, 0.5, data_seed=0)
    big = SweepRequest(problem=_quad(64, 1),
                       channels=[ChannelConfig(noise_std=0.5)] * 8,
                       algo="gbma", betas=[0.05] * 8, steps=STEPS,
                       seeds=256)
    probe = _server(McServeConfig(quantum_seeds=SEEDS))
    est_small = probe._estimate([probe._normalize(small)])
    est_big = probe._estimate([probe._normalize(big)])
    budget = (est_small + est_big) // 2
    assert est_small < budget < est_big
    srv = _server(McServeConfig(quantum_seeds=SEEDS,
                                memory_budget_bytes=budget))

    async def inner():
        with pytest.raises(AdmissionError, match="estimate_peak_bytes"):
            await srv.submit(big)
        task = asyncio.ensure_future(srv.submit(small))
        await asyncio.sleep(0)
        await srv.drain()
        return await task

    res = run(inner())
    assert srv.stats.rejected == 1 and srv.stats.admitted == 1
    _assert_matches_solo(res, small)


def test_budget_splits_batches_instead_of_rejecting():
    """Two affordable requests that do not fit one batch together run as
    two batches of the same signature, both served."""
    reqs = [_req(6, 0.5, data_seed=0), _req(6, 1.0, data_seed=1)]
    probe = _server(McServeConfig(quantum_seeds=SEEDS))
    est_one = probe._estimate([probe._normalize(reqs[0])])
    est_two = probe._estimate([probe._normalize(r) for r in reqs])
    budget = (est_one + est_two) // 2
    assert est_one < budget < est_two
    results = _sync(reqs, McServeConfig(quantum_seeds=SEEDS,
                                        memory_budget_bytes=budget))
    stats = serve_sync.last_stats
    assert [b["requests"] for b in stats.batches] == [1, 1]
    for res, req in zip(results, reqs):
        _assert_matches_solo(res, req)


@pytest.mark.parametrize("mutation, match", [
    (dict(algo="warp"), "unknown algo"),
    (dict(betas=[0.1, 0.2]), "one stepsize per row"),
    (dict(algo="blind"), "needs n_antennas"),
    (dict(batch_frac=0.0), "batch_frac"),
    (dict(batch_frac=0.5), "stochastic"),  # quadratic has no minibatch
    (dict(steps=0), "steps"),
    (dict(channels=[]), "no rows"),
    (dict(theta0=np.zeros(7, np.float32)), "theta0 shape"),
])
def test_malformed_requests_fail_fast(mutation, match):
    """Malformed payloads raise RequestError at submit — before the queue
    — and a valid request afterwards is served normally."""
    base = dict(problem=_quad(6, 0),
                channels=[ChannelConfig(noise_std=0.5)], algo="gbma",
                betas=[0.08], steps=STEPS, seeds=SEEDS)
    bad = SweepRequest(**{**base, **mutation})
    srv = _server(McServeConfig(quantum_seeds=SEEDS))

    async def inner():
        with pytest.raises(RequestError, match=match):
            await srv.submit(bad)
        assert srv._queue == []  # never enqueued
        task = asyncio.ensure_future(srv.submit(SweepRequest(**base)))
        await asyncio.sleep(0)
        await srv.drain()
        return await task

    res = run(inner())
    assert srv.stats.admitted == 1
    assert res.risks.shape == (1, SEEDS, STEPS + 1)


def test_unregistered_problem_rejected():
    """A problem of a kind nobody registered cannot batch with strangers'
    rows; the server refuses it up front."""
    prob = MCProblem(kind="svm", data={}, n_nodes=4, dim=DIM)
    req = SweepRequest(problem=prob, channels=[ChannelConfig()],
                       algo="gbma", betas=[0.08], steps=STEPS,
                       seeds=SEEDS)

    async def inner():
        with pytest.raises(RequestError, match="registered"):
            await _server().submit(req)

    run(inner())


def test_engine_failure_contained_to_its_batch():
    """A quantum blowing up resolves only its own batch's futures with a
    ServeError; the other signature's batch completes untouched."""
    pair = [_req(6, 0.5, data_seed=0), _req(9, 1.0, data_seed=1)]
    lone = _req(6, 0.5, steps=STEPS + 4, data_seed=2)
    ex = TracingExecutor()
    ex.fail_when(lambda info: info["rows"] == 2, RuntimeError("boom"))
    srv = _server(McServeConfig(quantum_seeds=SEEDS), executor=ex)

    async def inner():
        tasks = await submit_all(srv, pair + [lone])
        await srv.drain()
        return await asyncio.gather(*tasks, return_exceptions=True)

    out = run(inner())
    assert all(isinstance(e, ServeError) for e in out[:2])
    assert all("boom" in str(e) for e in out[:2])
    assert srv.stats.failed_batches == 1
    assert [b["requests"] for b in srv.stats.batches] == [1]
    _assert_matches_solo(out[2], lone)


# --------------------------------------------------------------------------
# pad-waste-aware bucketing
# --------------------------------------------------------------------------
def _cost_model(dispatch_us=0.0, compile_s=0.0, c0=0.0, c1=1.0):
    """A synthetic routing model: compute = c0 + c1 * slot_flops, with
    dispatch/first-sight charges the test controls exactly."""
    return CostModel(coeffs=(("blind", c0, c1), ("gbma", c0, c1)),
                     dispatch_us=dispatch_us, compile_s=compile_s,
                     chunk_profile=(),
                     peaks=(("peak_gflops", 1.0), ("peak_gibs", 1.0)),
                     source="measured")


def test_bucket_shape_classes():
    srv = _server()
    assert [srv._bucket(n) for n in (1, 2, 3, 5, 8, 12, 17)] == \
        [1, 2, 4, 8, 8, 16, 32]
    assert srv._bucketing
    assert not _server(McServeConfig(bucket_base=0))._bucketing
    assert not _server(McServeConfig(bucket_base=1.0))._bucketing


def test_pad_ratio_and_occupancy_recorded_on_merge():
    """A cross-bucket group on a fresh server merges (first sights
    dominate) and the batch entry records exactly the pad tax it paid."""
    reqs = [_req(6, 0.5, data_seed=0), _req(12, 1.0, data_seed=1)]
    srv = _server(McServeConfig(quantum_seeds=SEEDS),
                  executor=InlineExecutor(),
                  cost_model=_cost_model(compile_s=10.0))
    results = _sync(reqs, server=srv)
    assert [b["requests"] for b in srv.stats.batches] == [2]
    batch = srv.stats.batches[0]
    assert batch["n_max"] == 12 and batch["bucket"] == 16
    assert batch["pad_flops_ratio"] == round(2 * 12 / 18, 4)
    assert srv.stats.bucket_occupancy == {8: 1, 16: 1}
    for res, req in zip(results, reqs):
        _assert_matches_solo(res, req)


def test_bucketing_disabled_is_the_monolithic_router():
    """bucket_base <= 1: every signature group merges, nothing is
    bucketed or recorded."""
    reqs = [_req(3, 0.5, data_seed=0), _req(24, 1.0, data_seed=1)]
    srv = _server(McServeConfig(quantum_seeds=SEEDS, bucket_base=0),
                  executor=InlineExecutor(), cost_model=_cost_model())
    _sync(reqs, server=srv)
    assert [b["requests"] for b in srv.stats.batches] == [2]
    assert srv.stats.batches[0]["bucket"] == 0
    assert srv.stats.bucket_occupancy == {}


def test_first_sight_merges_then_steady_state_splits():
    """Round 1 merges the cross-bucket group (two unseen shape classes
    vs one), round 2 splits it (pad waste is the only term), and
    `clear_cache()` forgets the registry so round 3 merges again."""
    mk = lambda: [_req(4, 0.5, data_seed=0), _req(24, 1.0, data_seed=1)]
    ex = TracingExecutor()
    srv = _server(McServeConfig(quantum_seeds=SEEDS), executor=ex,
                  cost_model=_cost_model(compile_s=10.0))

    def round_():
        reqs = mk()

        async def inner():
            tasks = await submit_all(srv, reqs)
            await srv.drain()
            return await asyncio.gather(*tasks)

        results = run(inner())
        for res, req in zip(results, reqs):
            _assert_matches_solo(res, req)

    round_()
    assert [b["requests"] for b in srv.stats.batches] == [2]
    round_()
    assert [b["requests"] for b in srv.stats.batches] == [2, 1, 1]
    assert [c["rows"] for c in ex.calls] == [2, 1, 1]
    assert [b["pad_flops_ratio"] for b in srv.stats.batches[1:]] == \
        [1.0, 1.0]
    clear_cache()  # bumps exec.cache_epoch() -> the registry resets
    round_()
    assert [b["requests"] for b in srv.stats.batches] == [2, 1, 1, 2]


def test_layout_loop_explores_then_exploits_measured_winner():
    """First sight merges, the warm `merged` and `exact` layouts are each
    explored once (first-sight rounds are no observations), and steady
    state exploits the cheaper µs per node (injected here)."""
    clear_cache()
    reqs = lambda: [_req(20, 0.5, data_seed=0), _req(28, 1.0, data_seed=1)]
    srv = _server(McServeConfig(quantum_seeds=SEEDS),
                  executor=InlineExecutor(),
                  cost_model=_cost_model(compile_s=10.0))
    key = (_sig(reqs()[0]), srv._bucket(28))

    def round_():
        rs = reqs()
        for res, req in zip(_sync(rs, server=srv), rs):
            _assert_matches_solo(res, req)
        return [b["requests"] for b in srv.stats.batches]

    assert round_() == [2]
    assert srv._layout_obs == {}
    assert round_() == [2, 2]
    assert list(srv._layout_obs[key]) == ["merged"]
    # the exact layout's rows=1 shapes already ran (the solo checks), so
    # the round is warm and its observation lands
    assert round_() == [2, 2, 1, 1]
    assert sorted(srv._layout_obs[key]) == ["exact", "merged"]
    assert srv.stats.layouts == {
        f"{key[0][:12]}/{key[1]}": {
            k: round(v[0] / v[1], 2)
            for k, v in srv._layout_obs[key].items()}}
    srv._layout_obs[key] = {"merged": [1.0, 100], "exact": [9.0, 100]}
    assert round_()[-1:] == [2]
    assert srv.stats.batches[-1]["layout"] == "merged"
    srv._layout_obs[key] = {"merged": [9.0, 100], "exact": [1.0, 100]}
    assert round_()[-2:] == [1, 1]
    assert [b["layout"] for b in srv.stats.batches[-2:]] == \
        ["exact", "exact"]
    assert [b["pad_flops_ratio"] for b in srv.stats.batches[-2:]] == \
        [1.0, 1.0]


def test_measure_layouts_off_is_the_purely_predicted_router():
    """measure_layouts=False keeps within-bucket groups merged and tags
    nothing."""
    mk = lambda: [_req(20, 0.5, data_seed=0), _req(28, 1.0, data_seed=1)]
    srv = _server(McServeConfig(quantum_seeds=SEEDS, measure_layouts=False),
                  executor=InlineExecutor(),
                  cost_model=_cost_model(compile_s=10.0))
    for _ in range(3):
        _sync(mk(), server=srv)
    assert [b["requests"] for b in srv.stats.batches] == [2, 2, 2]
    assert all(b["layout"] is None for b in srv.stats.batches)
    assert srv._layout_obs == {}


def test_stack_cache_reuses_padded_packs(monkeypatch):
    """A persistent server re-serving the same problem objects pads and
    stacks them once; later rounds reuse the cached pack."""
    from repro_torch.serving import mc_server as srv_mod

    calls = []
    orig = MCProblemBatch.stack
    monkeypatch.setattr(
        srv_mod.MCProblemBatch, "stack",
        classmethod(lambda cls, probs: (calls.append(1), orig(probs))[1]))
    req = _req(9, 0.5, data_seed=3)
    srv = _server(McServeConfig(quantum_seeds=SEEDS),
                  executor=InlineExecutor())
    _sync([req], server=srv)
    first_round = len(calls)
    assert first_round >= 1
    res2 = _sync([req], server=srv)[0]
    assert len(calls) == first_round  # cache hit: no re-stack
    monkeypatch.undo()
    _assert_matches_solo(res2, req)


BUCKET_EXAMPLES = [("quadratic", "gbma", 3, 24, False),
                   ("logistic", "momentum", 5, 40, True),
                   ("logistic", "gbma", 3, 40, False),
                   ("quadratic", "momentum", 5, 24, True)]


@pytest.mark.parametrize("kind,algo,n_small,n_big,minibatch",
                         BUCKET_EXAMPLES)
def test_property_bucketed_split_demux_matches_solo(kind, algo, n_small,
                                                    n_big, minibatch):
    """Whatever the routing decides, the numbers are invisible: a
    zero-first-sight model splits the N-spread pair, and each batch's
    demux still matches a dedicated solo run <= 1e-6."""
    frac = 0.5 if (minibatch and kind == "logistic") else 1.0
    a = _req(n_small, 0.5, 0.08, kind=kind, algo=algo, batch_frac=frac,
             data_seed=0)
    b = _req(n_big, 1.0, 0.05, kind=kind, algo=algo, batch_frac=frac,
             data_seed=1)
    assert _sig(a) == _sig(b)
    srv = _server(McServeConfig(quantum_seeds=SEEDS),
                  executor=InlineExecutor(), cost_model=_cost_model())
    results = _sync([a, b], server=srv)
    assert [s["requests"] for s in srv.stats.batches] == [1, 1]
    assert all(s["pad_flops_ratio"] == 1.0 for s in srv.stats.batches)
    assert set(srv.stats.bucket_occupancy) == \
        {srv._bucket(n_small), srv._bucket(n_big)}
    for res, req in zip(results, [a, b]):
        _assert_matches_solo(res, req)


# --------------------------------------------------------------------------
# the router loop under the manual clock
# --------------------------------------------------------------------------
def test_serve_forever_holds_coalesce_window_without_wall_sleeps():
    """start()/stop() under the manual clock: the router wakes on the
    first submission, holds the coalesce window (a virtual 2.5 s), then
    drains both requests as one batch."""
    reqs = [_req(6, 0.5, data_seed=0), _req(9, 1.0, data_seed=1)]
    clock, ex = ManualClock(), TracingExecutor()
    srv = _server(McServeConfig(quantum_seeds=SEEDS, coalesce_window=2.5),
                  clock=clock, executor=ex)

    async def inner():
        srv.start()
        results = await asyncio.gather(*(srv.submit(r) for r in reqs))
        await srv.stop()
        return results

    results = run(inner())
    assert clock.sleeps == [2.5]
    assert clock.now == 2.5
    assert [b["requests"] for b in srv.stats.batches] == [2]
    for res, req in zip(results, reqs):
        _assert_matches_solo(res, req)


def test_submissions_during_drain_are_picked_up():
    """A request submitted mid-drain is served in the same drain pass."""
    first = _req(6, 0.5, seeds=8, data_seed=0)
    late = _req(9, 1.0, seeds=8, data_seed=1)
    ex = TracingExecutor()
    srv = _server(McServeConfig(quantum_seeds=4), executor=ex)

    async def inner():
        (t1,) = await submit_all(srv, [first])
        holder = {}
        ex.after_call(0, lambda: holder.setdefault(
            "t2", asyncio.ensure_future(srv.submit(late))))
        await srv.drain()
        return await t1, await holder["t2"]

    r1, r2 = run(inner())
    assert len(srv.stats.batches) == 2
    _assert_matches_solo(r1, first)
    _assert_matches_solo(r2, late)


# --------------------------------------------------------------------------
# deadlines, quarantine, retry
# --------------------------------------------------------------------------
def _partial_ref(req, seeds_completed):
    """The same request truncated to the seeds completed at expiry."""
    return dataclasses.replace(req, seeds=seeds_completed, deadline_s=None)


def test_deadline_mid_run_resolves_partial_batchmates_unaffected():
    """A deadline expiring mid-run resolves that request with a
    PartialResult matching a dedicated run over the completed seeds;
    its batchmate runs to completion."""
    hurried = _req(6, 0.5, seeds=8, data_seed=0, deadline_s=5.0)
    patient = _req(9, 1.0, seeds=8, data_seed=1)
    clock = ManualClock()
    ex = TracingExecutor()
    ex.after_call(0, ClockJump(clock, 10.0))
    srv = _server(McServeConfig(quantum_seeds=4), executor=ex, clock=clock)

    async def inner():
        tasks = await submit_all(srv, [hurried, patient])
        await srv.drain()
        return await asyncio.gather(*tasks)

    part, full = run(inner())
    assert isinstance(part, PartialResult)
    assert part.seeds_completed == 4 and part.seeds_requested == 8
    _assert_matches_solo(part.result, _partial_ref(hurried, 4))
    _assert_matches_solo(full, patient)
    assert [c["off"] for c in ex.calls] == [0, 4]
    assert srv.stats.deadline_expired == 1
    assert srv.stats.cancelled == 0
    assert srv.stats.batches[0]["expired"] == 1


def test_deadline_expiring_before_any_quantum_yields_empty_partial():
    req = _req(6, 0.5, seeds=8, data_seed=0, deadline_s=1.0)
    clock = ManualClock()
    ex = TracingExecutor()
    srv = _server(McServeConfig(quantum_seeds=4), executor=ex, clock=clock)

    async def inner():
        (task,) = await submit_all(srv, [req])
        clock.now += 2.0
        await srv.drain()
        return await task

    part = run(inner())
    assert isinstance(part, PartialResult)
    assert part.result is None and part.seeds_completed == 0
    assert ex.calls == []
    assert srv.stats.cancelled == 0


def test_all_clients_expired_drops_remaining_quanta():
    reqs = [_req(6, 0.5, seeds=12, data_seed=0, deadline_s=5.0),
            _req(9, 1.0, seeds=12, data_seed=1, deadline_s=6.0)]
    clock = ManualClock()
    ex = TracingExecutor()
    ex.after_call(0, ClockJump(clock, 10.0))
    srv = _server(McServeConfig(quantum_seeds=4), executor=ex, clock=clock)

    async def inner():
        tasks = await submit_all(srv, reqs)
        await srv.drain()
        return await asyncio.gather(*tasks)

    p1, p2 = run(inner())
    assert len(ex.calls) == 1
    assert {p.seeds_completed for p in (p1, p2)} == {4}
    assert srv.stats.deadline_expired == 2
    assert srv.stats.cancelled == 0
    assert srv.stats.batches == []


@pytest.mark.parametrize("jump_after,quantum", [(0, 2), (1, 2), (0, 4),
                                                (1, 4)])
def test_deadline_expiry_never_blocks_batchmates(jump_after, quantum):
    """Wherever the deadline lands in the quantum schedule, the expired
    request gets a well-formed PartialResult and the batchmate completes
    and matches its solo."""
    hurried = _req(6, 0.5, seeds=8, data_seed=0, deadline_s=3.0)
    patient = _req(9, 1.0, seeds=8, data_seed=1)
    clock = ManualClock()
    ex = TracingExecutor()
    ex.after_call(jump_after, ClockJump(clock, 10.0))
    srv = _server(McServeConfig(quantum_seeds=quantum), executor=ex,
                  clock=clock)

    async def inner():
        tasks = await submit_all(srv, [hurried, patient])
        await srv.drain()
        return await asyncio.gather(*tasks)

    part, full = run(inner())
    assert isinstance(part, PartialResult)
    done = min((jump_after + 1) * quantum, 8)
    assert part.seeds_completed == done and part.seeds_requested == 8
    if done:
        _assert_matches_solo(part.result, _partial_ref(hurried, done))
    _assert_matches_solo(full, patient)


def test_hung_engine_call_quarantines_the_signature():
    """An engine call exceeding hang_threshold_s (on the injected clock)
    fails its batch with QuarantinedError; later same-signature submits
    are rejected with the original cause; other signatures run."""
    hung = _req(6, 0.5, seeds=SEEDS, data_seed=0)
    other = _req(6, 0.5, steps=STEPS + 4, data_seed=1)
    assert _sig(hung) != _sig(other)
    clock = ManualClock()
    ex = TracingExecutor()
    ex.after_call(0, ClockJump(clock, 9.0))
    srv = _server(McServeConfig(quantum_seeds=SEEDS, hang_threshold_s=1.0),
                  executor=ex, clock=clock)

    async def inner():
        tasks = await submit_all(srv, [hung, other])
        await srv.drain()
        first = await asyncio.gather(*tasks, return_exceptions=True)
        try:
            await srv.submit(_req(6, 0.5, seeds=SEEDS, data_seed=5))
            resubmit = None
        except QuarantinedError as e:
            resubmit = e
        return first, resubmit

    (res_hung, res_other), resubmit = run(inner())
    assert isinstance(res_hung, QuarantinedError)
    assert "hang_threshold_s" in str(res_hung)
    _assert_matches_solo(res_other, other)
    assert isinstance(resubmit, QuarantinedError)
    assert "took 9.000s" in str(resubmit)
    assert srv.stats.quarantined == 1
    assert srv.stats.failed_batches == 0
    assert srv.stats.rejected == 1


def test_transient_engine_failure_retried_to_success():
    """cfg.retry: a quantum failing once is replayed under the policy's
    backoff (on the server clock) and matches the solo run exactly."""
    req = _req(6, 0.5, seeds=8, data_seed=0)
    clock = ManualClock()
    ex = TracingExecutor()
    ex.fail_when(FlakyOnce(lambda info: info["off"] == 4),
                 RuntimeError("transient device loss"))
    srv = _server(McServeConfig(quantum_seeds=4, retry=RetryPolicy(
        max_attempts=3, base_delay_s=0.5)), executor=ex, clock=clock)

    async def inner():
        (task,) = await submit_all(srv, [req])
        await srv.drain()
        return await task

    res = run(inner())
    _assert_matches_solo(res, req)
    assert [c["off"] for c in ex.calls] == [0, 4, 4]
    assert clock.sleeps == [0.5]
    assert srv.stats.retries == 1
    assert srv.stats.failed_batches == 0


def test_retry_budget_exhausted_routes_failure_to_clients():
    req = _req(6, 0.5, seeds=8, data_seed=0)
    clock = ManualClock()
    ex = TracingExecutor()
    ex.fail_when(lambda info: info["off"] == 0, RuntimeError("dead device"))
    srv = _server(McServeConfig(quantum_seeds=4, retry=RetryPolicy(
        max_attempts=2, base_delay_s=0.5)), executor=ex, clock=clock)

    async def inner():
        (task,) = await submit_all(srv, [req])
        await srv.drain()
        return await asyncio.gather(task, return_exceptions=True)

    (err,) = run(inner())
    assert isinstance(err, ServeError)
    assert "dead device" in str(err)
    assert srv.stats.retries == 1
    assert srv.stats.failed_batches == 1


def test_deadline_validation_and_config_default():
    srv = _server()
    with pytest.raises(RequestError, match="deadline_s"):
        srv._normalize(_req(6, 0.5, deadline_s=0.0))
    with pytest.raises(RequestError, match="deadline_s"):
        srv._normalize(_req(6, 0.5, deadline_s=-1.0))

    req = _req(6, 0.5, seeds=8, data_seed=0)
    clock = ManualClock()
    ex = TracingExecutor()
    ex.after_call(0, ClockJump(clock, 10.0))
    srv = _server(McServeConfig(quantum_seeds=4, default_deadline_s=5.0),
                  executor=ex, clock=clock)

    async def inner():
        (task,) = await submit_all(srv, [req])
        await srv.drain()
        return await task

    part = run(inner())
    assert isinstance(part, PartialResult)
    assert part.seeds_completed == 4
    assert srv._normalize(_req(6, 0.5, deadline_s=42.0)).deadline_s == 42.0


# --------------------------------------------------------------------------
# Part 2: parity with the reference's server
# --------------------------------------------------------------------------
def _jax_pair(spec):
    """(reference request, port request) on the same data arrays.
    spec: dict(n, noise, beta, kind, algo, steps, seeds, seed0, frac,
    data_seed, deadline_s)."""
    from repro.core.channel import ChannelConfig as JChannel
    from repro.core.mc import logistic_mc_problem as jlogistic
    from repro.core.mc import quadratic_mc_problem as jquad
    from repro.serving.mc_server import SweepRequest as JRequest

    n, kind = spec["n"], spec.get("kind", "quadratic")
    if kind == "quadratic":
        x, y = _quad_arrays(n, spec.get("data_seed", 0))
        jp = jquad(x, y, 0.1, np.zeros(DIM, np.float32))
    else:
        x, y = _logistic_arrays(n, spec.get("data_seed", 0))
        jp = jlogistic(x, y, n, 0.1)
    ch = JChannel(fading=spec.get("fading", "rayleigh"),
                  noise_std=spec.get("noise", 0.5))
    kw = dict(algo=spec.get("algo", "gbma"), betas=[spec.get("beta", 0.08)],
              steps=spec.get("steps", STEPS), seeds=spec.get("seeds", SEEDS),
              seed0=spec.get("seed0", 0),
              batch_frac=spec.get("frac", 1.0),
              deadline_s=spec.get("deadline_s"))
    return (JRequest(problem=jp, channels=[ch], **kw),
            SweepRequest(problem=port_problem(jp), channels=[
                port_channel(ch)], **kw))


def _jax_server(cfg, **kw):
    from repro.core.mc.costmodel import analytic_cost_model as janalytic
    from repro.serving.mc_server import InlineExecutor as JInline
    from repro.serving.mc_server import McSweepServer as JServer

    kw.setdefault("executor", JInline())
    return JServer(cfg, cost_model=janalytic(), **kw)


def _port_server(cfg, **kw):
    kw.setdefault("executor", InlineExecutor())
    return _server(cfg, cost_model=analytic_cost_model(), **kw)


async def _drive(srv, reqs):
    tasks = [asyncio.ensure_future(srv.submit(r)) for r in reqs]
    await asyncio.sleep(0)
    await srv.drain()
    return await asyncio.gather(*tasks, return_exceptions=True)


_BATCH_KEYS = ("requests", "rows", "seeds", "quanta", "cancelled",
               "expired", "n_max", "bucket", "layout", "pad_flops_ratio")
_STAT_KEYS = ("admitted", "rejected", "cancelled", "failed_batches",
              "retries", "deadline_expired", "quarantined",
              "bucket_occupancy")


def _grouping(batches) -> list:
    """The batches' signatures as first-appearance indices: equal lists
    mean the same requests share signatures in both packages (the digests
    themselves differ: they hash each package's callables)."""
    seen = {}
    return [seen.setdefault(b["signature"], len(seen)) for b in batches]


def _assert_same_routing(ref_srv, port_srv):
    assert [{k: b[k] for k in _BATCH_KEYS} for b in port_srv.stats.batches] \
        == [{k: b[k] for k in _BATCH_KEYS} for b in ref_srv.stats.batches]
    assert _grouping(port_srv.stats.batches) == \
        _grouping(ref_srv.stats.batches)
    for key in _STAT_KEYS:
        assert getattr(port_srv.stats, key) == getattr(ref_srv.stats, key), \
            key


def _risk_atol(jreq) -> float:
    """The logistic floor of `tests/test_torch_engine.py`: 4 ulps of the
    f32 objective F* (ROADMAP §3, F8); 0 for the other kinds."""
    f_star = jreq.problem.data.get("f_star")
    return 0.0 if f_star is None \
        else 4 * float(np.spacing(np.float32(np.asarray(f_star))))


def _assert_engine_parity(out, ref, risk_atol: float = 0.0):
    """`tests/test_torch_engine.py`'s bars: mean and risks within rtol
    1e-5 (plus the logistic floor), ci95 within F3's rtol 1e-5 + atol
    1e-5·|mean|."""
    np.testing.assert_allclose(out.mean, ref.mean, rtol=1e-5,
                               atol=risk_atol)
    assert np.all(np.abs(np.asarray(out.ci95) - np.asarray(ref.ci95))
                  <= 1e-5 * np.abs(ref.ci95) + 1e-5 * np.abs(ref.mean)
                  + risk_atol)
    np.testing.assert_allclose(out.risks, ref.risks, rtol=1e-5,
                               atol=risk_atol)
    np.testing.assert_allclose(out.cum_energy, ref.cum_energy, rtol=1e-5,
                               atol=0)


MIX = [dict(n=6, noise=0.5, beta=0.08, data_seed=0),
       dict(n=12, noise=1.0, beta=0.05, data_seed=1),
       dict(n=9, noise=0.1, beta=0.10, data_seed=2),
       dict(n=24, noise=0.3, beta=0.06, data_seed=3),
       dict(n=8, noise=0.3, beta=0.08, algo="momentum", data_seed=4),
       dict(n=8, noise=0.5, beta=0.08, steps=STEPS + 4, data_seed=5),
       dict(n=6, kind="logistic", frac=0.5, data_seed=6),
       dict(n=10, kind="logistic", frac=0.5, noise=1.0, data_seed=7)]


@pytest.mark.parametrize("cfg", [
    McServeConfig(quantum_seeds=SEEDS),
    McServeConfig(quantum_seeds=2),
    McServeConfig(quantum_seeds=SEEDS, bucket_base=0),
    McServeConfig(quantum_seeds=SEEDS, max_batch_rows=2),
], ids=["buckets", "quanta-of-2", "monolithic", "row-cap"])
def test_same_batches_stats_and_values_as_the_reference(cfg):
    """The reference's server and the port's on the same eight requests
    (four signatures, N across three buckets, a minibatch pair), under
    the analytic cost model: the same batches, counters and program
    shapes run; each request within the engine bars of the reference's
    result."""
    from repro.core.mc import clear_cache as jclear
    from repro.core.mc import trace_count as jtrace

    pairs = [_jax_pair(s) for s in MIX]
    jreqs, preqs = [p[0] for p in pairs], [p[1] for p in pairs]
    jsrv, psrv = _jax_server(cfg), _port_server(cfg)
    with jax_original_layout():
        jclear()
        jout = run(_drive(jsrv, jreqs))
        jshapes = jtrace()
    clear_cache()
    pout = run(_drive(psrv, preqs))
    assert trace_count() == jshapes
    _assert_same_routing(jsrv, psrv)
    for out, ref, jreq in zip(pout, jout, jreqs):
        _assert_engine_parity(out, ref, _risk_atol(jreq))


def test_persistent_servers_route_rounds_alike():
    """Four rounds of a cross-bucket group on persistent servers: first
    sight merges, then the split, the layout loop's explorations — the
    same batches round by round in both packages (the rounds before any
    timing-dependent exploit)."""
    from repro.core.mc import clear_cache as jclear

    specs = [dict(n=20, noise=0.5, data_seed=0),
             dict(n=28, noise=1.0, data_seed=1),
             dict(n=6, noise=0.2, data_seed=2)]
    cfg = McServeConfig(quantum_seeds=SEEDS)
    jsrv, psrv = _jax_server(cfg), _port_server(cfg)
    with jax_original_layout():
        jclear()
    clear_cache()
    for _ in range(4):
        pairs = [_jax_pair(s) for s in specs]
        with jax_original_layout():
            jout = run(_drive(jsrv, [p[0] for p in pairs]))
        pout = run(_drive(psrv, [p[1] for p in pairs]))
        _assert_same_routing(jsrv, psrv)
        assert len(psrv._layout_obs) == len(jsrv._layout_obs)
        assert [sorted(v) for v in psrv._layout_obs.values()] == \
            [sorted(v) for v in jsrv._layout_obs.values()]
        for out, ref in zip(pout, jout):
            _assert_engine_parity(out, ref)


def test_deadline_partial_result_matches_the_reference():
    """A deadline expiring after the first quantum: both packages resolve
    it with a PartialResult over the same completed seeds, within the
    engine bars of each other; the batchmate completes in both."""
    specs = [dict(n=6, noise=0.5, seeds=8, data_seed=0, deadline_s=5.0),
             dict(n=9, noise=1.0, seeds=8, data_seed=1)]
    pairs = [_jax_pair(s) for s in specs]
    cfg = McServeConfig(quantum_seeds=4)

    def served(make, reqs, layout):
        clock, ex = ManualClock(), TracingExecutor()
        ex.after_call(0, ClockJump(clock, 10.0))
        srv = make(cfg, executor=ex, clock=clock)
        with layout():
            return srv, run(_drive(srv, reqs))

    jsrv, (jpart, jfull) = served(_jax_server, [p[0] for p in pairs],
                                  jax_original_layout)
    psrv, (ppart, pfull) = served(_port_server, [p[1] for p in pairs],
                                  contextlib.nullcontext)
    assert isinstance(ppart, PartialResult)
    assert type(jpart).__name__ == "PartialResult"
    assert (ppart.seeds_completed, ppart.seeds_requested) == \
        (jpart.seeds_completed, jpart.seeds_requested) == (4, 8)
    _assert_engine_parity(ppart.result, jpart.result)
    _assert_engine_parity(pfull, jfull)
    _assert_same_routing(jsrv, psrv)


def test_draw_scratch_splits_and_rejects_what_the_reference_admits():
    """R4: the port prices a quantum as `estimate_peak_bytes` +
    `draw_scratch_bytes`, the reference as the estimate alone. At a
    budget between the two prices of a pair, the reference packs the pair
    into one batch and the port splits it; at a budget between one
    request's two prices, the reference admits it and the port rejects
    it."""
    pairs = [_jax_pair(dict(n=64, noise=0.5, seeds=16, data_seed=0)),
             _jax_pair(dict(n=64, noise=1.0, seeds=16, data_seed=1))]
    cfg = McServeConfig(quantum_seeds=16)
    jsrv, psrv = _jax_server(cfg), _port_server(cfg)
    j_one = jsrv._estimate([jsrv._normalize(pairs[0][0])])
    j_two = jsrv._estimate([jsrv._normalize(p[0]) for p in pairs])
    est_one, scr_one = psrv._price([psrv._normalize(pairs[0][1])])
    est_two, scr_two = psrv._price([psrv._normalize(p[1]) for p in pairs])
    # the estimate term is the reference's, field for field
    assert (est_one, est_two) == (j_one, j_two)
    assert scr_one > 0 and scr_two > scr_one
    p_one, p_two = est_one + scr_one, est_two + scr_two

    # a budget the reference's pair fits and the port's does not, both
    # requests affordable alone in both
    budget = max(j_two, p_one) + 1
    assert p_one < budget < p_two and j_two < budget
    cfg = McServeConfig(quantum_seeds=16, memory_budget_bytes=budget)
    jsrv, psrv = _jax_server(cfg), _port_server(cfg)
    with jax_original_layout():
        jout = run(_drive(jsrv, [p[0] for p in pairs]))
    pout = run(_drive(psrv, [p[1] for p in pairs]))
    assert [b["requests"] for b in jsrv.stats.batches] == [2]
    assert [b["requests"] for b in psrv.stats.batches] == [1, 1]
    for out, ref in zip(pout, jout):
        _assert_engine_parity(out, ref)

    # a budget one request fits under the reference's price only
    budget = (j_one + p_one) // 2
    cfg = McServeConfig(quantum_seeds=16, memory_budget_bytes=budget)
    jsrv, psrv = _jax_server(cfg), _port_server(cfg)
    with jax_original_layout():
        (jres,) = run(_drive(jsrv, [pairs[0][0]]))
    (pres,) = run(_drive(psrv, [pairs[0][1]]))
    assert not isinstance(jres, Exception) and jsrv.stats.admitted == 1
    assert isinstance(pres, AdmissionError) and psrv.stats.rejected == 1
    assert "draw_scratch_bytes" in str(pres)
