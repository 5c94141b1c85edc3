"""MC sweep-server launcher (port of `repro.launch.serve_mc`).

`python -m repro_torch.launch.serve_mc` runs a demo traffic mix through
the coalescing server (`repro_torch.serving.mc_server`) on the CUDA card
(`--device cpu` for the CPU) and prints the router's batching stats;
`--selftest` additionally pins the two serving invariants on a mixed
compatible/incompatible request set and exits nonzero on violation:

  * K signature-compatible concurrent requests run as ONE engine program
    shape — `trace_count()` equals the number of distinct signatures;
  * every demuxed per-request result matches a dedicated solo `run_mc`
    call to <= 1e-6 relative.

`--selftest --chaos` additionally drives the fault-tolerance paths: one
injected engine-layer chunk fault retried bit-identically, one transient
quantum failure recovered under `McServeConfig.retry`, and one mid-run
deadline expiry resolving with a `PartialResult` that matches a
dedicated run over the completed seeds — all on a virtual clock, no
wall-clock sleeps.

    PYTHONPATH=src python -m repro_torch.launch.serve_mc --selftest \\
        --chaos --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import sys
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.mc import (
    MCProblemBatch,
    clear_cache,
    quadratic_mc_problem,
    run_mc,
    trace_count,
)
from repro_torch.serving.mc_server import (McServeConfig, SweepRequest,
                                           serve_sync)


def _problem(n: int, dim: int, seed: int, device):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    return quadratic_mc_problem(x, y, 0.1, np.zeros(dim, np.float32),
                                device=device)


def _demo_requests(steps: int, seeds: int, device) -> list:
    """A mixed set: three coalescible quadratic/gbma sweeps differing
    only in row data (N, noise, stepsize), plus one momentum request and
    one longer-horizon request — three distinct signatures."""
    mk = lambda n, noise, beta, seed: SweepRequest(
        problem=_problem(n, 8, seed, device),
        channels=[ChannelConfig(fading="rayleigh", noise_std=noise)],
        algo="gbma", betas=[beta], steps=steps, seeds=seeds)
    reqs = [mk(12, 0.5, 0.08, 0), mk(20, 1.0, 0.05, 1), mk(16, 0.1, 0.1, 2)]
    reqs.append(SweepRequest(
        problem=_problem(16, 8, 3, device),
        channels=[ChannelConfig(fading="rayleigh")],
        algo="momentum", betas=[0.05], steps=steps, seeds=seeds))
    reqs.append(SweepRequest(
        problem=_problem(12, 8, 4, device),
        channels=[ChannelConfig(fading="rayleigh")],
        algo="gbma", betas=[0.08], steps=steps + 10, seeds=seeds))
    return reqs


def _solo(req: SweepRequest, device):
    """The dedicated-call reference: the same row-based engine path the
    server uses, one request per call."""
    return run_mc(MCProblemBatch.stack([req.problem]),
                  req.channels, req.algo, req.betas,
                  req.steps, req.seeds, seed0=req.seed0,
                  batch_frac=req.batch_frac, n_antennas=req.n_antennas,
                  power_budget=req.power_budget, momentum=req.momentum,
                  theta0=req.theta0, shard_seeds=False, device=device)


def _selftest(steps: int, seeds: int, quantum: int,
              bucket_base: float = 2.0, device=None) -> int:
    # The demo mix spans two N-buckets inside the gbma signature, but a
    # fresh server has seen neither shape class — first sight merges
    # under the reference's constants (the analytic cost model charges a
    # second each unseen class), so the bucketed router keeps the
    # one-program-shape-per-signature invariant this test pins whatever a
    # machine's calibration says a first sight costs.
    from repro_torch.core.mc.costmodel import analytic_cost_model
    from repro_torch.serving.mc_server import InlineExecutor, McSweepServer

    device = resolve_device(device)
    reqs = _demo_requests(steps, seeds, device)
    n_sigs = 3
    clear_cache()
    srv = McSweepServer(McServeConfig(quantum_seeds=quantum,
                                      bucket_base=bucket_base),
                        executor=InlineExecutor(),
                        cost_model=analytic_cost_model(), device=device)
    results = serve_sync(reqs, server=srv)
    shapes = trace_count()
    stats = serve_sync.last_stats
    ok = True
    if shapes != n_sigs:
        ok = False
        print(f"FAIL: {shapes} program shapes for {n_sigs} distinct "
              f"signatures ({len(reqs)} requests)")
    for i, (req, res) in enumerate(zip(reqs, results)):
        solo = _solo(req, device)
        rel = np.max(np.abs(res.risks - solo.risks)
                     / np.maximum(np.abs(solo.risks), 1e-12))
        if not (rel <= 1e-6):
            ok = False
            print(f"FAIL: request {i} demux mismatch, rel={rel:.3e}")
    n_batches = len(stats.batches)
    if n_batches != n_sigs:
        ok = False
        print(f"FAIL: {n_batches} batches for {n_sigs} signatures")
    if any(b["pad_flops_ratio"] < 1.0 for b in stats.batches):
        ok = False
        print("FAIL: pad_flops_ratio < 1.0 (padded FLOPs below useful)")
    verdict = "PASS" if ok else "FAIL"
    shape = [(b["requests"], b["rows"], b["quanta"]) for b in stats.batches]
    print(f"selftest {verdict}: {len(reqs)} requests -> {n_batches} "
          f"batches, {shapes} program shapes, batches={shape}, "
          f"pad_ratios="
          f"{[b['pad_flops_ratio'] for b in stats.batches]}, "
          f"occupancy={stats.bucket_occupancy}")
    return 0 if ok else 1


class _VirtualClock:
    """Injected server clock: advanced only by scripted events."""

    def __init__(self):
        self.now = 0.0

    def time(self) -> float:
        return self.now

    async def sleep(self, dt: float) -> None:
        self.now += dt
        await asyncio.sleep(0)


def _chaos(steps: int, seeds: int, quantum: int, device=None) -> int:
    """Chaos scenarios for `--selftest --chaos`: scripted faults at the
    engine and serving layers, each checked against its fault-free
    reference. Returns 0/1 like `_selftest`."""
    from repro_torch.core.mc import ExecPlan, RetryPolicy
    from repro_torch.core.mc import exec as exec_mod
    from repro_torch.serving.mc_server import (
        InlineExecutor,
        McSweepServer,
        PartialResult,
    )

    device = resolve_device(device)

    ok = True

    def rel(a, b):
        return np.max(np.abs(np.asarray(a) - np.asarray(b))
                      / np.maximum(np.abs(np.asarray(b)), 1e-12))

    # -- scenario 0: engine-layer chunk retry is bit-identical ----------
    args = (_problem(12, 8, 0, device),
            [ChannelConfig(fading="rayleigh", noise_std=0.5)],
            "gbma", [0.08], steps, seeds)
    plan = ExecPlan(seed_chunk=quantum, keep_seed_curves=False)
    clean = run_mc(*args, plan=plan, device=device)
    fired = []

    def fail_first_attempts(info):
        if info["attempt"] == 1:  # every chunk fails once
            fired.append(info["off"])
            raise RuntimeError("chaos: injected chunk fault")

    remove = exec_mod.install_chunk_fault_hook(fail_first_attempts)
    try:
        survived = run_mc(*args, plan=plan.replace(
            retry=RetryPolicy(max_attempts=2, sleep=lambda dt: None)),
            device=device)
    finally:
        remove()
    if not (fired and np.array_equal(survived.mean, clean.mean)
            and np.array_equal(survived.ci95, clean.ci95)):
        ok = False
        print(f"FAIL: chunk retry not bit-identical after {len(fired)} "
              f"injected faults")

    class _ChaosExecutor(InlineExecutor):
        """Fails the `fail_at`-th engine call once; jumps the virtual
        clock by `jump` after the `jump_after`-th call (a scripted slow
        quantum)."""

        def __init__(self, clock, fail_at=None, jump_after=None,
                     jump=0.0):
            self.clock = clock
            self.fail_at = fail_at
            self.jump_after = jump_after
            self.jump = jump
            self.n = 0

        async def run(self, fn, info=None):
            idx, self.n = self.n, self.n + 1
            if idx == self.fail_at:
                self.fail_at = None
                raise RuntimeError("chaos: transient quantum failure")
            out = await super().run(fn, info)
            if idx == self.jump_after:
                self.clock.now += self.jump
            return out

    async def drive(srv, reqs):
        tasks = [asyncio.ensure_future(srv.submit(r)) for r in reqs]
        await asyncio.sleep(0)
        await srv.drain()
        return await asyncio.gather(*tasks, return_exceptions=True)

    # -- scenario 1: transient quantum failure recovered by cfg.retry ---
    req = _demo_requests(steps, seeds, device)[0]
    clock = _VirtualClock()
    srv = McSweepServer(
        McServeConfig(quantum_seeds=quantum,
                      retry=RetryPolicy(max_attempts=3,
                                        base_delay_s=0.01)),
        executor=_ChaosExecutor(clock, fail_at=0), clock=clock,
        device=device)
    (res,) = asyncio.run(drive(srv, [req]))
    retries = srv.stats.retries
    if isinstance(res, Exception) or retries < 1 \
            or rel(res.risks, _solo(req, device).risks) > 1e-6:
        ok = False
        print(f"FAIL: retried quantum did not recover to the solo "
              f"result ({res!r}, retries={retries})")

    # -- scenario 2: mid-run deadline expiry -> PartialResult -----------
    reqs = _demo_requests(steps, seeds, device)[:2]
    hurried = dataclasses.replace(reqs[0], deadline_s=5.0)
    patient = reqs[1]
    clock = _VirtualClock()
    srv = McSweepServer(
        McServeConfig(quantum_seeds=quantum),
        executor=_ChaosExecutor(clock, jump_after=0, jump=10.0),
        clock=clock, device=device)
    part, full = asyncio.run(drive(srv, [hurried, patient]))
    part_ref = dataclasses.replace(hurried, seeds=quantum,
                                   deadline_s=None)
    if not (isinstance(part, PartialResult)
            and part.seeds_completed == quantum
            and part.result is not None
            and rel(part.result.risks,
                    _solo(part_ref, device).risks) <= 1e-6):
        ok = False
        print(f"FAIL: deadline expiry did not degrade gracefully "
              f"({part!r})")
    if isinstance(full, Exception) \
            or rel(full.risks, _solo(patient, device).risks) > 1e-6:
        ok = False
        print("FAIL: the expired request disturbed its batchmate")
    if srv.stats.deadline_expired != 1:
        ok = False
        print(f"FAIL: deadline_expired={srv.stats.deadline_expired}")

    verdict = "PASS" if ok else "FAIL"
    print(f"chaos {verdict}: {len(fired)} chunk faults retried "
          f"bit-identically, 1 quantum failure recovered "
          f"(retries={retries}), 1 deadline expiry -> "
          f"PartialResult({quantum}/{seeds} seeds)")
    return 0 if ok else 1


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--quantum", type=int, default=4,
                    help="seeds per scheduling quantum")
    ap.add_argument("--bucket-base", type=float, default=2.0,
                    help="geometric N-bucket base of the pad-waste-aware "
                         "coalescer; <= 1 disables bucketing")
    ap.add_argument("--selftest", action="store_true",
                    help="assert one program shape per distinct signature "
                         "and demux == solo run_mc; exit nonzero on "
                         "failure")
    ap.add_argument("--chaos", action="store_true",
                    help="with --selftest: also run the scripted fault "
                         "scenarios (chunk retry, quantum retry, "
                         "deadline expiry)")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.selftest:
        rc = _selftest(args.steps, args.seeds, args.quantum,
                       args.bucket_base, device)
        if args.chaos:
            rc |= _chaos(args.steps, args.seeds, args.quantum, device)
        sys.exit(rc)
    reqs = _demo_requests(args.steps, args.seeds, device)
    clear_cache()
    t0 = time.time()
    results = serve_sync(reqs, McServeConfig(quantum_seeds=args.quantum,
                                             bucket_base=args.bucket_base),
                         device=device)
    dt = time.time() - t0
    stats = serve_sync.last_stats
    print(f"{len(reqs)} requests -> {len(stats.batches)} coalesced "
          f"batches, {trace_count()} program shapes, {dt:.1f}s, "
          f"bucket occupancy {stats.bucket_occupancy}")
    for b in stats.batches:
        print(f"  sig={b['signature']} requests={b['requests']} "
              f"rows={b['rows']} seeds={b['seeds']} quanta={b['quanta']} "
              f"n_max={b['n_max']} pad_flops_ratio={b['pad_flops_ratio']}")
    for i, res in enumerate(results):
        print(f"  request {i}: final mean risk {res.mean[:, -1]}")


if __name__ == "__main__":
    main()
