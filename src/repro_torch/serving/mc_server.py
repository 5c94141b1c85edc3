"""MC-as-a-service: a coalescing sweep server over the Monte Carlo engine
(port of `repro.serving.mc_server`).

In the reference the expensive artifact of a sweep is the compiled
executable; in the port it is the per-step host issue: every step of an
engine call issues its launches (the gradient, the draws' slices, K1,
the update) whatever the batch's width, and the card idles while the
Python loop issues them. Static facets (shapes and flags) fix the
program; everything else — channel parameters, stepsizes, problem data,
node counts, antenna counts, minibatch fractions — is row *data* the
padded batch axis already fuses. Serving many clients is therefore a
request-*coalescing* problem: requests whose static facets agree pack
into ONE engine call and pay one step loop between them.

The server is three small pieces:

* **Signature router.** Each `SweepRequest` maps to a program
  signature (`exec.static_signature` — the same hashing machinery the
  resume fingerprint uses, restricted to static facets: problem kind and
  registry row fns, dim, fading family, steps, the (seeds, seed0) axis,
  the algorithm, stochastic/antenna modes). Signature-equal requests
  coalesce into one padded `run_mc` batch — their node counts, channel
  params, stepsizes, antenna counts, minibatch fractions and power
  budgets concatenate as row data; signature-distinct requests never
  share a batch. K concurrent requests run exactly one program shape per
  distinct signature (`exec.trace_count()`, the port's counterpart of a
  compile, asserted in the tests and `serve_mc --selftest`).

* **Admission control**, priced on the port's own buffers:
  `exec.estimate_peak_bytes` (the reference's analytic model) plus
  `exec.draw_scratch_bytes` (what the eager threefry and the
  bits→gain/noise chain hold while they draw: int64 counters and hashes,
  f64 intermediates, which XLA fuses away in the reference) price each
  request (and each growing batch) against
  `McServeConfig.memory_budget_bytes`. A request whose own single-quantum
  price exceeds the budget is rejected at `submit` with a typed
  `AdmissionError`; an affordable request that would push a batch over
  the budget (or past `max_batch_rows`) closes the batch and starts the
  next one — same signature, but scheduled separately. Where the scratch
  matters this splits or rejects what the reference admits (ROADMAP §3,
  R4).

* **Pad-waste-aware bucketing.** Coalescing pads every row to the batch
  N_max, so a N=32 minnow merged with a N=4096 whale pays N=4096 FLOPs
  per slot — cheap cold (one step loop shared by strangers), a pure
  tax warm. The router therefore quantizes each request into a geometric
  **N-bucket shape class** (`bucket_base`, ×2 by default) and prices
  merged-vs-separate with the measured cost model
  (`repro_torch.core.mc.costmodel`): a signature group that spans buckets
  merges only when `predicted(merged) ≤ predicted(separate) +
  compile_amortization`, where each side charges `CostModel.compile_s`
  (the port's first sight of a program shape) for every shape class this
  server instance has not executed yet (a per-instance registry,
  invalidated when `mc.clear_cache()` bumps `exec.cache_epoch()`). On
  top of the static prediction the router closes the loop with
  **measured layout feedback** (`measure_layouts`): once a (signature,
  bucket) group's shapes have run, it times its own warm batches
  (observations polluted by a first sight are discarded via
  `trace_count()`; the engine call hands back host arrays, so the card's
  asynchronous launches are inside the timing), tries the group's two
  layouts — `merged` (one padded batch) and `exact` (one batch per
  distinct N, zero pad) — once each, then routes to the measured-cheaper
  one (µs per padded node).
  Net effect: the first sight of a cross-bucket group merges, and
  steady-state traffic settles into whatever mix of padded and exact
  batches this machine actually runs fastest. Counter-based RNG
  keeps every routing choice invisible in the numbers: bucketed demux ==
  solo `run_mc` ≤ 1e-6 (property-tested). `ServeStats.bucket_occupancy`,
  `ServeStats.layouts` and per-batch `pad_flops_ratio`/`layout` make the
  routing observable. (Observations are µs per *demanded* node, so for
  a stationary mix comparing rates compares round totals exactly.)

* **Fairness-preserving preemption.** A batch does not run its whole
  seed axis in one blocking call: the scheduler round-robins *seed
  quanta* of `quantum_seeds` across all live batches — the same
  seeds-are-data slicing `run_mc(seed_chunk=)` uses internally, driven
  here from the event loop so a 1024-seed whale cannot starve 4-seed
  minnows. Quantum k runs `run_mc(..., seeds=q, seed0=seed0 + off)`,
  which replays exactly the seed streams `seed0 + off .. seed0 + off + q`
  of the uninterrupted call (counter-based RNG), so sliced results are
  identical to single-shot ones. Seed counts that are multiples of the
  quantum share one slice shape; a ragged final quantum is one more.

* **Fault tolerance.** Deadlines: a request still running when its
  (relative) `deadline_s` expires resolves with a typed `PartialResult`
  over the seeds its batch completed — the quantum scheduler's stitched
  per-quantum results make the partial statistics exactly what a
  dedicated `run_mc` over those seeds returns, and batchmates keep
  running. Retry: `McServeConfig.retry` re-attempts a failed engine
  quantum under capped exponential backoff before the failure reaches
  any client. Watchdog: `hang_threshold_s` quarantines a signature whose
  engine call ran too long (post-hoc on the injectable clock — fully
  deterministic under the test harness) so one poison request cannot
  starve the queue; later same-signature submits fail fast with
  `QuarantinedError` carrying the original cause.

Results demux back per request with `mc.slice_result` row views of the
batch `MCResult`. Clients cancelling mid-batch detach their future; the
batch still completes for its other requests (and a batch whose every
request cancelled is dropped without running its remaining quanta).

Determinism knobs — the tests inject both: `clock` (the coalesce
window, deadlines, backoff and the watchdog; a manual clock advances
virtual time without wall-clock sleeps) and `executor` (`InlineExecutor`
runs engine calls synchronously on the loop thread in deterministic
order; the default `LoopExecutor` uses a worker thread so the event loop
stays responsive under real traffic).

Device: `McSweepServer(device=None)` runs every engine call on the CUDA
card (raising where CUDA is absent); pass `device="cpu"` for the CPU.
Each engine call runs under that device explicitly (a worker thread's
current CUDA device is not the server's), and the padded problem packs
are cached on it. The demux (`slice_result`) and the stitched
per-quantum statistics (`host_seed_stats`) run on the host, as in the
reference. `repro_torch.launch.serve_mc` is the CLI front-end.
"""
from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import math
import time
from collections import deque
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.mc import exec as exec_mod
from repro_torch.core.mc.engine import MCResult, run_mc, slice_result
from repro_torch.core.mc.exec import (draw_scratch_bytes,
                                      estimate_peak_bytes, host_seed_stats)
from repro_torch.core.mc.plan import RetryPolicy
from repro_torch.core.mc.problems import PROBLEMS, MCProblem, MCProblemBatch
from repro_torch.core.mc.slots import ALGO_REGISTRY


# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------
class ServeError(Exception):
    """Base class of the server's typed failures."""


class RequestError(ServeError):
    """Malformed request payload — raised at `submit`, before the request
    ever reaches the router queue (fail fast, nothing to poison)."""


class AdmissionError(ServeError):
    """Request rejected by admission control: its own single-quantum
    price (`estimate_peak_bytes` + `draw_scratch_bytes`) exceeds the
    server's memory budget."""


class QuarantinedError(ServeError):
    """The request's signature is quarantined: an earlier engine call for
    it exceeded the hang threshold (`McServeConfig.hang_threshold_s`), so
    the watchdog fenced the signature off rather than let one poison
    request starve the queue. Carries the original cause; raised both on
    the hung batch's own futures and on every subsequent same-signature
    `submit`."""


@dataclasses.dataclass(frozen=True)
class PartialResult:
    """What a deadline-expired request resolves with:
    the statistics of the seeds its batch HAD completed when the deadline
    passed, instead of an error or an unbounded wait.

    result:          an `MCResult` over the completed seed prefix —
                     risks/cum_energy sliced to `seeds_completed`,
                     mean/ci95 computed over exactly those seeds (the
                     quantum scheduler replays per-seed streams, so these
                     match a dedicated `run_mc` over the same seeds).
                     None when the deadline passed before any quantum
                     finished (`seeds_completed == 0`).
    seeds_completed: seeds actually run when the deadline expired.
    seeds_requested: the request's full seed count.
    """

    result: Optional[MCResult]
    seeds_completed: int
    seeds_requested: int


# --------------------------------------------------------------------------
# request schema
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SweepRequest:
    """One client's sweep: rows (channel × stepsize, sharing one problem
    kind and one algorithm) × a private seed axis.

    problem:     a library-built `MCProblem` shared by every row, or one
                 per row (node counts may differ — rows pad to the batch
                 N_max like any engine sweep).
    channels:    one `ChannelConfig` per row (one fading family per
                 request; the family is static and part of the
                 signature).
    algo:        `ALGO_REGISTRY` name; static (part of the signature).
    betas:       one stepsize per row (row data).
    steps:       slot count (static).
    seeds:       Monte Carlo seed count — the seed-axis *shape* is static,
                 so it is part of the signature; the seed ints are data.
    seed0:       first seed; seed s uses the threefry key(seed0 + s),
                 the same stream a dedicated `run_mc` call would use.
    batch_frac:  minibatch fraction (scalar or per row) for stochastic
                 problem kinds; 1.0 = exact full-batch gradients.
                 Full-batch and minibatch requests never coalesce (the
                 no-sampling path is a different, cheaper program).
    n_antennas:  edge antenna count M (scalar broadcast or per row;
                 required for blind algorithms). Normalized to per-row
                 data so M-heterogeneous requests coalesce.
    power_budget: per-slot per-node transmit budget (scalar or per row;
                 row data, only `blind_ec` rows enforce it).
    momentum:    γ for momentum/nesterov rows (whole-call scalar, so it
                 is part of the signature).
    theta0:      shared starting iterate (whole-call data: requests must
                 agree on it to coalesce, so its bytes fold into the
                 signature); None = zeros.
    deadline_s:  relative deadline in seconds (measured on the server's
                 clock from admission). A request still running when it
                 expires resolves with a typed `PartialResult` over the
                 seeds its batch completed — batchmates are unaffected.
                 None falls back to `McServeConfig.default_deadline_s`
                 (None = no deadline). NOT a signature facet: requests
                 differing only in deadline still coalesce.
    """

    problem: Union[MCProblem, Sequence[MCProblem]]
    channels: Sequence[ChannelConfig]
    algo: str
    betas: Sequence[float]
    steps: int
    seeds: int
    seed0: int = 0
    batch_frac: Union[float, Sequence[float]] = 1.0
    n_antennas: Optional[Union[int, Sequence[int]]] = None
    power_budget: Optional[Union[float, Sequence[float]]] = None
    momentum: float = 0.9
    theta0: Optional[np.ndarray] = None
    deadline_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class McServeConfig:
    """Server policy knobs (the reference's defaults).

    memory_budget_bytes: admission budget the per-quantum price
        (`estimate_peak_bytes` + `draw_scratch_bytes`) is checked
        against.
    quantum_seeds: seeds per scheduling quantum — the preemption grain.
        Requests whose seed count is a multiple of it share one slice
        shape.
    max_batch_rows: hard cap on rows per coalesced engine call.
    coalesce_window: seconds `serve_forever` waits after a wakeup for
        straggler requests before draining (0 = drain immediately).
    bucket_base: geometric base of the N-bucket shape classes the
        pad-waste-aware coalescer quantizes requests into (a request
        whose largest row has N nodes lands in class base^ceil(log_base
        N)). Values <= 1 (or 0/None) disable bucketing: every
        signature group merges monolithically, the pre-cost-model
        behavior.
    compile_amortization_s: extra predicted seconds a merged batch may
        cost over separate ones and still merge — slack biasing the
        merge decision toward fewer compiles/dispatches. Unseen shape
        classes already charge `CostModel.compile_s` inside the
        prediction; this knob is on top (default 0 = decide purely on
        predicted wall-clock).
    measure_layouts: close the loop on the cost model: once a
        (signature, bucket) group's shapes have run, time its warm
        batches, try the `merged` and `exact` layouts once each, and
        route steady-state traffic to the measured-cheaper one. False
        restores the purely predicted (always-merged-within-bucket)
        routing.
    default_deadline_s: deadline applied to requests that set none
        (None = unbounded). Per-request `SweepRequest.deadline_s` wins.
    hang_threshold_s: per-batch watchdog (None = off): an engine call
        whose elapsed time on the server clock exceeds this quarantines
        the batch's signature — its unresolved futures fail with
        `QuarantinedError`, and every later same-signature submit is
        rejected with the original cause, so one poison request cannot
        starve the queue.
    retry: a `RetryPolicy` re-attempting a failed engine quantum with
        capped exponential backoff (backoff waits on the server clock —
        virtual under the test harness). None (default) keeps the legacy
        fail-fast containment: the batch's futures carry the error.
    """

    memory_budget_bytes: int = 2 * 2**30
    quantum_seeds: int = 64
    max_batch_rows: int = 256
    coalesce_window: float = 0.0
    bucket_base: float = 2.0
    compile_amortization_s: float = 0.0
    measure_layouts: bool = True
    default_deadline_s: Optional[float] = None
    hang_threshold_s: Optional[float] = None
    retry: Optional[RetryPolicy] = None


# --------------------------------------------------------------------------
# injectable clock / executor
# --------------------------------------------------------------------------
class WallClock:
    """Real time: `serve_forever`'s coalesce window sleeps on the loop."""

    def time(self) -> float:
        return time.monotonic()

    async def sleep(self, dt: float) -> None:
        await asyncio.sleep(dt)


class LoopExecutor:
    """Default executor: engine calls run in the loop's default thread
    pool so the event loop keeps accepting submissions mid-quantum (the
    server's engine call sets its own device on that thread)."""

    async def run(self, fn, info: Optional[dict] = None):
        return await asyncio.get_running_loop().run_in_executor(None, fn)


class InlineExecutor:
    """Deterministic executor: the engine call runs synchronously on the
    loop thread — quanta execute in exactly the order the scheduler
    issues them. One cooperative yield per quantum lets submissions that
    arrive mid-drain enqueue (and be served in the same drain pass)
    without introducing any thread or timing nondeterminism. Used by the
    tests, the bench and `serve_sync`."""

    async def run(self, fn, info: Optional[dict] = None):
        await asyncio.sleep(0)
        return fn()


# --------------------------------------------------------------------------
# internal records
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _Pending:
    req: "_NormRequest"
    future: asyncio.Future
    # absolute deadline on the server clock (None = unbounded), and
    # whether this request already resolved with a PartialResult — which
    # is NOT a cancellation for the stats
    deadline: Optional[float] = None
    expired: bool = False


@dataclasses.dataclass(frozen=True)
class _NormRequest:
    """Validated, normalized request: per-row tuples throughout."""

    problems: tuple  # one MCProblem per row
    channels: tuple
    algo: str
    betas: tuple
    steps: int
    seeds: int
    seed0: int
    fracs: Optional[tuple]  # None = exact full-batch (no sampling path)
    m_per_row: Optional[tuple]
    budgets: Optional[tuple]
    momentum: float
    theta0: Optional[np.ndarray]
    signature: str
    b_max: int
    deadline_s: Optional[float]  # effective (request or config default)

    @property
    def n_rows(self) -> int:
        return len(self.channels)


@dataclasses.dataclass
class ServeStats:
    """Router observability, asserted on by the deterministic tests.

    `bucket_occupancy` counts admitted-and-routed requests per N-bucket
    shape class (empty while bucketing is disabled); each entry of
    `batches` records its batch's `n_max`, `bucket`, `layout` (the
    measured-feedback routing that produced it — None outside the
    layout loop), `pad_flops_ratio` = rows·N_max / Σ N_i — the
    padded-FLOPs multiplier the batch actually paid (1.0 = no pad
    waste) — and its admission price per quantum, `estimate_bytes` +
    `scratch_bytes`. `layouts` snapshots the router's measured layout
    observations: "sig12/bucket" -> {layout: µs per demanded node}."""

    admitted: int = 0
    rejected: int = 0
    cancelled: int = 0
    failed_batches: int = 0
    retries: int = 0
    deadline_expired: int = 0
    quarantined: int = 0
    batches: list = dataclasses.field(default_factory=list)
    bucket_occupancy: dict = dataclasses.field(default_factory=dict)
    layouts: dict = dataclasses.field(default_factory=dict)


class _Job:
    """One coalesced batch in flight: merged rows + a seed cursor."""

    def __init__(self, pending: Sequence[_Pending], cfg: McServeConfig,
                 layout=None):
        self.pending = list(pending)
        self.cfg = cfg
        # measured-layout bookkeeping: ((signature, bucket), layout name)
        # tag from the router, wall-µs of warm quanta, and whether any
        # quantum recompiled (which disqualifies the observation)
        self.layout = layout
        self.obs_us = 0.0
        self.recompiled = False
        first = pending[0].req
        self.signature = first.signature
        self.algo = first.algo
        self.steps, self.seeds = first.steps, first.seeds
        self.seed0 = first.seed0
        self.momentum, self.theta0 = first.momentum, first.theta0
        self.problems, self.channels, self.betas = [], [], []
        self.spans = []
        fracs, m_rows, budgets = [], [], []
        off = 0
        for p in pending:
            r = p.req
            self.problems += list(r.problems)
            self.channels += list(r.channels)
            self.betas += list(r.betas)
            fracs += list(r.fracs) if r.fracs is not None else []
            m_rows += list(r.m_per_row) if r.m_per_row is not None else []
            budgets += list(r.budgets if r.budgets is not None
                            else (float("inf"),) * r.n_rows)
            self.spans.append((off, off + r.n_rows))
            off += r.n_rows
        self.n_rows = off
        self.row_nodes = tuple(p.n_nodes for p in self.problems)
        self.price = (0, 0)  # (estimate, scratch) bytes per quantum
        self.fracs = tuple(fracs) if first.fracs is not None else None
        self.m_per_row = tuple(m_rows) if first.m_per_row is not None \
            else None
        self.budgets = (tuple(budgets)
                        if any(np.isfinite(b) for b in budgets) else None)
        self.off = 0  # seed cursor
        self.quanta_run = 0
        self.risks = np.empty((off, self.seeds, self.steps + 1), np.float32)
        self.cum_e = np.empty((off, self.seeds, self.steps), np.float32)

    @property
    def done(self) -> bool:
        return self.off >= self.seeds

    @property
    def abandoned(self) -> bool:
        """Every client detached (cancelled) — remaining quanta are
        freed instead of computing results nobody will read."""
        return all(p.future.done() for p in self.pending)


# --------------------------------------------------------------------------
# the server
# --------------------------------------------------------------------------
class McSweepServer:
    """Asyncio front-end: `await submit(request)` -> per-request
    `MCResult`. Drive it either with `start()`/`stop()` (the
    `serve_forever` router task) or by calling `drain()` explicitly
    after a round of submissions (tests, `serve_sync`). `device`: None is
    the CUDA card (raises where CUDA is absent); every engine call runs
    there."""

    def __init__(self, cfg: McServeConfig = McServeConfig(), *,
                 clock=None, executor=None, cost_model=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # pin the index now: a worker thread's current device may
            # differ from the constructing thread's
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.clock = clock if clock is not None else WallClock()
        self.executor = executor if executor is not None else LoopExecutor()
        self.stats = ServeStats()
        self._queue: list[_Pending] = []
        self._wakeup: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._running = False
        # pad-waste-aware routing state: the injected (or lazily loaded)
        # CostModel, the per-instance registry of (signature, bucket)
        # shape classes this server has already executed, the measured
        # layout observations ((signature, bucket) -> {layout: [µs,
        # padded nodes]}) and the padded problem-pack cache — all
        # mirrored on `exec.cache_epoch()` so `mc.clear_cache()` forgets
        # them too
        self._cost_model = cost_model
        self._seen: set = set()
        self._layout_obs: dict = {}
        self._stack_cache: dict = {}
        self._seen_epoch = exec_mod.cache_epoch()
        # watchdog fence: signature -> original cause string; same-
        # signature submits are rejected with QuarantinedError(cause)
        self._quarantined: dict = {}

    # ---- client surface -------------------------------------------------
    async def submit(self, request: SweepRequest) -> MCResult:
        """Validate, admit and enqueue a request; resolves with this
        request's own `MCResult` slice once its batch completes. Raises
        `RequestError`/`AdmissionError` before enqueueing — a bad request
        never reaches the router queue. A signature the watchdog fenced
        off raises `QuarantinedError` with the original cause."""
        norm = self._normalize(request)
        cause = self._quarantined.get(norm.signature)
        if cause is not None:
            self.stats.rejected += 1
            raise QuarantinedError(
                f"signature {norm.signature[:12]} is quarantined: {cause}")
        self._admit(norm)
        self.stats.admitted += 1
        fut = asyncio.get_running_loop().create_future()
        deadline = None if norm.deadline_s is None \
            else self.clock.time() + norm.deadline_s
        self._queue.append(_Pending(req=norm, future=fut,
                                    deadline=deadline))
        if self._wakeup is not None:
            self._wakeup.set()
        return await fut

    def start(self) -> asyncio.Task:
        """Start the router (`serve_forever`) on the running loop."""
        self._wakeup = asyncio.Event()
        self._running = True
        self._task = asyncio.ensure_future(self.serve_forever())
        return self._task

    async def stop(self) -> None:
        self._running = False
        if self._wakeup is not None:
            self._wakeup.set()
        if self._task is not None:
            await self._task
            self._task = None

    async def serve_forever(self) -> None:
        """Router loop: wake on submission, optionally hold the coalesce
        window open for stragglers, then drain the queue."""
        while self._running:
            await self._wakeup.wait()
            self._wakeup.clear()
            if not self._running:
                break
            if self.cfg.coalesce_window > 0:
                await self.clock.sleep(self.cfg.coalesce_window)
            await self.drain()

    async def drain(self) -> None:
        """Process everything queued now (and anything that arrives while
        draining): coalesce by signature, then round-robin one seed
        quantum per job until every job finishes."""
        while self._queue:
            pending, self._queue = self._queue, []
            ready = deque(self._job(group, tag)
                          for group, tag in self._coalesce(pending))
            while ready:
                job = ready.popleft()
                self._expire_deadlines(job)
                if job.abandoned:
                    # futures all resolved — only true cancellations (not
                    # deadline expiries) count as cancelled; either way
                    # the remaining quanta are dropped, so an expired
                    # request never blocks the ring
                    self.stats.cancelled += sum(
                        1 for p in job.pending if not p.expired)
                    continue
                if not await self._run_quantum(job):
                    continue  # batch failed; futures already resolved
                self._expire_deadlines(job)
                if job.done:
                    self._finish(job)
                else:
                    ready.append(job)

    def _job(self, group: list, tag) -> _Job:
        job = _Job(group, self.cfg, layout=tag)
        job.price = self._price([p.req for p in group])
        return job

    # ---- deadlines ------------------------------------------------------
    def _expire_deadlines(self, job: _Job) -> None:
        """Resolve every pending request whose deadline has passed with a
        `PartialResult` over the seeds the batch completed so far. Runs
        before and after every quantum: graceful degradation costs at
        most one quantum of latency, batchmates keep running, and a job
        whose every client expired becomes `abandoned` (its remaining
        quanta are dropped)."""
        now = self.clock.time()
        off = job.off
        for p, (lo, hi) in zip(job.pending, job.spans):
            if p.future.done() or p.deadline is None or now < p.deadline:
                continue
            if off > 0:
                risks = job.risks[lo:hi, :off].copy()
                cum_e = job.cum_e[lo:hi, :off].copy()
                mean, ci95 = host_seed_stats(risks)
                res = MCResult(risks=risks,
                               mean=mean.astype(np.float32),
                               ci95=ci95.astype(np.float32),
                               cum_energy=cum_e, bounds=None, plan=None)
            else:
                res = None
            p.expired = True
            self.stats.deadline_expired += 1
            p.future.set_result(PartialResult(
                result=res, seeds_completed=off,
                seeds_requested=job.seeds))

    # ---- validation / signature / admission -----------------------------
    def _normalize(self, req: SweepRequest) -> _NormRequest:
        if not isinstance(req, SweepRequest):
            raise RequestError(
                f"expected a SweepRequest, got {type(req).__name__}")
        channels = tuple(req.channels)
        n_rows = len(channels)
        if n_rows == 0:
            raise RequestError("request has no rows (empty channels)")
        if not all(isinstance(c, ChannelConfig) for c in channels):
            raise RequestError("channels must be ChannelConfig instances")
        if len({c.fading for c in channels}) != 1:
            raise RequestError(
                "one request = one fading family; split per family")
        probs = [req.problem] if isinstance(req.problem, MCProblem) \
            else list(req.problem)
        if not probs or not all(isinstance(p, MCProblem) for p in probs):
            raise RequestError("problem must be MCProblem(s)")
        if len(probs) == 1:
            probs = probs * n_rows
        if len(probs) != n_rows:
            raise RequestError(
                f"need one problem per row: {len(probs)} vs C={n_rows}")
        kind = probs[0].kind
        if any(p.kind != kind for p in probs):
            raise RequestError("rows must share one problem kind")
        if kind not in PROBLEMS:
            raise RequestError(
                f"problem kind {kind!r} is not a registered library kind "
                "— the server batches strangers' rows, which needs the "
                "row-based PROBLEMS registry path")
        if len({p.dim for p in probs}) != 1:
            raise RequestError("rows must share the problem dim")
        shapes0 = {k: np.shape(v)[1:] for k, v in probs[0].data.items()}
        for p in probs[1:]:
            if {k: np.shape(v)[1:] for k, v in p.data.items()} != shapes0:
                raise RequestError(
                    "rows must agree on every non-node data shape "
                    "(only the node axis pads)")
        betas = tuple(float(b) for b in np.atleast_1d(
            np.asarray(req.betas, dtype=np.float64)))
        if len(betas) != n_rows:
            raise RequestError(
                f"need one stepsize per row: {len(betas)} vs C={n_rows}")
        if req.algo not in ALGO_REGISTRY:
            raise RequestError(
                f"unknown algo {req.algo!r}; expected one of "
                f"{tuple(ALGO_REGISTRY)}")
        if not (isinstance(req.steps, int) and req.steps > 0):
            raise RequestError(f"steps must be a positive int, "
                               f"got {req.steps!r}")
        if not (isinstance(req.seeds, int) and req.seeds > 0):
            raise RequestError(f"seeds must be a positive int, "
                               f"got {req.seeds!r}")
        # minibatch fractions -> per-row tuple, or None for full batch
        fr = req.batch_frac
        fracs = tuple(float(f) for f in (
            (fr,) * n_rows if isinstance(fr, (int, float)) else fr))
        if len(fracs) != n_rows:
            raise RequestError(
                f"need one batch_frac per row: {len(fracs)} vs C={n_rows}")
        if any(not (0.0 < f <= 1.0) for f in fracs):
            raise RequestError(f"batch_frac must be in (0, 1], got {fracs}")
        b_max = 0
        if all(f == 1.0 for f in fracs):
            fracs = None
        else:
            spec = PROBLEMS[kind]
            if spec.sample_indices_row is None:
                raise RequestError(
                    f"batch_frac < 1 needs a stochastic problem kind, "
                    f"got {kind!r}")
            k = probs[0].data[spec.sample_axis_field].shape[-2]
            b_max = max(max(1, int(round(f * k))) for f in fracs)
        # antennas -> per-row tuple (merged as data), or None
        m = req.n_antennas
        if m is None:
            m_per_row = None
            if ALGO_REGISTRY[req.algo].blind:
                raise RequestError(
                    f"algo {req.algo!r} is blind and needs n_antennas")
        else:
            m_per_row = tuple(int(x) for x in (
                (m,) * n_rows if isinstance(m, (int, np.integer)) else m))
            if len(m_per_row) != n_rows:
                raise RequestError(f"need one antenna count per row: "
                                   f"{len(m_per_row)} vs C={n_rows}")
            if any(x < 1 for x in m_per_row):
                raise RequestError(f"antenna counts must be >= 1: "
                                   f"{m_per_row}")
        pb = req.power_budget
        if pb is None:
            budgets = None
        else:
            budgets = tuple(float(b) for b in (
                (pb,) * n_rows if isinstance(pb, (int, float)) else pb))
            if len(budgets) != n_rows:
                raise RequestError(f"need one power budget per row: "
                                   f"{len(budgets)} vs C={n_rows}")
        theta0 = None if req.theta0 is None \
            else np.asarray(req.theta0, np.float32)
        if theta0 is not None and theta0.shape != (probs[0].dim,):
            raise RequestError(
                f"theta0 shape {theta0.shape} != (dim,) = "
                f"({probs[0].dim},)")
        deadline_s = req.deadline_s if req.deadline_s is not None \
            else self.cfg.default_deadline_s
        if deadline_s is not None and not deadline_s > 0:
            raise RequestError(
                f"deadline_s must be positive, got {deadline_s!r}")
        sig = self._signature(kind, probs[0], req.algo, req.steps,
                              req.seeds, req.seed0, channels[0].fading,
                              fracs is not None, m_per_row is not None,
                              req.momentum, theta0)
        return _NormRequest(
            problems=tuple(probs), channels=channels, algo=req.algo,
            betas=betas, steps=int(req.steps), seeds=int(req.seeds),
            seed0=int(req.seed0), fracs=fracs, m_per_row=m_per_row,
            budgets=budgets, momentum=float(req.momentum), theta0=theta0,
            signature=sig, b_max=b_max, deadline_s=deadline_s)

    @staticmethod
    def _signature(kind, prob, algo, steps, seeds, seed0, fading,
                   stochastic, antennas, momentum, theta0) -> str:
        """The request's program signature (module docstring):
        static facets only, via `exec.static_signature`. Node counts,
        channel params, stepsizes, antenna counts, fractions and budgets
        are deliberately absent — they are row data the padded batch
        fuses. Non-node data shapes (e.g. the per-node sample count of a
        stochastic kind) are static, so they are in."""
        spec = PROBLEMS[kind]
        data_shapes = tuple(sorted(
            (name, tuple(np.shape(v)[1:]))
            for name, v in prob.data.items()))
        th = None if theta0 is None else hashlib.sha256(
            np.ascontiguousarray(theta0).tobytes()).hexdigest()
        return exec_mod.static_signature({
            "kind": kind, "grad_fn": spec.grad_row,
            "risk_fn": spec.risk_row, "dim": prob.dim,
            "data_shapes": data_shapes, "fading": fading,
            "steps": steps, "seeds": seeds, "seed0": seed0, "algo": algo,
            "stochastic": stochastic, "antennas": antennas,
            "momentum": momentum, "theta0": th,
        })

    def _price(self, reqs: Sequence[_NormRequest]) -> tuple:
        """(estimate, scratch) bytes of one coalesced batch's quantum:
        the reference's analytic `estimate_peak_bytes` and the port's
        `draw_scratch_bytes` at the same arguments, plus the batch's
        fading family, phase stream and count of distinct node counts.
        `b_max` is the batch's largest, the lanes its engine call draws
        (the reference prices the first request's)."""
        n_nodes = {p.n_nodes for r in reqs for p in r.problems}
        m_sizes = tuple(sorted({m for r in reqs
                                for m in (r.m_per_row or ())}))
        first = reqs[0]
        kw = dict(
            n_rows=sum(r.n_rows for r in reqs), seeds=first.seeds,
            steps=first.steps, n_max=max(n_nodes),
            dim=first.problems[0].dim, algo_set=(first.algo,),
            seed_chunk=min(self.cfg.quantum_seeds, first.seeds),
            m_sizes=m_sizes, b_max=max(r.b_max for r in reqs),
            keep_seed_curves=True)
        est = estimate_peak_bytes(**kw)["device_peak_bytes"]
        scratch = draw_scratch_bytes(
            **kw, fading=first.channels[0].fading,
            phase_zero=all(float(c.phase_error_max) == 0.0
                           for r in reqs for c in r.channels),
            n_distinct=len(n_nodes))
        return est, scratch

    def _estimate(self, reqs: Sequence[_NormRequest]) -> int:
        """The admission price of one coalesced batch's quantum on the
        port's buffers: `estimate_peak_bytes` + `draw_scratch_bytes`."""
        return sum(self._price(reqs))

    def _admit(self, norm: _NormRequest) -> None:
        est, scratch = self._price([norm])
        if est + scratch > self.cfg.memory_budget_bytes:
            self.stats.rejected += 1
            raise AdmissionError(
                f"request needs ~{est + scratch} bytes per seed quantum "
                f"(estimate_peak_bytes {est} + draw_scratch_bytes "
                f"{scratch} at quantum_seeds={self.cfg.quantum_seeds}) > "
                f"budget {self.cfg.memory_budget_bytes} — shrink the "
                "request (rows / nodes / dim) or raise the server budget")

    # ---- coalescing -----------------------------------------------------
    def _coalesce(self, pending: Sequence[_Pending]) -> list:
        """Group signature-equal requests (submission order preserved),
        partition each group by the pad-waste-aware bucket rule
        (`_partition`), then pack every partition into batches under the
        admission budget and the row cap. Returns a list of
        (pending-list, layout-tag) pairs, one per batch. Every routed
        request's shape class is recorded in the seen-registry
        afterwards — the next drain prices those classes as already
        compiled."""
        self._sync_seen_epoch()
        groups: dict[str, list[_Pending]] = {}
        for p in pending:
            groups.setdefault(p.req.signature, []).append(p)
        batches = []
        for sig, group in groups.items():
            for part, tag in self._partition(sig, group):
                batches.extend((b, tag) for b in self._pack(part))
        if self._bucketing:
            occ = self.stats.bucket_occupancy
            for batch, _ in batches:
                for p in batch:
                    b = self._bucket(max(pr.n_nodes
                                         for pr in p.req.problems))
                    self._seen.add((p.req.signature, b))
                    occ[b] = occ.get(b, 0) + 1
        return batches

    @property
    def _bucketing(self) -> bool:
        base = self.cfg.bucket_base
        return bool(base) and base > 1.0

    def _bucket(self, n: int) -> int:
        """The geometric shape class of node count `n`: the smallest
        base^k >= n (integer-rounded so fractional bases stay exact)."""
        b = 1
        while b < n:
            b = max(b + 1, int(math.ceil(b * self.cfg.bucket_base)))
        return b

    def _sync_seen_epoch(self) -> None:
        epoch = exec_mod.cache_epoch()
        if epoch != self._seen_epoch:
            self._seen.clear()
            self._layout_obs.clear()
            self._stack_cache.clear()
            self._seen_epoch = epoch

    def cost_model(self):
        """The routing `CostModel`: injected at construction, else the
        calibration artifact's entry for this server's platform and one
        device, else the analytic fallback (lazy — servers that never see
        cross-bucket traffic never load it)."""
        if self._cost_model is None:
            from repro_torch.core.mc import costmodel as costmodel_mod

            self._cost_model = (
                costmodel_mod.load_cost_model(device_count=1,
                                              device=self.device)
                or costmodel_mod.analytic_cost_model())
        return self._cost_model

    def _predict_batch_us(self, reqs: Sequence[_NormRequest]) -> float:
        """Predicted wall-clock of serving `reqs` as ONE padded batch,
        priced the way the scheduler will actually run it: every row at
        the merged N_max, seed quanta as the chunk grain, single device
        (`shard_seeds=False` in `_engine_call`)."""
        from repro_torch.core.mc.costmodel import Workload
        from repro_torch.core.mc.plan import ExecPlan

        first = reqs[0]
        wl = Workload(
            n_rows=sum(r.n_rows for r in reqs), seeds=first.seeds,
            steps=first.steps,
            n_max=max(p.n_nodes for r in reqs for p in r.problems),
            dim=first.problems[0].dim, algo_set=(first.algo,),
            m_sizes=tuple(sorted({m for r in reqs
                                  for m in (r.m_per_row or ())})),
            b_max=max(r.b_max for r in reqs))
        plan = ExecPlan(seed_chunk=min(self.cfg.quantum_seeds,
                                       first.seeds),
                        n_shards=0, row_shards=1, keep_seed_curves=True)
        return self.cost_model().predict_run_us(plan, wl, device_count=1)

    def _partition(self, sig: str, group: list) -> list:
        """The merge decision, two levels, returning
        (part, layout-tag) pairs.

        Cross-bucket (predicted): a signature group that spans several
        N-buckets merges only when the cost model prices the merged
        padded batch at or below the per-bucket batches — each side
        charged `compile_s` per shape class this server has not executed
        yet, plus the `compile_amortization_s` slack on the separate
        side.

        Within-bucket (measured): each per-bucket group with more than
        one distinct N then picks its layout — `merged` (one padded
        batch) or `exact` (one zero-pad batch per distinct N) — from the
        router's own warm-batch timings: unseen shapes merge (compile
        amortization), each layout is explored once, then traffic
        exploits the measured-cheaper µs per demanded node (ties
        merge). Bucketing disabled = everything merges, untagged."""
        if not self._bucketing:
            return [(group, None)]
        sub: dict[int, list] = {}
        for p in group:
            b = self._bucket(max(pr.n_nodes for pr in p.req.problems))
            sub.setdefault(b, []).append(p)
        if len(sub) > 1:
            compile_us = self.cost_model().compile_s * 1e6
            t_merged = self._predict_batch_us([p.req for p in group])
            if (sig, max(sub)) not in self._seen:
                t_merged += compile_us  # merged batch compiles at max-N
            t_sep = 0.0
            for b, ps in sub.items():
                t_sep += self._predict_batch_us([p.req for p in ps])
                if (sig, b) not in self._seen:
                    t_sep += compile_us
            slack = self.cfg.compile_amortization_s * 1e6
            if t_merged <= t_sep + slack:
                return [(group, None)]
        parts = []
        for b in sorted(sub):
            parts.extend(self._layout(sig, b, sub[b]))
        return parts

    def _layout(self, sig: str, bucket: int, ps: list) -> list:
        """Route one (signature, bucket) group by measured layout
        feedback; returns (part, tag) pairs. Groups with a single
        distinct N have nothing to decide (merged == exact)."""
        by_n: dict[int, list] = {}
        for p in ps:
            n = max(pr.n_nodes for pr in p.req.problems)
            by_n.setdefault(n, []).append(p)
        if len(by_n) <= 1:
            return [(ps, None)]
        if not self.cfg.measure_layouts:
            return [(ps, None)]  # purely predicted routing: merge
        key = (sig, bucket)
        obs = self._layout_obs.get(key, {})
        if key not in self._seen:
            choice = "merged"  # first sight: compile amortization wins
        elif "merged" not in obs:
            choice = "merged"  # explore the padded layout first
        elif "exact" not in obs:
            choice = "exact"
        else:
            per_node = {k: v[0] / max(v[1], 1) for k, v in obs.items()}
            choice = ("merged" if per_node["merged"] <= per_node["exact"]
                      else "exact")
        if choice == "merged":
            return [(ps, (key, "merged"))]
        return [(by_n[n], (key, "exact")) for n in sorted(by_n)]

    def _pack(self, group: list) -> list:
        """Greedy-pack one mergeable run of requests into batches under
        the admission budget and the row cap."""
        batches = []
        cur: list[_Pending] = []
        for p in group:
            trial = [q.req for q in cur] + [p.req]
            rows = sum(r.n_rows for r in trial)
            if cur and (rows > self.cfg.max_batch_rows
                        or self._estimate(trial)
                        > self.cfg.memory_budget_bytes):
                batches.append(cur)
                cur = [p]
            else:
                cur.append(p)
        batches.append(cur)
        return batches

    # ---- execution ------------------------------------------------------
    def _stacked(self, problems: Sequence[MCProblem]) -> MCProblemBatch:
        """The padded problem pack for `problems` on the server's device,
        cached per identity tuple: persistent servers re-serving the same
        library-built problems skip the re-pad and the host→device copy
        every quantum (problem data is treated as immutable after submit).
        The cache holds strong references, so the id-keys cannot alias,
        and is bounded."""
        key = tuple(map(id, problems))
        hit = self._stack_cache.get(key)
        if hit is None:
            hit = (MCProblemBatch.stack(problems).to(self.device),
                   tuple(problems))
            while len(self._stack_cache) >= 64:
                self._stack_cache.pop(next(iter(self._stack_cache)))
            self._stack_cache[key] = hit
        return hit[0]

    def _engine_call(self, job: _Job, off: int, q: int):
        """One quantum through `run_mc` on the server's device (set
        explicitly: this may run on a worker thread). The curves come back
        as host arrays, so the card's work is finished when it returns."""
        def call():
            res = run_mc(
                self._stacked(job.problems), job.channels, job.algo,
                job.betas, job.steps, q, seed0=job.seed0 + off,
                theta0=job.theta0, n_antennas=job.m_per_row,
                power_budget=job.budgets,
                batch_frac=job.fracs if job.fracs is not None else 1.0,
                momentum=job.momentum, shard_seeds=False,
                device=self.device)
            return res.risks, res.cum_energy

        if self.device.type != "cuda":
            return call()
        with torch.cuda.device(self.device):
            return call()

    async def _run_quantum(self, job: _Job) -> bool:
        """One scheduling quantum of `job`; False when the batch failed
        (its futures carry the exception) and must leave the ring.

        With `cfg.retry` set, a failed engine call re-attempts under the
        policy's capped backoff (waited on the server clock) before the
        failure is routed to the clients — counter-based RNG replays the
        quantum's exact seed streams, so a retried quantum is
        indistinguishable from a first-try one. With
        `cfg.hang_threshold_s` set, an engine call whose elapsed server-
        clock time exceeds the threshold quarantines the signature
        (post-hoc watchdog: deterministic under an injected clock, no
        racing timers)."""
        off = job.off
        q = min(self.cfg.quantum_seeds, job.seeds - off)
        info = {"signature": job.signature[:12], "off": off, "quantum": q,
                "rows": job.n_rows}
        attempt = 1
        while True:
            tc0 = exec_mod.trace_count()
            t0 = time.perf_counter()
            w0 = self.clock.time()
            try:
                risks, cum_e = await self.executor.run(
                    lambda: self._engine_call(job, off, q), info=info)
                break
            except Exception as e:  # noqa: BLE001 — routed to the clients
                policy = self.cfg.retry
                if policy is not None and attempt < policy.max_attempts:
                    self.stats.retries += 1
                    await self.clock.sleep(policy.delay_s(attempt))
                    attempt += 1
                    continue
                self.stats.failed_batches += 1
                for p in job.pending:
                    if not p.future.done():
                        p.future.set_exception(
                            ServeError(f"batch {job.signature[:12]} failed "
                                       f"at seed offset {off}: {e!r}"))
                return False
        elapsed = self.clock.time() - w0
        if self.cfg.hang_threshold_s is not None \
                and elapsed > self.cfg.hang_threshold_s:
            cause = (f"engine call at seed offset {off} took "
                     f"{elapsed:.3f}s > hang_threshold_s="
                     f"{self.cfg.hang_threshold_s}")
            self._quarantined[job.signature] = cause
            self.stats.quarantined += 1
            for p in job.pending:
                if not p.future.done():
                    p.future.set_exception(QuarantinedError(
                        f"signature {job.signature[:12]} quarantined: "
                        f"{cause}"))
            return False
        job.obs_us += (time.perf_counter() - t0) * 1e6
        if exec_mod.trace_count() != tc0:
            job.recompiled = True  # a first sight pollutes the warm timing
        job.risks[:, off:off + q] = risks
        job.cum_e[:, off:off + q] = cum_e
        job.off = off + q
        job.quanta_run += 1
        return True

    def _finish(self, job: _Job) -> None:
        mean, ci95 = host_seed_stats(job.risks)
        full = MCResult(risks=job.risks, mean=mean.astype(np.float32),
                        ci95=ci95.astype(np.float32), cum_energy=job.cum_e,
                        bounds=None, plan=None)
        cancelled = expired = 0
        for p, (lo, hi) in zip(job.pending, job.spans):
            if p.future.done():  # cancelled mid-batch, or deadline fired
                if p.expired:
                    expired += 1
                else:
                    cancelled += 1
                continue
            p.future.set_result(slice_result(full, slice(lo, hi)))
        self.stats.cancelled += cancelled
        n_max = max(job.row_nodes)
        if job.layout is not None and not job.recompiled:
            key, choice = job.layout
            ent = self._layout_obs.setdefault(key, {}) \
                .setdefault(choice, [0.0, 0])
            ent[0] += job.obs_us
            # normalize by the *demanded* (unpadded) nodes: both layouts
            # serve the same traffic, so µs per demanded node compares
            # totals exactly — the merged layout's pad tax shows up as a
            # worse rate, not a bigger denominator
            ent[1] += sum(job.row_nodes)
            self.stats.layouts[f"{key[0][:12]}/{key[1]}"] = {
                k: round(v[0] / max(v[1], 1), 2)
                for k, v in self._layout_obs[key].items()}
        self.stats.batches.append({
            "signature": job.signature[:12],
            "requests": len(job.pending),
            "rows": job.n_rows,
            "seeds": job.seeds,
            "quanta": job.quanta_run,
            "cancelled": cancelled,
            "expired": expired,
            "n_max": n_max,
            "bucket": self._bucket(n_max) if self._bucketing else 0,
            "layout": job.layout[1] if job.layout is not None else None,
            "pad_flops_ratio": round(
                job.n_rows * n_max / sum(job.row_nodes), 4),
            "estimate_bytes": job.price[0],
            "scratch_bytes": job.price[1],
        })


# --------------------------------------------------------------------------
# synchronous convenience front-end
# --------------------------------------------------------------------------
def serve_sync(requests: Sequence[SweepRequest],
               cfg: McServeConfig = None,
               server: McSweepServer = None,
               device: DeviceLike = None) -> list:
    """One-shot synchronous façade: submit every request, coalesce, run
    to completion on a private event loop with the deterministic inline
    executor, return per-request `MCResult`s in submission order. The
    entry point of the `serve_mc` CLI. A new server runs on `device`
    (None: the CUDA card)."""

    async def go():
        srv = server if server is not None else McSweepServer(
            cfg if cfg is not None else McServeConfig(),
            executor=InlineExecutor(), device=device)
        tasks = [asyncio.ensure_future(srv.submit(r)) for r in requests]
        await asyncio.sleep(0)  # run each submit up to its future await
        await srv.drain()
        return await asyncio.gather(*tasks), srv

    results, srv = asyncio.run(go())
    serve_sync.last_stats = srv.stats  # introspection for bench/selftest
    return results


serve_sync.last_stats = None
