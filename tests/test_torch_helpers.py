"""Shared helpers of the PyTorch port's parity tests (no tests here).

The JAX reference is exact only under the ORIGINAL threefry layout
(ROADMAP §3, R1), which the installed JAX does not default to. Every
parity test therefore computes its JAX values inside
`jax_original_layout()` — scoped, never set globally, because a global
flag would leak into other test files on the same xdist worker. Inputs
cross between the packages as numpy arrays.
"""
from __future__ import annotations

import asyncio
import dataclasses

import numpy as np


def jax_original_layout():
    """Context manager: `jax.random` in the original threefry layout."""
    import jax

    return jax.threefry_partitionable(False)


def rel_err(a, b) -> float:
    """max |a − b| / |b| (with a floor that keeps exact zeros at 0)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def port_problem(jax_problem, device: str = "cpu"):
    """The port's problem on the reference problem's exact data arrays."""
    from repro_torch.core.mc.problems import problem_from_arrays

    return problem_from_arrays(
        jax_problem.kind,
        {k: np.asarray(v) for k, v in jax_problem.data.items()},
        jax_problem.n_nodes, jax_problem.dim, device=device)


def port_pc(pc):
    """The reference's ProblemConstants as the port's dataclass."""
    from repro_torch.core.theory import ProblemConstants

    return ProblemConstants(**dataclasses.asdict(pc))


def port_channel(cfg):
    """The reference's ChannelConfig as the port's dataclass."""
    from repro_torch.core.channel import ChannelConfig

    return ChannelConfig(**dataclasses.asdict(cfg))


# --------------------------------------------------------------------------
# the sweep server's deterministic harness: a virtual clock, an inline
# executor with a call trace and scripted hooks, and scripted clients —
# no wall-clock sleeps, no threads, no timing races
# --------------------------------------------------------------------------
class ManualClock:
    """Virtual time: `sleep(dt)` advances `now`, records `dt` in `sleeps`
    and yields once, so concurrent submissions interleave as under a real
    sleep."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def time(self) -> float:
        return self.now

    async def sleep(self, dt: float) -> None:
        self.sleeps.append(dt)
        self.now += dt
        await asyncio.sleep(0)


class TracingExecutor:
    """The server's inline execution (one cooperative yield, then the
    engine call on the loop thread, in issue order) with a call trace and
    scripted faults.

    calls:   the router's `info` dicts, one per engine quantum, in issue
             order: {"signature", "off", "quantum", "rows"}.
    after_call(k, hook): run `hook()` right after the k-th (0-based)
             quantum completes.
    fail_when(pred, exc): raise `exc` instead of running any quantum
             whose `info` satisfies `pred`.
    """

    def __init__(self):
        self.calls = []
        self._hooks = {}
        self._fail = None

    def after_call(self, k: int, hook) -> None:
        self._hooks.setdefault(k, []).append(hook)

    def fail_when(self, pred, exc: Exception) -> None:
        self._fail = (pred, exc)

    async def run(self, fn, info=None):
        idx = len(self.calls)
        self.calls.append(dict(info or {}))
        if self._fail is not None and self._fail[0](info or {}):
            raise self._fail[1]
        await asyncio.sleep(0)
        out = fn()
        for hook in self._hooks.get(idx, ()):
            hook()
        return out


class ScriptedClient:
    """One client, scripted: submit -> (optionally cancel) -> result."""

    def __init__(self, server, request):
        self.server = server
        self.request = request
        self.task = None

    def submit(self) -> "ScriptedClient":
        self.task = asyncio.ensure_future(self.server.submit(self.request))
        return self

    def cancel(self) -> None:
        self.task.cancel()

    def result(self):
        return self.task.result()


async def submit_all(server, requests) -> list:
    """Enqueue every request and tick the loop once, so each submission
    has been validated, admitted and parked on its future."""
    tasks = [asyncio.ensure_future(server.submit(r)) for r in requests]
    await asyncio.sleep(0)
    return tasks


def run(coro):
    """Drive one test coroutine on a fresh private event loop."""
    return asyncio.run(coro)


class ClockJump:
    """Jump a `ManualClock` forward by `dt` when called: attached with
    `TracingExecutor.after_call`, the quantum "took" `dt` seconds."""

    def __init__(self, clock, dt: float):
        self.clock = clock
        self.dt = dt

    def __call__(self) -> None:
        self.clock.now += self.dt


class FlakyOnce:
    """`fail_when` predicate matching only the first `times` calls that
    satisfy `match`: a transient, recoverable engine failure."""

    def __init__(self, match, times: int = 1):
        self.match = match
        self.times = times
        self.hits = 0

    def __call__(self, info: dict) -> bool:
        if self.hits < self.times and self.match(info):
            self.hits += 1
            return True
        return False
