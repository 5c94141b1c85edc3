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


# ------------------------------------------- the WKV backward kernel's order
# csrc/wkv6_bwd.cu's split of a (batch, head) per head dim (Split<D>):
# columns a lane owns and warps a block; kSub, the steps whose states a
# lane keeps in registers
WKV_SPLIT = {16: (4, 1), 32: (8, 2), 64: (16, 4)}
WKV_SUB = 8


def _fma(a, b, c):
    """fmaf: the product exact in f64, one rounding to f32."""
    return (a.double() * b.double() + c.double()).float()


def _tree(x, dim):
    """A balanced tree sum along `dim` (a power of two long), adjacent
    pairs first: an xor butterfly's or a reduce-scatter's order."""
    while x.shape[dim] > 1:
        x = x.unflatten(dim, (x.shape[dim] // 2, 2))
        x = x.select(dim + 1, 0) + x.select(dim + 1, 1)
    return x.squeeze(dim)


def _in_order(x, dim):
    """A sum along `dim` one term after another from 0, in order."""
    import torch

    acc = torch.zeros_like(x.select(dim, 0))
    for e in range(x.shape[dim]):
        acc = acc + x.select(dim, e)
    return acc


def wkv_kernel_order(r, k, v, w, u, s0, do, ds_fin):
    """The backward kernel's arithmetic (`csrc/wkv6_bwd.cu`) on (BH, T, D)
    f32 CPU tensors (u (BH, D), s0 and ds_fin (BH, D, D)), vectorized
    here over (BH, rows, lanes); returns (dr, dk, dv, dw, du, ds0). A
    (batch, head) is split into row groups of `rows` rows (blocks of
    `warps` warps); `lanes` lanes share a row, each owning `cols`
    consecutive columns. States: K3's checkpoints every
    `kernel.CKPT_STEPS` steps, each chunk walked forward once keeping
    every `WKV_SUB`-step sub-chunk's start, each sub-chunk re-walked,
    always with the forward's FMA s = fma(w, s, k v).
    Per step in reverse: x = Σ_j do_j S_ij, y = Σ_j dS_ij v_j and
    z = Σ_j dS_ij S_ij by FMAs over a lane's columns in order, then over
    the row's lanes by an xor butterfly (a balanced tree); v·do by FMAs
    over j in order, once a step; dr = fma(u k, v·do, x), dk = fma(r u,
    v·do, y), dw = z, du = fma(r k, v·do, du); dS_ij k_i summed over a
    warp's rows by a balanced tree (the shuffle reduce-scatter), over a
    group's warps in order (its partial), then over the groups' partials
    in order (the second pass); σ_g = Σ over a group's rows of fma(r u,
    k, ·) in order, summed over the groups in order; dv = fma(do_j, σ,
    the dv sum); dS ← fma(w_i, dS, r_i do_j)."""
    import torch

    from repro_torch.kernels.wkv import kernel

    bh, t, d = r.shape
    cols, warps = WKV_SPLIT[d]
    lanes = d // cols
    warp_rows = 32 // lanes
    rows = warps * warp_rows
    groups = d // rows
    chunk = kernel.CKPT_STEPS

    def step(s, tt):
        return _fma(w[:, tt, :, None], s, k[:, tt, :, None]
                    * v[:, tt, None, :])

    def lane_sum(a, b):
        """Σ_j a_ij b_ij (a or b broadcast along rows), over each lane's
        columns in order by FMAs, then the butterfly over the lanes."""
        a = a.expand(bh, d, d).reshape(bh, d, lanes, cols)
        b = b.expand(bh, d, d).reshape(bh, d, lanes, cols)
        acc = torch.zeros((bh, d, lanes))
        for c in range(cols):
            acc = _fma(a[..., c], b[..., c], acc)
        return _tree(acc, 2)

    vdo = torch.zeros((bh, t))
    for j in range(d):
        vdo = _fma(v[:, :, j], do[:, :, j], vdo)
    ruk = (r * u[:, None, :]).reshape(bh, t, groups, rows)
    kg = k.reshape(bh, t, groups, rows)
    sig_g = torch.zeros((bh, t, groups))
    for i in range(rows):
        sig_g = _fma(ruk[..., i], kg[..., i], sig_g)
    sig = _in_order(sig_g, 2)

    ckpts, s = [], s0
    for t0 in range(0, t, chunk):
        ckpts.append(s)
        for tt in range(t0, min(t0 + chunk, t)):
            s = step(s, tt)
    ds = ds_fin.clone()
    du = torch.zeros((bh, d))
    dr, dk, dv, dw = (torch.empty((bh, t, d)) for _ in range(4))
    for c in reversed(range(len(ckpts))):
        t0 = c * chunk
        n = min(chunk, t - t0)
        starts, s = [], ckpts[c]
        for sb in range(0, n, WKV_SUB):
            starts.append(s)
            for tt in range(t0 + sb, min(t0 + sb + WKV_SUB, t0 + n)):
                s = step(s, tt)
        for sb in reversed(range(len(starts))):
            lo = t0 + sb * WKV_SUB
            hi = min(lo + WKV_SUB, t0 + n)
            states = [starts[sb]]
            for tt in range(lo, hi - 1):
                states.append(step(states[-1], tt))
            for tt in reversed(range(lo, hi)):
                sp = states[tt - lo]
                r_i, k_i, w_i = r[:, tt], k[:, tt], w[:, tt]
                g, vv = do[:, tt, None, :], v[:, tt, None, :]
                x = lane_sum(g, sp)
                y = lane_sum(ds, vv)
                z = lane_sum(ds, sp)
                dr[:, tt] = _fma(u * k_i, vdo[:, tt, None], x)
                dk[:, tt] = _fma(r_i * u, vdo[:, tt, None], y)
                dw[:, tt] = z
                du = _fma(r_i * k_i, vdo[:, tt, None], du)
                part = _tree((ds * k_i[:, :, None]).reshape(
                    bh, groups, warps, warp_rows, d), 3)
                dv[:, tt] = _fma(do[:, tt], sig[:, tt, None],
                                 _in_order(_in_order(part, 2), 1))
                ds = _fma(w_i[:, :, None], ds, r_i[:, :, None] * g)
    return dr, dk, dv, dw, du, ds
