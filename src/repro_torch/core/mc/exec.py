"""Execution core of the Monte Carlo engine (port of `repro.core.mc.exec`).

`run_core` is the counterpart of the reference's `_mc_core_impl`: C sweep
rows × S seeds × `steps` slots. Where the reference nests
`vmap(rows) ∘ vmap(seeds) ∘ lax.scan(steps)`, the port lays all
trajectories on one flat batch axis B = C·S (trajectory b = c·S + s), keeps
every tensor `(B, …)` on the device, and steps a Python loop — one OTA
kernel launch per step covers all B trajectories of an OTA slot.

Mixed rows: where the reference switches per row on the algorithm
(`lax.switch`), the port groups rows by slot function. gbma, momentum and
nesterov share `_gbma_slot` and differ only in the per-row (gamma, nest)
carry, so they stay one group. The rows are put in group order once,
before the loop, so each group's trajectories are one contiguous slice
of every `(B, …)` tensor; each step runs every group's slot on its slice
with its trajectories' own keys and concatenates the updates. The order
is undone once, after the loop. Keys depend on the seed only, so no
stream shifts.

Randomness: trajectory b starts from `key(seed0 + s)`, its step keys are
`split(key, steps)`, and step t splits its key into (k_h, k_w) for the
gains and the edge noise — exactly the reference's streams. Two RNG
plans draw them, as in the reference: 'inscan' draws each step's streams
inside the loop; 'hoisted' (the default) draws every stream of all T
steps in one chain before the loop, through the algorithm's registered
`hoist_draws` twin (`slots` module docstring), and step t reads its
slice. The streams are identical bit for bit. The port lays the hoisted
draws out step-major, `(T, B, …)`, so step t's slice is one contiguous
`(B, …)` block that K1 reads without a copy. Hoisting costs
O(B·T·N) device memory where the per-step draws need O(B·N), and it
applies to single-algorithm calls only: a mixed call would draw every
algorithm's streams for every trajectory, so it keeps the per-step path
(the reference's rule). Participation draws a `(N_max,)` uniform per step
from `split(fold_in(key, 0x70617274), steps)`, hoisted under both plans as
in the reference, and a stochastic problem its minibatch indices from
`split(fold_in(key, 0x64617461), steps)`, hoisted with the slot draws:
the reference's disjoint streams.

Antennas: each slot group gets its own antenna axis, as long as the
largest count of its own rows (`slots.with_antennas`); in fig7 the gbma
group has M = 1 while the blind rows of the same call have 32 or 64.

Error feedback: when a row runs `blind_ec`, the loop carries a per-node
residual e `(B, N_max, d)`: rows with the flag transmit x = α(g + e),
α = min(1, √(budget / ‖g + e‖²)) per node, and keep e ← (g + e) − x
after participation masks x; every other row selects α = 1.

Seed reduction: `keep_seed_curves=False` reduces the `(C, S, steps+1)`
curves on the device to exact two-pass moments (mean, M2)
(`run_core(reduce_moments=True)`); only `(C, steps+1)` statistics leave
the device. Unchunked, they become (mean, ci95) there
(`device_seed_stats`).

Seed chunks (`run_chunked`): the seed axis runs in blocks of
`seed_chunk` seeds, so device memory scales with the chunk. A chunk's
seeds are data: chunk k replays seeds `seed0 + off … seed0 + off +
chunk` exactly. Kept curves stream into preallocated host arrays;
reduced ones Chan-merge (`chan_merge`) each chunk's moments into
`(C, steps+1)` accumulators on the device, updated in place. With
`resume_dir` the (fingerprint, cursor, accumulators) are checkpointed
after every chunk (`repro_torch.checkpoint.ckpt`), so an interrupted
sweep resumes bit for bit; with a `RetryPolicy` a chunk that raises is
rolled back and run again, replaying its streams.

`estimate_peak_bytes` is the reference's analytic memory model, its
terms unchanged; `plan.auto_plan` sizes seed chunks with it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import rng
from repro_torch.core.mc.slots import ALGO_REGISTRY, SlotCtx, with_antennas

# fold_in constants of the per-step minibatch-index stream (b"data") and
# node-participation stream (b"part"), disjoint from the slot keys and
# from each other
_DATA_STREAM = 0x64617461
_PART_STREAM = 0x70617274


def _slot_groups(algos: tuple) -> tuple:
    """Rows grouped by slot function, groups in order of first appearance:
    -> (row order (C,), [(slot_fn, first row, end row) in that order])."""
    fns = [ALGO_REGISTRY[a].slot_fn for a in algos]
    distinct = list(dict.fromkeys(fns))
    order = sorted(range(len(algos)), key=lambda c: distinct.index(fns[c]))
    groups, lo = [], 0
    for fn in distinct:
        hi = lo + fns.count(fn)
        groups.append((fn, lo, hi))
        lo = hi
    return np.asarray(order), groups


def _group_ctx(ctx: SlotCtx, lo: int, hi: int, n_antennas,
               m_per_row: Optional[tuple], n_seeds: int) -> SlotCtx:
    """The slot context of trajectories [lo, hi) (one slot group), with
    the group's own antenna setting: a static count, or the distinct
    per-row counts of the group's rows."""
    gctx = dataclasses.replace(
        ctx, p={k: v[lo:hi] for k, v in ctx.p.items()}, mask=ctx.mask[lo:hi],
        counts=ctx.counts[lo:hi])
    m_sizes = () if m_per_row is None else tuple(sorted(set(
        m_per_row[lo // n_seeds:hi // n_seeds])))
    return with_antennas(gctx, n_antennas, m_sizes)


def run_core(params: dict, betas: torch.Tensor, theta0: torch.Tensor,
             seed_ints: np.ndarray, data: dict, *, grad_fn, risk_fn,
             algos: tuple, fading: str, steps: int, n_sizes: tuple,
             invert_channel: bool = False, h_min: float = 0.3,
             ota_impl: str = "auto", phase_zero: bool = False,
             n_antennas: Optional[int] = None,
             m_per_row: Optional[tuple] = None, stochastic=None,
             rng_plan: str = "hoisted", reduce_moments: bool = False):
    """Run C rows × S seeds × `steps` slots, row c under `algos[c]`.

    params: per-row `(C,)` tensors (channel scalars, n_nodes, gamma,
    nest; `participation` when some row drops nodes; `ec` and
    `tx_budget` when some row runs error feedback; `n_antennas` with
    per-row counts; `b_count` (int) for minibatches); betas `(C,)`;
    theta0 `(d,)`; data: the stacked problem data (`(C, …)` leaves, mask
    `(C, N_max)`), all on one device. `n_sizes` are the call's distinct
    node counts. `n_antennas` is a static antenna count, `m_per_row` one
    count per row (or neither). `stochastic` is `(sample_indices_row,
    stochastic_grad_from_idx, b_max)` for a minibatch run, or None.
    `rng_plan`: 'hoisted' draws a single-algorithm call's streams for all
    steps before the loop, 'inscan' per step (module docstring).

    Step order, as in the reference's scan body: the gradient at the
    Nesterov lookahead θ − nest·β·γ·m (over this step's minibatch), the
    risk of θ BEFORE the update, the error-feedback truncation, the
    participation mask on the transmission x, the residual, the
    cumulative energy E_N·Σ‖x‖², the slot on x, then m ← γm + v and
    θ ← θ − βm; the final θ's risk is appended.

    Returns per-seed `(risks (C, S, steps+1), cum_energy (C, S, steps))`,
    or the seeds' exact two-pass `(mean, M2)` of shape `(C, steps+1)`
    when `reduce_moments`.
    """
    n_rows, n_seeds = betas.shape[0], len(seed_ints)
    batch = n_rows * n_seeds
    device = betas.device
    dim = theta0.shape[0]
    n_max = data["mask"].shape[1]

    order, groups = _slot_groups(algos)
    permuted = bool(np.any(order != np.arange(n_rows)))
    if permuted:  # group order, once: each group is one contiguous slice
        idx = torch.as_tensor(order, device=device)
        params = {k: v[idx] for k, v in params.items()}
        betas = betas[idx]
        data = {k: v[idx] for k, v in data.items()}
        if m_per_row is not None:
            m_per_row = tuple(m_per_row[c] for c in order)
    use_ec = any(ALGO_REGISTRY[a].error_feedback for a in algos)

    # per-trajectory (B,) views of the per-row params: b = c·S + s
    p = {k: v.repeat_interleave(n_seeds) for k, v in params.items()}
    beta = betas.repeat_interleave(n_seeds)
    ctx = SlotCtx(fading=fading, p=p,
                  mask=data["mask"].repeat_interleave(n_seeds, dim=0),
                  counts=p["n_nodes"].to(torch.int64), n_sizes=n_sizes,
                  invert_channel=invert_channel, h_min=h_min,
                  ota_impl=ota_impl, phase_zero=phase_zero)
    spans = [(fn, lo * n_seeds, hi * n_seeds) for fn, lo, hi in groups]
    group_ctx = [_group_ctx(ctx, lo, hi, n_antennas, m_per_row, n_seeds)
                 for _, lo, hi in spans]
    seeds = torch.as_tensor(np.asarray(seed_ints, np.int64), device=device)
    keys = rng.key(seeds.repeat(n_rows))
    step_keys = rng.split(keys, steps)  # (B, T, 2)
    # the reference's rule: one algorithm (its name, not its slot group)
    hoist = rng_plan == "hoisted" and len(set(algos)) == 1
    draws_all: Optional[dict] = None
    if hoist and ALGO_REGISTRY[algos[0]].hoist_draws is not None:
        draws_all = ALGO_REGISTRY[algos[0]].hoist_draws(
            step_keys.transpose(0, 1), group_ctx[0], n_max, dim)
    part = p.get("participation")
    part_u: Optional[torch.Tensor] = None
    if part is not None:  # (T, B, N_max), hoisted under both plans
        part_keys = rng.split(rng.fold_in(keys, _PART_STREAM), steps)
        part_u = rng.uniform(part_keys.transpose(0, 1), (n_max,))
    data_keys: Optional[torch.Tensor] = None
    idx_all: Optional[torch.Tensor] = None
    if stochastic is not None:
        sample_idx, sgrad_from_idx, b_max = stochastic
        data_keys = rng.split(rng.fold_in(keys, _DATA_STREAM), steps)
        if hoist:  # (T, B, N_max, b_max)
            idx_all = sample_idx(
                data, data_keys.transpose(0, 1).reshape(-1, 2),
                b_max).unflatten(0, (steps, batch))

    theta = theta0.to(torch.float32).expand(batch, dim).clone()
    m = torch.zeros_like(theta)
    e_res = torch.zeros((batch, n_max, dim), dtype=torch.float32,
                        device=device) if use_ec else None
    cum_e = torch.zeros(batch, dtype=torch.float32, device=device)
    risks = torch.empty((batch, steps + 1), dtype=torch.float32,
                        device=device)
    cum_curve = torch.empty((batch, steps), dtype=torch.float32,
                            device=device)
    lookahead = (p["nest"] * beta * p["gamma"])[:, None]

    def grid(t: torch.Tensor) -> torch.Tensor:
        return t.view(n_rows, n_seeds, dim)

    for t in range(steps):
        theta_eval = theta - lookahead * m
        if data_keys is None:
            g = grad_fn(data, grid(theta_eval))
        else:
            idx = idx_all[t] if idx_all is not None \
                else sample_idx(data, data_keys[:, t], b_max)
            g = sgrad_from_idx(data, grid(theta_eval),
                               idx.view(n_rows, n_seeds, n_max, b_max),
                               params["b_count"])
        x = g.reshape(batch, n_max, dim)
        risks[:, t] = risk_fn(data, grid(theta)).reshape(batch)
        if use_ec:
            u = x + p["ec"][:, None, None] * e_res
            sq = (u * u).sum(dim=2)
            alpha = torch.minimum(torch.ones_like(sq), torch.sqrt(
                p["tx_budget"][:, None] / sq.clamp_min(1e-30)))
            # select, don't blend: inf/inf is NaN (an overflowing row under
            # the unbounded default budget), and 0·NaN would leak into
            # rows without the flag
            alpha = torch.where(p["ec"][:, None] > 0, alpha, 1.0)
            x = alpha[:, :, None] * u
        if part_u is not None:
            # a dropped node transmits nothing this slot and spends no
            # energy; the edge still divides by the full N
            x = (part_u[t] < part[:, None]).to(torch.float32)[:, :, None] * x
        if use_ec:
            # the residual sees the MASKED transmission: a dropped node
            # carries its whole update forward
            e_res = p["ec"][:, None, None] * (u - x)
        cum_e = cum_e + p["energy"] * (x * x).sum(dim=(1, 2))
        cum_curve[:, t] = cum_e
        k_t = step_keys[:, t]
        if draws_all is not None:
            v = spans[0][0](x, k_t, dataclasses.replace(
                group_ctx[0], draws={k: d[t] for k, d in draws_all.items()}))
        elif len(spans) == 1:
            v = spans[0][0](x, k_t, group_ctx[0])
        else:
            v = torch.cat([fn(x[lo:hi], k_t[lo:hi], gctx)
                           for (fn, lo, hi), gctx in zip(spans, group_ctx)])
        m = p["gamma"][:, None] * m + v
        theta = theta - beta[:, None] * m
    risks[:, steps] = risk_fn(data, grid(theta)).reshape(batch)

    risks = risks.view(n_rows, n_seeds, steps + 1)
    cum_curve = cum_curve.view(n_rows, n_seeds, steps)
    if permuted:  # back to the caller's row order
        inv = torch.as_tensor(np.argsort(order), device=device)
        risks, cum_curve = risks[inv], cum_curve[inv]
    if reduce_moments:
        mean = risks.mean(dim=1)
        return mean, (risks - mean[:, None, :]).square().sum(dim=1)
    return risks, cum_curve


def device_seed_stats(mean: torch.Tensor, m2: torch.Tensor,
                      n: int) -> tuple:
    """On-device (mean, ci95) of n seeds' two-pass moments: ci95 =
    1.96·std(ddof=1)/√n — the formula of `host_seed_stats`, so the
    unchunked paths agree."""
    if n > 1:
        return mean, 1.96 * torch.sqrt(m2 / (n - 1)) / math.sqrt(n)
    return mean, torch.zeros_like(mean)


def host_seed_stats(risks: np.ndarray) -> tuple:
    """(C, S, steps+1) curves -> (mean, ci95), the host-side seed
    reduction (the reference's definition)."""
    seeds = risks.shape[1]
    mean = np.mean(risks, axis=1)
    if seeds > 1:
        ci95 = 1.96 * np.std(risks, axis=1, ddof=1) / np.sqrt(seeds)
    else:
        ci95 = np.zeros_like(mean)
    return mean, ci95


def chan_merge(mean_a, m2_a, n_a, mean_b, m2_b, n_b):
    """Chan's parallel-variance merge of two (mean, M2, n) moment groups
    (M2 = Σ(x − mean)²), elementwise on tensors or arrays; the counts are
    numbers. Exact in exact arithmetic and stable where the one-pass
    (Σx, Σx²) accumulator cancels. With n_a = 0 the result is group b
    exactly (delta·1 = mean_b, the cross term 0), so a sweep's first
    chunk keeps its own two-pass moments. The count ratios are f32, as
    the reference computes them."""
    n = np.float32(n_a) + np.float32(n_b)
    delta = mean_b - mean_a
    mean = mean_a + delta * float(np.float32(n_b) / n)
    m2 = m2_a + m2_b \
        + delta * delta * float(np.float32(n_a) * np.float32(n_b) / n)
    return mean, m2


def finalize_merged_stats(mean: np.ndarray, m2: np.ndarray,
                          n_seeds: int) -> tuple:
    """Chan-merged (mean, M2) of n seeds -> (mean, ci95), the ddof=1
    sample variance. M2 is nonnegative up to the merge's rounding, hence
    the max with 0."""
    if n_seeds > 1:
        var = np.maximum(0.0, np.asarray(m2)) / (n_seeds - 1)
        ci95 = 1.96 * np.sqrt(var / n_seeds)
    else:
        ci95 = np.zeros_like(mean)
    return np.asarray(mean), ci95


# --------------------------------------------------------------------------
# seed-chunked scheduler (+ resume + chunk-level fault isolation)
# --------------------------------------------------------------------------
_RESUME_FILE = "mc_chunked_resume.npz"

# Fault-injection seam: hooks fire at the START of every chunk attempt
# with {"off": int, "attempt": int, "stage": "moments"|"curves"}; a hook
# that raises makes that attempt fail.
_CHUNK_FAULT_HOOKS = []


def install_chunk_fault_hook(hook):
    """Register a chunk-attempt hook (fault injection); returns a
    remover. Hooks see every attempt of every chunk and may raise to
    make that attempt fail."""
    _CHUNK_FAULT_HOOKS.append(hook)

    def remove():
        try:
            _CHUNK_FAULT_HOOKS.remove(hook)
        except ValueError:
            pass
    return remove


def _attempt_chunk(retry, off, stage, attempt_fn, reset_fn=None):
    """Run one chunk under the plan's `RetryPolicy`: on an exception the
    accumulators roll back (`reset_fn`), the policy's backoff waits and
    the chunk runs again, replaying its counter-based streams.
    `retry=None` (or an exhausted budget) re-raises: the checkpoint on
    disk stays at the last finished chunk."""
    attempt = 1
    while True:
        try:
            for hook in list(_CHUNK_FAULT_HOOKS):
                hook({"off": int(off), "attempt": attempt, "stage": stage})
            return attempt_fn()
        except Exception:
            if retry is None or attempt >= retry.max_attempts:
                raise
            if reset_fn is not None:
                reset_fn()
            retry.wait(attempt)
            attempt += 1


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _hash_array_leaf(h, name, value) -> None:
    """A tensor (as its CPU numpy bytes) or array into a hash, with its
    dtype and shape."""
    arr = _numpy(value)
    h.update(f"{name}:{arr.dtype.str}:{arr.shape};".encode())
    h.update(np.ascontiguousarray(arr).tobytes())


def _stable(value):
    """A static facet in a form whose repr is the same in every process:
    callables by qualname (their reprs hold addresses), inside tuples and
    lists too."""
    if callable(value):
        return getattr(value, "__qualname__", repr(value))
    if isinstance(value, (tuple, list)):
        return tuple(_stable(v) for v in value)
    return value


def _hash_static_kwargs(h, statics: dict) -> None:
    """Feed static facets (shapes, flags, registry callables) into a
    hash, by `_stable` repr."""
    for name in sorted(statics):
        h.update(f"{name}={_stable(statics[name])!r};".encode())


def static_signature(statics: dict) -> str:
    """sha256 hex digest over one engine call's static facets only
    (shapes, flags, registry callables), no array data: two calls with
    equal signatures run the same program on different data."""
    h = hashlib.sha256()
    _hash_static_kwargs(h, statics)
    return h.hexdigest()


def _workload_fingerprint(params, betas, theta0, seed_ints, data,
                          seed_chunk, n_rows, core_kwargs) -> np.ndarray:
    """sha256 identity of a chunked sweep, as a (32,) uint8 leaf.

    Covers the static core kwargs (callables by qualname), the numeric
    workload (params, stepsizes, θ0, problem data), the seed ints, the
    chunk size, the row count and the device type ('cuda' or 'cpu',
    never an index: the accumulators' bits depend on the device's
    arithmetic, not on which card). Two sweeps with equal fingerprints
    replay the same chunk streams in the same order, so a checkpoint of
    one resumes the other bit for bit."""
    h = hashlib.sha256()
    _hash_static_kwargs(h, core_kwargs)
    for name in sorted(params):
        _hash_array_leaf(h, f"params.{name}", params[name])
    for name in sorted(data):
        _hash_array_leaf(h, f"data.{name}", data[name])
    _hash_array_leaf(h, "betas", betas)
    _hash_array_leaf(h, "theta0", theta0)
    h.update(np.ascontiguousarray(
        np.asarray(seed_ints, np.int64)).tobytes())
    h.update(f"chunk={seed_chunk};rows={n_rows};"
             f"device={betas.device.type};".encode())
    return np.frombuffer(h.digest(), np.uint8)


def _mc_moments_merge(acc_mean, acc_m2, n_prev, params, betas, theta0,
                      seed_ints, data, **core_kwargs) -> None:
    """One seed chunk's two-pass moments Chan-merged into the running
    `(C, steps+1)` (mean, M2) accumulators, in place; `n_prev` seeds are
    in them already."""
    bmean, bm2 = run_core(params, betas, theta0, seed_ints, data,
                          reduce_moments=True, **core_kwargs)
    mean, m2 = chan_merge(acc_mean, acc_m2, n_prev, bmean, bm2,
                          len(seed_ints))
    acc_mean.copy_(mean)
    acc_m2.copy_(m2)


def _load_resume(resume_dir: str, fp: np.ndarray):
    """(checkpoint path, raw checkpoint or None) of a sweep's resume
    directory: the main file, or `.prev` when the main one is corrupt; a
    warning and None when no intact file is left; a ValueError for
    another workload's checkpoint."""
    path = os.path.join(resume_dir, _RESUME_FILE)
    candidates = [c for c in (path, path + ckpt.PREV_SUFFIX)
                  if os.path.exists(c)]
    raw = None
    for cand in candidates:
        try:
            raw = ckpt.peek(cand)
            break
        except ckpt.CheckpointCorrupt as e:
            # fall back to the rotated file: a torn newest write costs
            # at most one chunk of progress
            warnings.warn(f"ignoring corrupt resume checkpoint: {e}")
    if raw is None:
        if candidates:
            warnings.warn(f"no intact resume checkpoint under {resume_dir} "
                          "— restarting the sweep from the first chunk")
        return path, None
    if not np.array_equal(raw.get("fingerprint"), fp):
        raise ValueError(
            f"checkpoint at {path} belongs to a different workload "
            "(fingerprint mismatch) — point resume_dir at this sweep's own "
            "directory or remove the stale checkpoint")
    return path, raw


def run_chunked(params, betas, theta0, seed_ints, data, *, seed_chunk,
                keep_seed_curves, core_kwargs, resume_dir=None, retry=None):
    """Run the seed axis in blocks of `seed_chunk` (a chunk's seed ints
    are data). Returns (risks, cum_energy, mean, ci95) as numpy arrays,
    the first two None when `keep_seed_curves=False`.

    Device memory per chunk scales with C · seed_chunk: kept curves
    stream into preallocated host arrays, reduced ones Chan-merge into
    `(C, steps+1)` accumulators on the device.

    `resume_dir` (reduced path only) checkpoints (fingerprint, chunk
    cursor, accumulators) to `<resume_dir>/mc_chunked_resume.npz` after
    every chunk and restores from it: the sweep restarts at the first
    unfinished chunk, and a finished sweep goes straight to its
    statistics. Counter-based RNG replays each chunk's streams and the
    f32 host round trip keeps every value, so an interrupted-then-resumed
    sweep equals an uninterrupted one bit for bit. Another workload's
    checkpoint raises; a corrupt one falls back to `.prev`, and when both
    are bad the sweep restarts with a warning.

    `retry` (a `plan.RetryPolicy`): a chunk that raises is rolled back to
    a host snapshot of the accumulators and run again. The checkpoint
    save is outside the retry: a failed save raises.
    """
    seeds = len(seed_ints)
    if seed_chunk <= 0:
        raise ValueError(f"seed_chunk must be positive, got {seed_chunk}")
    if seeds % seed_chunk != 0:
        raise ValueError(
            f"seeds ({seeds}) must divide into seed_chunk ({seed_chunk}) "
            "blocks — pad the seed count or pick a chunk that divides it")
    steps = core_kwargs["steps"]
    n_rows = len(betas)
    if keep_seed_curves:
        if resume_dir is not None:
            raise ValueError(
                "resume_dir requires the reduced-moments path "
                "(keep_seed_curves=False): per-seed curves are not "
                "checkpointed between chunks")
        risks = np.empty((n_rows, seeds, steps + 1), np.float32)
        cum_e = np.empty((n_rows, seeds, steps), np.float32)
        for off in range(0, seeds, seed_chunk):
            blk = seed_ints[off:off + seed_chunk]

            def _run(blk=blk):
                r, ce = run_core(params, betas, theta0, blk, data,
                                 **core_kwargs)
                return r.cpu().numpy(), ce.cpu().numpy()

            r, ce = _attempt_chunk(retry, off, "curves", _run)
            risks[:, off:off + seed_chunk] = r
            cum_e[:, off:off + seed_chunk] = ce
        return (risks, cum_e) + host_seed_stats(risks)
    fp = _workload_fingerprint(params, betas, theta0, seed_ints, data,
                               seed_chunk, n_rows, core_kwargs)
    start = 0
    acc_mean = torch.zeros((n_rows, steps + 1), dtype=torch.float32,
                           device=betas.device)
    acc_m2 = torch.zeros_like(acc_mean)
    ckpt_path = None
    if resume_dir is not None:
        ckpt_path, raw = _load_resume(resume_dir, fp)
        if raw is not None:
            start = int(raw["next_off"])
            acc_mean.copy_(torch.from_numpy(raw["acc_mean"]))
            acc_m2.copy_(torch.from_numpy(raw["acc_m2"]))
    for off in range(start, seeds, seed_chunk):
        blk = seed_ints[off:off + seed_chunk]
        # a host snapshot to roll a failed attempt back to (the f32 round
        # trip keeps every value, so bit-identity holds)
        snap = (acc_mean.cpu().numpy().copy(), acc_m2.cpu().numpy().copy()) \
            if retry is not None else None

        def _merge(blk=blk, off=off):
            _mc_moments_merge(acc_mean, acc_m2, off, params, betas, theta0,
                              blk, data, **core_kwargs)

        def _reset(snap=snap):
            acc_mean.copy_(torch.from_numpy(snap[0]))
            acc_m2.copy_(torch.from_numpy(snap[1]))

        _attempt_chunk(retry, off, "moments", _merge,
                       _reset if retry is not None else None)
        if ckpt_path is not None:
            ckpt.save(ckpt_path, {
                "fingerprint": fp,
                "next_off": np.int64(off + seed_chunk),
                "acc_mean": acc_mean.cpu().numpy(),
                "acc_m2": acc_m2.cpu().numpy()})
    mean, ci95 = finalize_merged_stats(
        acc_mean.cpu().numpy(), acc_m2.cpu().numpy(), seeds)
    return None, None, mean, ci95


# --------------------------------------------------------------------------
# analytic memory model
# --------------------------------------------------------------------------
_F32 = 4  # bytes


def estimate_peak_bytes(*, n_rows: int, seeds: int, steps: int, n_max: int,
                        dim: int, algo_set=("gbma",), seed_chunk=None,
                        n_antennas=None, m_sizes=(), b_max: int = 0,
                        keep_seed_curves: bool = True,
                        rng_plan: str = "hoisted",
                        invert_channel: bool = False,
                        participation_on: bool = False,
                        n_shards: int = 1, row_shards: int = 1) -> dict:
    """The reference's analytic peak-memory estimate (bytes) of one engine
    call, its terms and keys unchanged, so `plan.auto_plan` chooses on the
    same inputs what the reference chooses.

    Counts the buffers that scale with C · S_live · steps (S_live =
    seed_chunk when chunking, else every seed): the hoisted draws
    (`slots.hoist_draw_elems`; single-algorithm calls under the hoisted
    plan, the participation stream under both), the per-seed curves and
    two `(N_max, d)` gradient temporaries per trajectory. It does not
    count what the port's eager threefry holds while it draws (int64
    counters and hashes, f64 intermediates): `chip_smoke.py` prints the
    card's measured peak beside this estimate. `per_device_peak_bytes`
    divides by the (row_shards × n_shards) mesh."""
    from repro_torch.core.mc import slots

    s_live = seeds if seed_chunk is None else min(seed_chunk, seeds)
    m_live = max(m_sizes) if m_sizes else (n_antennas or 1)
    per_traj_draws = 0
    if rng_plan == "hoisted" and len(algo_set) == 1:
        for a in algo_set:
            per_traj_draws += slots.hoist_draw_elems(
                a, steps=steps, n_max=n_max, dim=dim, m_live=m_live,
                invert_channel=invert_channel)
        if b_max > 0:
            per_traj_draws += steps * n_max * b_max  # minibatch indices
    if participation_on:
        per_traj_draws += steps * n_max
    draw_bytes = n_rows * s_live * per_traj_draws * _F32
    # per-seed curves: risks (steps+1) + cum_energy (steps) per trajectory
    curve_bytes = n_rows * s_live * (2 * steps + 1) * _F32
    # per-step live temporaries: transmitted g + one working copy
    temp_bytes = 2 * n_rows * s_live * n_max * dim * _F32
    host_bytes = (n_rows * seeds * (2 * steps + 1) * _F32
                  if keep_seed_curves else 0)
    device_total = draw_bytes + curve_bytes + temp_bytes
    mesh_size = max(n_shards, 1) * max(row_shards, 1)
    return {
        "device_peak_bytes": device_total,
        "per_device_peak_bytes": -(-device_total // mesh_size),
        "rng_draw_bytes": draw_bytes,
        "curve_bytes": curve_bytes,
        "grad_temp_bytes": temp_bytes,
        "host_curve_bytes": host_bytes,
        "s_live": s_live,
    }
