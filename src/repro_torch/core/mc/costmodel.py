"""Measured per-workload cost model for the Monte Carlo engine (port of
`repro.core.mc.costmodel`).

The execution layer prices its choices with an analytic memory model
(`exec.estimate_peak_bytes`) and an assumed cache-resident chunk target.
This module folds the MEASURED cost of the port's `run_mc` on its device
into the planner's and the sweep server's decisions.

Three pieces, as in the reference:

* **Calibration** (`calibrate` / `python -m repro_torch.core.mc.costmodel`):
  a one-time microbench suite — per-slot warm step time over an (algo
  family × N × dim) grid, a dispatch-overhead probe (chunked vs all-live
  on the same workload), a chunk-size working-set profile (warm step
  time vs live bytes), a first-sight probe, and the machine peaks
  (`measure_machine_peaks`: f32 matmul GFLOP/s with TF32 off and a
  64 MiB read+write pass, GiB/s, both plain library calls used as
  yardsticks). Results persist as a **versioned JSON calibration
  artifact** keyed by `<platform>/<device_count>` — `cuda/1` on one card,
  `cpu/1` on the CPU — in the reference's format, at
  `src/repro_torch/core/mc/CALIBRATION_mc.json` (override with the
  `REPRO_TORCH_CALIBRATION_PATH` environment variable). A version bump or
  a platform/device-count mismatch makes an entry stale: it is not
  loaded. Each entry records the torch and CUDA versions and, on the
  card, its name and power limit as `nvidia-smi` prints them.

* **`CostModel`** — `predict_step_us(plan, workload)` and
  `predict_run_us(plan, workload)`: the predicted per-(row, seed, step)
  slot time and the wall-clock of one engine call under an `ExecPlan`.
  Slot time is a nonnegative linear fit over the analytic slot FLOPs
  (`mc_slot_model`), scaled by the working-set profile factor at the
  plan's live bytes; run time adds `dispatch_us` per seed chunk. Every
  term is clamped nonnegative, so predictions are monotone
  non-decreasing in N, seeds and steps. `analytic_cost_model()` builds
  the same interface from the closed-form slot model and the reference's
  nominal constants (so its predictions equal the reference's): the
  fallback when no calibration entry exists.

* **Consumers** — `plan.auto_plan(..., cost_model="measured")` re-prices
  `seed_chunk` (deviating from the analytic choice only for a predicted
  win > 5 %, and the analytic path exactly when no entry matches); the
  sweep server (`repro_torch.serving.mc_server`) prices merged-vs-
  separate batches with `predict_run_us` plus `compile_s` for unseen
  shape classes.

The port has no jit: `compile_s` is the extra wall of a program shape's
first run (`exec.trace_count`), which on the card is the caching
allocator's growth and the library handles' set-up. `dispatch_us` is the
per-call cost of row assembly, host issue and the device→host copy; on
the card a call's step loop issues its launches whatever the batch's
width, so most of a small call's wall lands there. One departure from
the reference's arithmetic follows from that: a working-set profile point
whose whole time the subtracted dispatch covers is left out, where the
reference clamps it to ~0 and so scales every other point by ~1e10.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

CALIBRATION_VERSION = 1
# nominal CPU-class ceilings for the analytic fallback model (the
# reference's constants); a calibration artifact replaces them
_NOMINAL_PEAKS = {"peak_gflops": 8.0, "peak_gibs": 6.0}
_US = 1e6
CALIBRATION_ENV = "REPRO_TORCH_CALIBRATION_PATH"


def default_calibration_path() -> str:
    """The artifact location: `REPRO_TORCH_CALIBRATION_PATH` when set,
    else the port's tracked `CALIBRATION_mc.json` beside this module."""
    env = os.environ.get(CALIBRATION_ENV)
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "CALIBRATION_mc.json")


def platform_key(device_count: Optional[int] = None,
                 platform: Optional[str] = None,
                 device: DeviceLike = None) -> str:
    """Artifact entry key `<platform>/<device_count>`, the staleness axes:
    `cuda/<torch.cuda.device_count()>` for a CUDA device, `cpu/1` for the
    CPU. The platform comes from `device` (None: the CUDA card, which
    raises where CUDA is absent) unless `platform` is given."""
    if platform is None:
        platform = resolve_device(device).type
    if device_count is None:
        device_count = torch.cuda.device_count() if platform == "cuda" \
            else 1
    return f"{platform}/{int(device_count)}"


# --------------------------------------------------------------------------
# analytic slot model + machine peaks
# --------------------------------------------------------------------------
def mc_slot_model(algo: str, n: int, d: int, m: int = 1) -> dict:
    """Analytic per-(row, seed, step) cost of one engine slot, f32 — the
    reference's model, term for term.

    gbma (single antenna): flops 8·N·d + 2·d² (gradient 4·N·d, energy
    2·N·d, superposition 2·N·d, risk 2·d²); bytes (5·N·d + N)·4.

    blind (M antennas): flops 6·N·d + 2·d² + M·(4·N·d + 6·d); bytes
    (3·N·d + M·(2·N·d + 2·N))·4.

    A model, not a count of the port's kernels: treat ratios, not
    digits, as the signal."""
    if algo == "gbma":
        flops = 8 * n * d + 2 * d * d
        bytes_ = (5 * n * d + n) * 4
    elif algo == "blind":
        flops = 6 * n * d + 2 * d * d + m * (4 * n * d + 6 * d)
        bytes_ = (3 * n * d + m * (2 * n * d + 2 * n)) * 4
    else:
        raise ValueError(f"no slot model for algo {algo!r}")
    return {"flops": flops, "bytes": bytes_,
            "intensity": flops / bytes_}


def _algo_family(algo: str) -> str:
    """The slot-model family whose dominant terms `algo` shares: blind
    (M-antenna MRC) or gbma (every single-antenna algorithm)."""
    from repro_torch.core.mc.slots import ALGO_REGISTRY

    spec = ALGO_REGISTRY.get(algo)
    return "blind" if (spec is not None and spec.blind) else "gbma"


def _timed_best(fn, dev: torch.device, reps: int) -> float:
    """Best-of-`reps` seconds of `fn()`, the device synchronized before
    the clock starts and before it stops."""
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def measure_machine_peaks(dim: int = 1536, reps: int = 3,
                          device: DeviceLike = None) -> dict:
    """Microbenchmarked peaks of `device` (None: the CUDA card): f32
    matmul GFLOP/s (TF32 off, `_device`) and a 64 MiB read+write pass,
    GiB/s. Both are plain library calls, used as yardsticks."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    a = torch.rand((dim, dim), generator=gen, dtype=torch.float32).to(dev)
    # best of reps + 1: the first call pays the library handles' and the
    # allocator's set-up
    t_mm = _timed_best(lambda: torch.matmul(a, a), dev, reps + 1)
    big = torch.rand((64 * 2**20 // 4,), generator=gen,
                     dtype=torch.float32).to(dev)
    t_bw = _timed_best(lambda: big + 1.0, dev, reps + 1)
    return {"peak_gflops": 2 * dim**3 / t_mm / 1e9,
            "peak_gibs": 2 * big.numel() * 4 / t_bw / 2**30}


def cached_machine_peaks(dim: int = 1536, reps: int = 3, *,
                         path: Optional[str] = None,
                         device_count: Optional[int] = None,
                         device: DeviceLike = None,
                         measure=None,
                         write: bool = True) -> dict:
    """Machine peaks through the calibration artifact: the stored peaks
    when this platform/device-count has an entry, else measured once
    (`measure(dim=, reps=)`, default `measure_machine_peaks` on `device`)
    and (best-effort) persisted as a peaks-only entry. The entry key is
    the staleness check."""
    if measure is None:
        def measure(dim, reps):
            return measure_machine_peaks(dim, reps, device=device)
    path = default_calibration_path() if path is None else path
    key = platform_key(device_count, device=device)
    data = _read_artifact(path)
    entry = (data or {}).get("entries", {}).get(key)
    if entry and "peaks" in entry:
        return dict(entry["peaks"])
    peaks = measure(dim=dim, reps=reps)
    if write:
        try:
            _write_entry(path, key, {"peaks": peaks, "peaks_dim": dim})
        except OSError:
            pass  # read-only checkout: serve the measurement, skip caching
    return peaks


def _read_artifact(path: str) -> Optional[dict]:
    """The artifact dict, or None when missing/unreadable/stale-version."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict) \
            or data.get("version") != CALIBRATION_VERSION:
        return None
    return data


def _write_entry(path: str, key: str, entry: dict) -> None:
    data = _read_artifact(path) or {"version": CALIBRATION_VERSION,
                                    "entries": {}}
    merged = dict(data["entries"].get(key, {}))
    merged.update(entry)
    data["entries"][key] = merged
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


# --------------------------------------------------------------------------
# configuration / workload records
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """The calibration suite's knobs (the reference's defaults).

    n_grid / dim_grid: the (N, dim) grid each algo family's warm slot
        time is sampled on — the regressor of the linear step-time fit.
    steps / seeds: horizon and seed count of every calibration run.
    chunk_probe: seed_chunk of the chunked side of the dispatch probe.
    probe_seeds: seed count of the working-set profile probe.
    warm_reps: best-of repetitions per timed measurement.
    algos: algorithm families to fit (one coefficient pair each).
    peaks_dim: matmul size of the machine-peaks microbench.
    """

    n_grid: tuple = (64, 256, 1024)
    dim_grid: tuple = (8, 24)
    steps: int = 60
    seeds: int = 8
    chunk_probe: int = 2
    probe_seeds: int = 128
    warm_reps: int = 3
    algos: tuple = ("gbma", "blind")
    peaks_dim: int = 1536

    @classmethod
    def smoke(cls) -> "CalibrationConfig":
        """CI-size suite: every probe exercised, nothing slow."""
        return cls(n_grid=(16, 48), dim_grid=(4, 8), steps=20, seeds=4,
                   chunk_probe=2, probe_seeds=16, warm_reps=2,
                   peaks_dim=256)


@dataclasses.dataclass(frozen=True)
class Workload:
    """The cost-relevant shape of one engine call (padded batch view):
    `n_max` is the padded node count every row pays, `m_sizes` the
    antenna counts present (max is the padded M)."""

    n_rows: int
    seeds: int
    steps: int
    n_max: int
    dim: int
    algo_set: tuple = ("gbma",)
    m_sizes: tuple = ()
    b_max: int = 0


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CostModel:
    """Predicted engine-call cost under an `ExecPlan` (module docstring).

    coeffs: per-family nonnegative (family, c0_us, c1_us_per_flop) of the
        linear slot-time fit `step_us = c0 + c1 · slot_flops`.
    dispatch_us: fixed per-engine-call overhead — every seed chunk pays
        it once.
    compile_s: the extra wall of an unseen program shape's first run —
        consumers add it for shape classes they have not executed yet.
    chunk_profile: ((live_bytes, factor), ...) — measured slowdown of the
        slot time as the live working set grows; non-decreasing factors.
    peaks: microbenchmarked {peak_gflops, peak_gibs}.
    source: 'measured' (calibration artifact) or 'analytic' (fallback).
    """

    coeffs: tuple  # ((family, c0_us, c1_us), ...)
    dispatch_us: float
    compile_s: float
    chunk_profile: tuple  # ((live_bytes, factor), ...) sorted, monotone
    peaks: tuple  # (("peak_gflops", v), ("peak_gibs", v))
    source: str = "analytic"

    def _coeff(self, family: str) -> Optional[tuple]:
        for fam, c0, c1 in self.coeffs:
            if fam == family:
                return c0, c1
        return None

    def _profile_factor(self, live_bytes: float) -> float:
        prof = self.chunk_profile
        if not prof:
            return 1.0
        if live_bytes <= prof[0][0]:
            return prof[0][1]
        for (b0, f0), (b1, f1) in zip(prof, prof[1:]):
            if live_bytes <= b1:
                t = (live_bytes - b0) / max(b1 - b0, 1.0)
                return f0 + t * (f1 - f0)
        return prof[-1][1]  # clamp: beyond the probed range

    def step_us(self, algo: str, n: int, dim: int, m: int = 1,
                live_bytes: Optional[float] = None) -> float:
        """Predicted per-(row, seed, step) slot time in microseconds."""
        fam = _algo_family(algo)
        model = mc_slot_model(fam, n, dim, max(m, 1))
        co = self._coeff(fam)
        if co is not None:
            base = co[0] + co[1] * model["flops"]
        else:
            peaks = dict(self.peaks)
            base = _US * max(
                model["flops"] / (peaks["peak_gflops"] * 1e9),
                model["bytes"] / (peaks["peak_gibs"] * 2**30))
        if live_bytes is not None:
            base *= self._profile_factor(float(live_bytes))
        return base

    def _live_bytes(self, plan, wl: Workload,
                    device_count: Optional[int] = None) -> int:
        from repro_torch.core.mc.exec import estimate_peak_bytes
        from repro_torch.core.mc.plan import resolve_seed_shards

        n_sh = resolve_seed_shards(plan, wl.seeds,
                                   device_count=device_count)
        est = estimate_peak_bytes(
            n_rows=wl.n_rows, seeds=wl.seeds, steps=wl.steps,
            n_max=wl.n_max, dim=wl.dim, algo_set=tuple(wl.algo_set),
            seed_chunk=plan.seed_chunk, m_sizes=tuple(wl.m_sizes),
            b_max=wl.b_max, keep_seed_curves=False,
            rng_plan=plan.rng_plan, n_shards=max(n_sh, 1),
            row_shards=max(plan.row_shards, 1))
        return est["per_device_peak_bytes"]

    def predict_step_us(self, plan, wl: Workload,
                        device_count: Optional[int] = None) -> float:
        """Per-(row, seed, step) slot time of `wl` under `plan`: the
        padded n_max every row pays, at the plan's working set."""
        live = self._live_bytes(plan, wl, device_count)
        m = max(wl.m_sizes) if wl.m_sizes else 1
        return max(self.step_us(a, wl.n_max, wl.dim, m, live_bytes=live)
                   for a in wl.algo_set)

    def predict_run_us(self, plan, wl: Workload,
                       device_count: Optional[int] = None) -> float:
        """Predicted wall-clock (µs) of one engine call under `plan`: the
        compute term over the plan's device mesh plus `dispatch_us` per
        seed chunk. Monotone non-decreasing in N, seeds and steps."""
        from repro_torch.core.mc.plan import resolve_seed_shards

        step = self.predict_step_us(plan, wl, device_count)
        chunk = plan.seed_chunk if plan.seed_chunk else wl.seeds
        n_calls = -(-wl.seeds // max(chunk, 1))
        n_sh = resolve_seed_shards(plan, wl.seeds,
                                   device_count=device_count)
        mesh = max(n_sh, 1) * max(plan.row_shards, 1)
        compute = wl.n_rows * wl.seeds * wl.steps * step / mesh
        return compute + n_calls * self.dispatch_us


def analytic_cost_model(peaks: Optional[dict] = None) -> CostModel:
    """The calibration-free fallback: closed-form slot costs over nominal
    (or supplied) peaks and the reference's dispatch, first-sight and
    profile constants, so its predictions equal the reference's."""
    from repro_torch.core.mc.plan import DEFAULT_CHUNK_TARGET_BYTES

    p = dict(_NOMINAL_PEAKS if peaks is None else peaks)
    return CostModel(
        coeffs=(),
        dispatch_us=500.0,
        compile_s=1.0,
        chunk_profile=((DEFAULT_CHUNK_TARGET_BYTES, 1.0),
                       (8 * DEFAULT_CHUNK_TARGET_BYTES, 2.0)),
        peaks=tuple(sorted(p.items())),
        source="analytic")


def load_cost_model(path: Optional[str] = None, *,
                    platform: Optional[str] = None,
                    device_count: Optional[int] = None,
                    device: DeviceLike = None) -> Optional[CostModel]:
    """The measured model from the calibration artifact, or None when the
    file is missing, its version is stale, or no entry matches this
    platform/device count (peaks-only entries carry no coefficients and
    do not count). The key is `platform_key(device_count, platform,
    device)`."""
    path = default_calibration_path() if path is None else path
    data = _read_artifact(path)
    if data is None:
        return None
    entry = data.get("entries", {}).get(
        platform_key(device_count, platform, device))
    if not entry or "coeffs" not in entry:
        return None
    coeffs = tuple((fam, float(c["c0_us"]), float(c["c1_us"]))
                   for fam, c in sorted(entry["coeffs"].items()))
    profile = tuple((float(b), float(f))
                    for b, f in entry.get("chunk_profile", ()))
    return CostModel(
        coeffs=coeffs,
        dispatch_us=float(entry.get("dispatch_us", 500.0)),
        compile_s=float(entry.get("compile_s", 1.0)),
        chunk_profile=profile,
        peaks=tuple(sorted(entry.get("peaks", _NOMINAL_PEAKS).items())),
        source="measured")


# --------------------------------------------------------------------------
# the calibration suite
# --------------------------------------------------------------------------
def _calib_problem(n: int, dim: int, device: torch.device, seed: int = 0):
    from repro_torch.core.mc.problems import quadratic_mc_problem

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    return quadratic_mc_problem(x, y, 0.1, np.zeros(dim, np.float32),
                                device=device)


def _timed_run(prob, algo: str, steps: int, seeds: int, *,
               device: torch.device, seed_chunk: Optional[int] = None,
               warm_reps: int = 3) -> float:
    """Warm best-of wall-clock of one engine call, ending in the host copy
    of its per-seed curves that `run_mc` makes (the figure every
    cost-model consumer pays)."""
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc.engine import run_mc

    ch = ChannelConfig(fading="rayleigh", noise_std=0.5)
    m = 2 if _algo_family(algo) == "blind" else None

    def call():
        return run_mc(prob, [ch], algo, [0.05], steps, seeds,
                      n_antennas=m, seed_chunk=seed_chunk,
                      keep_seed_curves=True, shard_seeds=False,
                      device=device)

    call()  # first sight + warm-up
    best = float("inf")
    for _ in range(warm_reps):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return best


def _fit_nonneg(x: np.ndarray, y: np.ndarray) -> tuple:
    """Least-squares line with both coefficients clamped ≥ 0 — the clamp
    is what makes every downstream prediction monotone."""
    x, y = np.asarray(x, float), np.asarray(y, float)
    vx = np.sum((x - x.mean()) ** 2)
    c1 = max(0.0, float(np.sum((x - x.mean()) * (y - y.mean())) / vx)) \
        if vx > 0 else 0.0
    c0 = max(0.0, float(y.mean() - c1 * x.mean()))
    return c0, c1


def _smi_line() -> Optional[str]:
    """The card's name and power limit as `nvidia-smi` prints them, or
    None where there is no `nvidia-smi`."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def calibrate(cfg: Optional[CalibrationConfig] = None, *,
              path: Optional[str] = None,
              device_count: Optional[int] = None,
              device: DeviceLike = None,
              verbose: bool = False) -> dict:
    """Run the calibration suite on `device` (None: the CUDA card) and
    persist its artifact entry keyed by `<platform>/<device_count>`.
    Returns the entry dict (module docstring for what is measured)."""
    from repro_torch.core.mc.exec import estimate_peak_bytes

    cfg = CalibrationConfig() if cfg is None else cfg
    path = default_calibration_path() if path is None else path
    dev = resolve_device(device)
    key = platform_key(device_count, device=dev)

    def log(msg):
        if verbose:
            print(f"calibrate[{key}]: {msg}", flush=True)

    def timed(prob, algo, seeds, **kw):
        return _timed_run(prob, algo, cfg.steps, seeds, device=dev, **kw)

    peaks = measure_machine_peaks(dim=cfg.peaks_dim, device=dev)
    log(f"peaks: {peaks['peak_gflops']:.2f} GFLOP/s, "
        f"{peaks['peak_gibs']:.2f} GiB/s")

    samples, coeffs = [], {}
    for algo in cfg.algos:
        fam = _algo_family(algo)
        xs, ys = [], []
        for n in cfg.n_grid:
            for dim in cfg.dim_grid:
                t = timed(_calib_problem(n, dim, dev), algo, cfg.seeds,
                          warm_reps=cfg.warm_reps)
                m = 2 if fam == "blind" else 1
                step_us = t / (cfg.steps * cfg.seeds) * _US
                xs.append(mc_slot_model(fam, n, dim, m)["flops"])
                ys.append(step_us)
                samples.append([algo, int(n), int(dim),
                                round(step_us, 3)])
                log(f"{algo} N={n} d={dim}: {step_us:.1f} us/slot")
        c0, c1 = _fit_nonneg(xs, ys)
        coeffs[fam] = {"c0_us": round(c0, 4), "c1_us": c1}
        log(f"{fam}: step_us = {c0:.2f} + {c1:.3e} * flops")

    # dispatch probe: one small workload all-live vs chunked — the per-call
    # difference is row assembly, host issue and the host copy
    prob0 = _calib_problem(cfg.n_grid[0], cfg.dim_grid[0], dev)
    t_live = timed(prob0, "gbma", cfg.seeds, warm_reps=cfg.warm_reps)
    t_chunk = timed(prob0, "gbma", cfg.seeds, seed_chunk=cfg.chunk_probe,
                    warm_reps=cfg.warm_reps)
    k = max(cfg.seeds // cfg.chunk_probe, 2)
    dispatch_us = max(50.0, (t_chunk - t_live) / (k - 1) * _US)
    log(f"dispatch: {dispatch_us:.0f} us/call")

    # working-set profile: warm step time vs live bytes, one point per
    # seed_chunk (dispatch subtracted so the factor isolates the memory).
    # A point whose time the subtracted dispatch covers entirely carries
    # no working-set information and is left out: on the card a call's
    # cost is its step loop's host issue, which the dispatch probe
    # measures too, so the many-call points can subtract to nothing (the
    # reference's clamp would then make the base ~0 and every other
    # factor ~1e10)
    n_p, d_p = cfg.n_grid[-1], cfg.dim_grid[-1]
    prob_p = _calib_problem(n_p, d_p, dev)
    profile_pts = []
    chunks = sorted({max(1, cfg.probe_seeds // 16),
                     max(1, cfg.probe_seeds // 4), cfg.probe_seeds})
    for chunk in chunks:
        seed_chunk = None if chunk >= cfg.probe_seeds else chunk
        t = timed(prob_p, "gbma", cfg.probe_seeds, seed_chunk=seed_chunk,
                  warm_reps=cfg.warm_reps)
        calls = -(-cfg.probe_seeds // chunk)
        t_adj = t - (calls - 1) * dispatch_us / _US
        if t_adj <= 0.0:
            log(f"profile chunk={chunk}: {t * _US:.0f} us, all of it "
                f"{calls - 1} x dispatch: left out")
            continue
        live = estimate_peak_bytes(
            n_rows=1, seeds=cfg.probe_seeds, steps=cfg.steps, n_max=n_p,
            dim=d_p, algo_set=("gbma",), seed_chunk=seed_chunk,
            keep_seed_curves=False)["per_device_peak_bytes"]
        step_us = t_adj / (cfg.steps * cfg.probe_seeds) * _US
        profile_pts.append((live, step_us))
        log(f"profile chunk={chunk}: {step_us:.1f} us/slot "
            f"@ {live / 2**20:.1f} MiB live")
    profile_pts.sort()
    base = min((s for _, s in profile_pts), default=1.0)
    factors = np.maximum.accumulate(
        [max(1.0, s / base) for _, s in profile_pts])
    chunk_profile = [[int(b), round(float(f), 4)]
                     for (b, _), f in zip(profile_pts, factors)]

    # first-sight probe: a grid-foreign shape's first call minus its warm
    # steady state (the port runs no compiler: allocator growth and
    # library set-up)
    prob_c = _calib_problem(cfg.n_grid[-1] + 1, cfg.dim_grid[0], dev)
    t0 = time.perf_counter()
    timed(prob_c, "gbma", cfg.seeds, warm_reps=1)
    t_cold_total = time.perf_counter() - t0
    t_warm_c = timed(prob_c, "gbma", cfg.seeds, warm_reps=cfg.warm_reps)
    compile_s = max(0.05, t_cold_total - 2 * t_warm_c)
    log(f"first sight: {compile_s:.2f} s")

    entry = {
        "config": dataclasses.asdict(cfg),
        "peaks": peaks,
        "peaks_dim": cfg.peaks_dim,
        "coeffs": coeffs,
        "dispatch_us": round(dispatch_us, 1),
        "compile_s": round(compile_s, 3),
        "chunk_profile": chunk_profile,
        "samples": samples,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "nvidia_smi": _smi_line() if dev.type == "cuda" else None,
    }
    _write_entry(path, key, entry)
    log(f"artifact -> {path}")
    return entry


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Calibrate the port's MC cost model and persist the "
                    "versioned JSON artifact (module docstring).")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-size suite (CalibrationConfig.smoke())")
    ap.add_argument("--out", default=None,
                    help="artifact path (default: "
                         f"{CALIBRATION_ENV} or the port's tracked "
                         "CALIBRATION_mc.json)")
    ap.add_argument("--device", default=None,
                    help="device to calibrate (default: the CUDA card)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    cfg = CalibrationConfig.smoke() if args.smoke else CalibrationConfig()
    entry = calibrate(cfg, path=args.out, device=args.device,
                      verbose=not args.quiet)
    coeffs = ", ".join(
        f"{fam}: {c['c0_us']:.2f}+{c['c1_us']:.2e}*flops us"
        for fam, c in entry["coeffs"].items())
    print(f"costmodel,calibrated,{platform_key(device=args.device)},"
          f"{coeffs},dispatch_us={entry['dispatch_us']},"
          f"compile_s={entry['compile_s']}")
    if not all(math.isfinite(c[k]) for c in entry["coeffs"].values()
               for k in ("c0_us", "c1_us")):
        raise SystemExit("calibration gave non-finite coefficients")


if __name__ == "__main__":
    main()
