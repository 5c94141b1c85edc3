#!/usr/bin/env python3
"""GPU check of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-src DIR   # step profile of DIR/src only

Builds the hand-written CUDA kernel from the checkout's sources, holds it
against its plain PyTorch version on the card at every shape the main path
gives it, drives the port's main path (the GBMA Monte Carlo engine
`run_mc` -> fig3 rows) at the paper's operating point and at the engine's
LARGE throughput workload, checks the results, and profiles a step of
each (kernel launches, host synchronizations and device busy time per
step, from `torch.profiler`). Any failed phase raises, so the script
exits non-zero; it also exits non-zero, printing no result, when CUDA is
unavailable.

Output: one line per phase; then a JSON `{"kernels": [...]}` line (times
from CUDA events on this card, bounds from this run's shapes), the card's
name and power limit as `nvidia-smi` prints them, and last
`{"ok": true, "device": {...}}`.

`--profile-src DIR` runs only the step profile, importing `repro_torch`
from `DIR/src` (another checkout, e.g. the parent commit), and prints one
JSON line: two trees are compared in one call on one card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
REPLACES = "src/repro/kernels/ota/kernel.py:31"  # _ota_kernel
SOURCE = "src/repro_torch/kernels/ota/csrc/ota_aggregate.cu"
LARGE = {"n": 4096, "dim": 24, "steps": 150, "seeds": 1024}
FIG3_DIM = 90  # figures.MSDProblem's default width
# main-path shapes (B trajectories, N nodes, d) the kernel is launched at,
# LARGE first; kept in step with figures.FIG3 by `main_shapes`
MAIN_SHAPES = ((1024, 4096, 24), (4, 50, 90), (4, 160, 90), (4, 500, 90),
               (12, 500, 90))


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` over `reps` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ota_bound(b: int, n: int, d: int, g_bytes: int = 4,
              out_bytes: int = 4) -> tuple:
    """(least ms, what bounds it) for one OTA aggregation: each input read
    once, each output written once; 2 flops per gradient element."""
    nbytes = b * n * d * g_bytes + 4 * b * n + 4 * b * d + b * d * out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * n * d / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_shapes() -> tuple:
    """MAIN_SHAPES, checked against the shapes fig3 and LARGE give the
    kernel: part (a) one row of `seeds` per N, part (b) one row per eps
    at the largest N."""
    from repro_torch.figures import FIG3

    s = FIG3["seeds"]
    shapes = ((LARGE["seeds"], LARGE["n"], LARGE["dim"]),) + tuple(
        (s, n, FIG3_DIM) for n in FIG3["n_grid"]) + (
        (len(FIG3["eps_grid"]) * s, FIG3["n_grid"][-1], FIG3_DIM),)
    if shapes != MAIN_SHAPES:
        raise AssertionError(f"main-path shapes {shapes} != {MAIN_SHAPES}")
    return shapes


def ota_inputs(b, n, d, dtype, seed, offset=0.0):
    """Random kernel operands; `offset` shifts the gradients' mean, so the
    sum over nodes dominates and a wrong normalization stands out."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = (torch.randn((b, n, d), generator=gen, device="cuda")
         + offset).to(dtype)
    h = torch.randn((b, n), generator=gen, device="cuda").abs()
    w = torch.randn((b, d), generator=gen, device="cuda")
    return g, h, w


def check_kernel_vs_plain() -> dict:
    """The kernel against the plain version on the card, at the CPU tests'
    shapes and bars and at the main-path shapes. Returns the max abs error
    per main-path shape."""
    import torch

    from repro_torch.kernels.ota.ops import ota_edge_aggregate
    from repro_torch.kernels.ota.ref import ota_edge_aggregate_ref

    def compare(label, b, n, d, dtype, atol, rtol, seed, offset=0.0):
        g, h, w = ota_inputs(b, n, d, dtype, seed, offset)
        ker = ota_edge_aggregate(g, h, w, noise_scale=0.37, impl="kernel")
        ref = ota_edge_aggregate_ref(g, h, w, noise_scale=0.37)
        torch.cuda.synchronize()
        err = (ker.float() - ref.float()).abs()
        bar = atol + rtol * ref.float().abs()
        ok = bool(torch.all(torch.isfinite(ker.float()))) \
            and bool(torch.all(err <= bar))
        log(f"kernel-vs-plain {label} (B={b}, N={n}, d={d}, {dtype}): "
            f"max_abs_err={err.max().item():.3e} atol={atol} rtol={rtol} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"OTA kernel disagrees with its plain "
                                 f"version at {label}")
        return err.max().item()

    seed = 0
    for dtype, atol, rtol in ((torch.float32, 2e-5, 1e-2),
                              (torch.bfloat16, 5e-2, 1e-2)):
        for n, d in ((128, 512), (256, 1024), (100, 300), (64, 128),
                     (8, 128)):
            seed += 1
            compare("test shape", 1, n, d, dtype, atol, rtol, seed)
    for n, d in ((5, 7), (1, 90), (130, 513), (200, 90)):
        seed += 1
        compare("odd shape", 1, n, d, torch.float32, 1e-6, 1e-5, seed)
        g, h, w = ota_inputs(1, n, d, torch.float32, seed)
        probe = ota_edge_aggregate(torch.zeros_like(g), h, w,
                                   noise_scale=0.37, impl="kernel")
        torch.cuda.synchronize()
        err = (probe - 0.37 * w).abs().max().item()
        log(f"noise-only probe (N={n}, d={d}): max_abs_err={err:.3e} "
            f"atol=1e-07 {'ok' if err <= 1e-7 else 'FAIL'}")
        if err > 1e-7:
            raise AssertionError("noise-only probe is not 0.37*w")
    # batched form == B unbatched calls
    g, h, w = ota_inputs(3, 130, 90, torch.float32, 99)
    batched = ota_edge_aggregate(g, h, w, noise_scale=0.37, impl="kernel")
    single = torch.stack([ota_edge_aggregate(g[i], h[i], w[i],
                                             noise_scale=0.37, impl="kernel")
                          for i in range(3)])
    torch.cuda.synchronize()
    if not torch.equal(batched, single):
        raise AssertionError("batched launch differs from unbatched calls")
    log("batched (B=3) == 3 unbatched launches: bitwise ok")
    # main-path shapes: gradients of mean 1 make v ~ 0.8, so a divisor
    # off by one node (N - 1) errs by v/N >= 2e-4 against a bar of ~9e-6
    errs = {}
    for b, n, d in main_shapes():
        seed += 1
        errs[(b, n, d)] = compare("main-path shape", b, n, d, torch.float32,
                                  1e-6, 1e-5, seed, offset=1.0)
        ones = torch.ones((b, n, d), device="cuda")
        probe = ota_edge_aggregate(ones, ones[..., 0], torch.zeros(
            (b, d), device="cuda"), noise_scale=1.0, impl="kernel")
        torch.cuda.synchronize()
        err = (probe - 1.0).abs().max().item()
        log(f"normalization probe (B={b}, N={n}, d={d}): g = h = 1, w = 0 "
            f"-> max |v - 1| = {err:.3e} (bar 1e-06)")
        if not err <= 1e-6:
            raise AssertionError("the kernel does not normalize by N")
    return errs


def time_kernel(errs: dict) -> list:
    """Kernel, plain version and library-call times at the main-path
    shapes, beside the bound computed from the same shapes."""
    import torch

    from repro_torch.kernels.ota import kernel
    from repro_torch.kernels.ota.ops import ota_edge_aggregate
    from repro_torch.kernels.ota.ref import ota_edge_aggregate_ref

    rows = []
    for b, n, d in main_shapes():
        g, h, w = ota_inputs(b, n, d, torch.float32, 7)
        reps = 50 if b * n * d > 1e7 else 500
        # the bare launch on prepared operands, and the wrapper call the
        # engine makes (validation, noise fold, output allocation)
        w_scaled, out = 0.37 * w, torch.empty((b, d), device="cuda")
        ker = cuda_ms(lambda: kernel.launch(g, h, w_scaled, out, n), reps)
        wrapped = cuda_ms(lambda: ota_edge_aggregate(
            g, h, w, noise_scale=0.37, impl="kernel"), reps)
        plain = cuda_ms(lambda: ota_edge_aggregate_ref(
            g, h, w, noise_scale=0.37), reps)
        lib = cuda_ms(lambda: torch.einsum("bn,bnd->bd", h, g), reps)
        bound, bound_by = ota_bound(b, n, d)
        row = {"shape": [b, n, d], "dtype": "float32", "ms": ker,
               "wrapper_ms": wrapped, "plain_ms": plain, "library_ms": lib,
               "bound_ms": bound, "bound_by": bound_by,
               "max_abs_err": errs[(b, n, d)]}
        log(f"ota timing B={b} N={n} d={d}: kernel {ker:.6f} ms (wrapper "
            f"call {wrapped:.6f} ms), plain {plain:.6f} ms, einsum "
            f"{lib:.6f} ms, bound {bound:.6f} ms ({bound_by}), kernel at "
            f"{bound / ker:.1%} of bound")
        rows.append(row)
    return rows


def check_cuda_matches_cpu() -> None:
    """A small sweep on the card (kernel route) against the same sweep on
    the CPU (the plain version, the path the CPU tests hold to the JAX
    reference)."""
    import numpy as np

    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.figures import MSDProblem

    prob = MSDProblem.make(48, dim=16)
    chs = [ChannelConfig(fading="rayleigh", energy=e) for e in (1.0, 0.5)]
    args = (chs, "gbma", [0.01, 0.02], 40, 2)
    gpu = run_mc(prob.to_mc("cuda"), *args, device="cuda")
    cpu = run_mc(prob.to_mc("cpu"), *args, device="cpu")
    rel = float(np.max(np.abs(gpu.risks - cpu.risks) / np.abs(cpu.risks)))
    log(f"run_mc cuda (kernel) vs cpu (plain), N=48 d=16 2 rows x 2 seeds "
        f"x 40 steps: max rel diff of risks {rel:.3e} (bar 1e-05)")
    if not rel <= 1e-5:
        raise AssertionError("run_mc on the card disagrees with the CPU")


def check_fig3_routes() -> None:
    """fig3 part (b) — 3 rows at N = 500 x 4 seeds x 300 steps, the
    (12, 500, 90) launches — through the kernel and through the plain
    version on the card: per-seed curves and energies within 1e-5 rel."""
    import numpy as np

    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.core.theory import stepsize_theorem1
    from repro_torch.figures import FIG3, MSDProblem

    n = FIG3["n_grid"][-1]
    prob = MSDProblem.make(n)
    chs = [ChannelConfig(fading=FIG3["fading"], scale=1.0, noise_std=1.0,
                         energy=float(n) ** (eps - 2.0))
           for eps in FIG3["eps_grid"]]
    betas = [stepsize_theorem1(prob.pc, c, n, safety=0.9) for c in chs]
    mc = prob.to_mc("cuda")
    out = {impl: run_mc(mc, chs, "gbma", betas, FIG3["steps"],
                        FIG3["seeds"], ota_impl=impl, device="cuda")
           for impl in ("kernel", "ref")}
    rel = {name: float(np.max(np.abs(getattr(out["kernel"], name)
                                     - getattr(out["ref"], name))
                              / np.abs(getattr(out["ref"], name))))
           for name in ("risks", "cum_energy", "mean")}
    log(f"fig3 part (b) kernel vs plain route on the card (B=12, N={n}, "
        f"d=90, {FIG3['steps']} steps): max rel diff {rel} (bar 1e-05)")
    if not all(v <= 1e-5 for v in rel.values()):
        raise AssertionError("fig3: kernel and plain routes disagree")


def run_fig3_main_path(ops) -> int:
    """The paper's operating point (fig3: N in (50, 160, 500), d = 90, 300
    steps, 4 seeds, Rayleigh) through the port's entry point."""
    import numpy as np

    from repro_torch.figures import FIG3, run_fig3

    ops.launch_count = 0
    t0 = time.perf_counter()
    rows = run_fig3(device="cuda")
    wall = time.perf_counter() - t0
    launches = ops.launch_count
    for r in rows:
        log(r)
    n_runs = len(FIG3["n_grid"]) + 1
    steps = n_runs * FIG3["steps"]
    log(f"fig3 main path: {launches} OTA kernel launches over {n_runs} "
        f"run_mc calls x {FIG3['steps']} steps; wall {wall:.3f} s "
        f"({wall / steps * 1e3:.3f} ms per step)")
    if launches != steps:
        raise AssertionError(f"expected {steps} kernel launches, got "
                             f"{launches}")
    for n in FIG3["n_grid"]:
        if f"fig3a,N={n},bound_holds,1" not in rows:
            raise AssertionError(f"fig3 N={n}: Theorem-1 bound violated")
    values = [float(r.split(",")[-1]) for r in rows if "final" in r]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError("fig3: non-finite risks")
    curves = [float(r.split(",")[3]) for r in rows if "_curve" in r]
    if not np.all(np.isfinite(curves)):
        raise AssertionError("fig3: non-finite curve values")
    return launches


def large_workload():
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.figures import MSDProblem

    prob = MSDProblem.make(LARGE["n"], dim=LARGE["dim"])
    ch = ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                       energy=1.0 / LARGE["n"])
    return prob.to_mc("cuda"), ch, 0.01


def run_large_main_path(ops) -> tuple:
    """LARGE (N=4096, d=24, 150 steps, 1024 seeds, gbma, Rayleigh,
    keep_seed_curves=False): one kernel launch per step for all 1024
    trajectories."""
    import numpy as np
    import torch

    from repro_torch.core.mc.engine import run_mc

    mc, ch, beta = large_workload()
    steps = LARGE["steps"]
    # the kernel route and the plain route over the same 64 seeds
    sub = {impl: run_mc(mc, [ch], "gbma", [beta], steps, 64,
                        keep_seed_curves=False, ota_impl=impl,
                        device="cuda").mean[0]
           for impl in ("kernel", "ref")}
    rel = float(np.max(np.abs(sub["kernel"] - sub["ref"])
                       / np.abs(sub["ref"])))
    log(f"LARGE at 64 seeds: kernel vs ref mean curves max rel diff "
        f"{rel:.3e} (bar 1e-05)")
    if not rel <= 1e-5:
        raise AssertionError("LARGE: kernel and plain routes disagree")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.launch_count = 0
    t0 = time.perf_counter()
    res = run_mc(mc, [ch], "gbma", [beta], steps, LARGE["seeds"],
                 keep_seed_curves=False)
    wall = time.perf_counter() - t0
    launches = ops.launch_count
    peak = torch.cuda.max_memory_allocated()
    mean = res.mean[0]
    log(f"LARGE main path: N={LARGE['n']} d={LARGE['dim']} steps={steps} "
        f"seeds={LARGE['seeds']}: wall {wall:.3f} s, "
        f"{wall / steps * 1e3:.3f} ms per step, peak device memory "
        f"{peak / 2**20:.1f} MiB, {launches} OTA kernel launches; mean "
        f"risk {mean[0]:.6e} -> {mean[-1]:.6e}")
    if launches != steps:
        raise AssertionError(f"LARGE: expected {steps} launches, got "
                             f"{launches}")
    if not (np.all(np.isfinite(mean)) and mean[-1] < mean[0]):
        raise AssertionError("LARGE: mean curve not finite or not falling")
    return launches, wall / steps


def step_breakdown() -> None:
    """CUDA-event times of the pieces of one LARGE step (B = 1024
    trajectories): the draws, the gradient, the energy sum and the OTA
    kernel — where a step's time goes."""
    import torch

    from repro_torch.core import rng
    from repro_torch.core.mc.engine import ChannelBatch
    from repro_torch.core.mc.problems import MCProblemBatch
    from repro_torch.core.mc.slots import SlotCtx, _ota_draw
    from repro_torch.kernels.ota.ops import ota_edge_aggregate

    mc, ch, _ = large_workload()
    b, n, d = LARGE["seeds"], LARGE["n"], LARGE["dim"]
    batch = MCProblemBatch.stack([mc])
    p = {k: v.to("cuda").repeat(b) for k, v in
         ChannelBatch.stack([ch]).params.items()}
    ctx = SlotCtx(fading="rayleigh", p=p,
                  mask=torch.ones((b, n), device="cuda"), phase_zero=True)
    keys = rng.key(torch.arange(b, device="cuda"))
    theta = torch.zeros((1, b, d), device="cuda")
    g = batch.grad_fn(batch.data, theta).reshape(b, n, d)
    dr = _ota_draw(keys, ctx, n, d)
    parts = {
        "draws (gains + noise, threefry)": lambda: _ota_draw(keys, ctx, n, d),
        "gradient (B,N,d)": lambda: batch.grad_fn(batch.data, theta),
        "risk": lambda: batch.risk_fn(batch.data, theta),
        "energy sum": lambda: (g * g).sum(dim=(1, 2)),
        "OTA kernel": lambda: ota_edge_aggregate(
            g, dr["h"], dr["w"], noise_scale=1.0, impl="kernel"),
    }
    total = 0.0
    for name, fn in parts.items():
        ms = cuda_ms(fn, reps=20)
        total += ms
        log(f"LARGE step breakdown: {name}: {ms:.4f} ms")
    log(f"LARGE step breakdown: sum of parts {total:.4f} ms")


_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def _profile_counts(fn) -> dict:
    """Run `fn` under torch.profiler: kernel launches, host synchronizing
    calls and copies issued, the device's busy time (the sum of its
    kernel, copy and fill intervals, one stream), its host-to-device
    copies, and the OTA kernel's own launches and device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {"launches": 0, "syncs": 0, "memcpy": 0, "device_us": 0.0,
              "device_events": 0, "h2d": 0, "ota_us": 0.0, "ota": 0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            counts["device_us"] += us
            counts["device_events"] += 1
            counts["h2d"] += "HtoD" in e.name
            if "ota_aggregate" in e.name:
                counts["ota_us"] += us
                counts["ota"] += 1
        elif e.name.startswith(("cudaLaunch", "cuLaunch")):
            counts["launches"] += 1
        elif e.name in _SYNC_CALLS:
            counts["syncs"] += 1
        elif e.name.startswith("cudaMemcpy"):
            counts["memcpy"] += 1
    return counts


def step_profile() -> dict:
    """Per-step cost of `run_mc` at the fig3 operating point (one N = 500
    row, 4 seeds) and at LARGE: wall time from the host clock without the
    profiler, and launches, synchronizations, copies and device busy time
    from torch.profiler. Each is the difference of a long and a short run
    over the difference of their steps, so set-up and read-back cancel.
    Uses only `run_mc` arguments that every slice of the port accepts."""
    import torch

    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.core.theory import stepsize_theorem1
    from repro_torch.figures import MSDProblem

    prob = MSDProblem.make(500)
    fig3_ch = ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                            energy=1.0)
    cases = {"fig3": (prob.to_mc("cuda"), fig3_ch,
                      stepsize_theorem1(prob.pc, fig3_ch, 500, safety=0.9),
                      4),
             "large": large_workload() + (LARGE["seeds"],)}
    out = {}
    for name, (mc, ch, beta, seeds) in cases.items():
        n, dim = mc.n_nodes, mc.dim

        def run(steps):
            return run_mc(mc, [ch], "gbma", [beta], steps, seeds,
                          keep_seed_curves=False, device="cuda")

        run(4)  # warm-up: kernel build, allocator, cuBLAS handles
        walls = {}
        for steps in (10, 60, 10, 60):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(steps)
            walls.setdefault(steps, []).append(time.perf_counter() - t0)
        lo, hi = (_profile_counts(lambda s=s: run(s)) for s in (4, 12))
        per = {k: (hi[k] - lo[k]) / 8 for k in lo}
        wall_ms = (min(walls[60]) - min(walls[10])) / 50 * 1e3
        busy_ms = per["device_us"] / 1e3
        out[name] = {
            "n": n, "dim": dim, "trajectories": seeds,
            "wall_ms_per_step": wall_ms,
            "launches_per_step": per["launches"],
            "syncs_per_step": per["syncs"],
            "memcpy_per_step": per["memcpy"],
            "h2d_copies_per_step": per["h2d"],
            "ota_device_us_per_launch": per["ota_us"] / per["ota"]
            if per["ota"] else None,
            "device_busy_ms_per_step": busy_ms if hi["device_events"]
            else None,
            "device_idle_share": 1.0 - busy_ms / wall_ms
            if hi["device_events"] else None}
        log(f"step profile {name}: {json.dumps(out[name])}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-src", default=None,
                        help="run only the step profile, importing "
                        "repro_torch from DIR/src")
    args = parser.parse_args()
    src_root = os.path.abspath(args.profile_src or ROOT)
    sys.path.insert(0, os.path.join(src_root, "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.profile_src is not None:
        prof = step_profile()
        print(json.dumps({"profile_src": src_root, "steps": prof}),
              flush=True)
        return 0
    from repro_torch.kernels.ota import kernel, ops

    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    info = kernel.build()
    log(f"build: {kernel.SOURCE.name} -> {info.path.name} in "
        f"{info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "ptxas" in line:
            log(f"  {line.strip()}")

    errs = check_kernel_vs_plain()
    torch.cuda.synchronize()
    timings = time_kernel(errs)
    torch.cuda.synchronize()
    check_cuda_matches_cpu()
    torch.cuda.synchronize()
    check_fig3_routes()
    torch.cuda.synchronize()
    fig3_launches = run_fig3_main_path(ops)
    torch.cuda.synchronize()
    large_launches, large_step_s = run_large_main_path(ops)
    torch.cuda.synchronize()
    step_breakdown()
    torch.cuda.synchronize()
    prof = step_profile()
    torch.cuda.synchronize()

    primary = timings[0]  # the LARGE shape
    entry = {
        "name": "ota_aggregate", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES,
        "launches": fig3_launches + large_launches,
        "max_abs_err": max(errs.values()), "tolerance": "atol 1e-06 + "
        "rtol 1e-05 at main-path shapes",
        "ms": primary["ms"], "kernel_ms": primary["ms"],
        "plain_ms": primary["plain_ms"], "bound_ms": primary["bound_ms"],
        "bound_by": primary["bound_by"],
        "library_ms": primary["library_ms"],
        "launches_by_run": {"fig3": fig3_launches, "large": large_launches},
        "large_ms_per_step": large_step_s * 1e3,
        "shapes": timings, "step_profile": prof,
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
