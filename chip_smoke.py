#!/usr/bin/env python3
"""GPU check of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-src DIR   # step profile of DIR/src only

Builds the hand-written CUDA kernels from the checkout's sources (one
nvcc per source, all started together: K1, K2's f32 and bf16 kernels, K3),
logs ptxas's registers and spills, the attention kernels' SASS (the
bf16 kernel's HGMMAs; the f32 kernel's FFMA and LDS.128 counts, failing
on any tensor-core instruction there) and K3's shared memory, and holds
each kernel against its plain PyTorch version on the card at the
reference tests' shapes, at every shape its main path gives it and on
strided views (f32 attention and K3 also off 16 bytes, read by their
narrower copies; K3 also at lengths off its 32-step chunk). Then it
drives the port's main paths:

* the GBMA Monte Carlo engine through the OTA kernel (K1, each
  trajectory divided by its own node count, and with an antenna axis):
  `run_mc` -> fig3 rows (a padded N sweep and an energy sweep), fig4
  (gbma / fdm / centralized rows in one call), fig5 (localization, the
  same three rows), fig6 (a padded N sweep), fig7 (blind transmitters
  and MRC at per-row antenna counts, with error feedback), fig8
  (federated logistic regression with minibatches), ablations (a), (b),
  (c) (power control), (d) (a multi-antenna edge), (e) (momentum /
  Nesterov rows), (f) (blind power budgets; no K1 launch) and (g)
  (participation), the engine's LARGE throughput workload, LARGE as a
  node-count sweep (N in {1024, 2048, 4096}) and LARGE MRC (16
  antennas) (these three pinned to the 'inscan' RNG plan: hoisted, LARGE
  MRC's draws alone would take ~40 GB), each route-checked against the
  plain version on the card, with a step profile of each (fig3's row
  under the default 'hoisted' plan and under 'inscan');
* execution plans at LARGE ("exec plans"): all seeds live per step and
  hoisted, seed chunks of 32 hoisted and per step, `plan="auto"`, and
  chunks of 128 run whole, stopped by an injected chunk fault and
  resumed from their checkpoint, and retried after one fault; each
  call's wall, K1 launches and peak device memory beside
  `estimate_peak_bytes`, the plans held to each other bit for bit;
* serving (`Engine.generate`: prefill, then decode) through the
  flash-attention kernels: olmo-1b at full width and depth in bf16 (the
  Hopper kernel: wgmma fed by TMA) at a 32- and a 2048-token prompt, and
  repro-100m in f32 (the CUDA-core kernel) at 2048, with the
  kernel route held to the plain route, decode held to prefill, and the
  prefill and a decode step of each model timed and profiled;
* serving rwkv6-7b through the WKV6 kernel, at full width and depth in
  bf16 at a 32- and a 2048-token prompt, with the same checks (the plain
  route at the 32-token prompt) and the weights' initialization peak.

Each path is driven with the kernels' launch counts set to 0 just before
it and read just after. Any failed phase raises, so the script exits
non-zero; it also exits non-zero, printing no result, when CUDA is
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
import concurrent.futures
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 dense tensor cores
REPLACES = "src/repro/kernels/ota/kernel.py:31"  # _ota_kernel
SOURCE = "src/repro_torch/kernels/ota/csrc/ota_aggregate.cu"
ATTN_REPLACES = "src/repro/kernels/attention/kernel.py:29"  # _attn_kernel
# K2 has two kernels: bf16 on the tensor cores (olmo-1b; timed as primary)
# and f32 on the CUDA cores (repro-100m)
ATTN_SOURCE = "src/repro_torch/kernels/attention/csrc/flash_attention_sm90.cu"
ATTN_F32_SOURCE = "src/repro_torch/kernels/attention/csrc/flash_attention.cu"
WKV_REPLACES = "src/repro/kernels/wkv/kernel.py:30"  # _wkv_kernel
WKV_SOURCE = "src/repro_torch/kernels/wkv/csrc/wkv6.cu"
# tests/test_kernels.py's WKV cases (b, h, t, d), all f32
WKV_TEST_SHAPES = ((2, 2, 128, 64), (1, 4, 100, 32), (2, 1, 64, 64),
                   (1, 2, 256, 16))
# rwkv6-7b's shapes on the serving path (B, heads, T, head_dim): the prefill
# of the 2048-token prompt (timed as primary) and a decode step
WKV_SLICE_SHAPES = ((4, 64, 2048, 64), (4, 64, 1, 64))
# lengths off the kernel's 32-step chunk: a lone step, one step short of a
# chunk, one past, and one short of the prefill
WKV_RAGGED_T = (1, 31, 33, 2047)
# the kernel against its plain version in bf16: o rounds the same f32 sum
# (taken in another order) to bf16, so 1-ulp flips (2^-8 relative) pass
# within atol 2e-2 + rtol 1e-2; the f32 state within 1e-4 relative
WKV_BF16_O_BAR = (2e-2, 1e-2)
WKV_STATE_BAR = (1e-4, 1e-4)
# rwkv6-7b's whole-model checks (`check_rwkv_routes`). In f32: the kernel
# route against the plain route within 1e-4 of the largest logit or state
# (the two differ only in the WKV sums' order, which this kernel takes
# close to the plain version's: a kernel that summed the bonus term apart
# read 2.0e-4 here on an H100, each of its calls within 2e-5 of the plain
# version, so a kernel that reorders its sums must first measure what
# this bar can hold); prefill(S) + decode against
# prefill(S + 1) within 1e-3 of the largest logit, about 3.5x the largest
# reading on an H100 (2.75e-4 through the kernel and 2.80e-4 through the
# plain route at the 32-token prompt, 1.8e-5 at 2048): the two paths round
# differently through 32 recurrent layers, whichever route runs the
# recurrence. In bf16: a route at most this many times as far from the f32
# model as its counterpart.
RWKV_F32_ROUTE_BAR = 1e-4
RWKV_F32_DECODE_BAR = 1e-3
RWKV_BF16_RATIO = 2.0
# tests/test_kernels.py's attention cases (b, hq, hkv, s, d, options)
ATTN_TEST_SHAPES = (
    (2, 4, 4, 256, 64, {}),
    (1, 8, 2, 256, 64, {}),
    (1, 4, 4, 384, 128, {"window": 100}),
    (1, 4, 4, 256, 64, {"softcap": 30.0}),
    (1, 2, 2, 200, 64, {}),
    (1, 2, 2, 256, 32, {"causal": False}),
    (1, 4, 4, 512, 256, {"window": 128, "softcap": 50.0}),
)
# the serving slice's prefill shapes (B, heads, S, head_dim, dtype name):
# olmo-1b at the launcher's 32-token prompt and at its 2048-token context,
# repro-100m at 2048; the olmo 2048 shape is the one timed as primary
SERVE_BATCH = 4
ATTN_SLICE_SHAPES = ((4, 16, 2048, 128, "bfloat16"),
                     (4, 16, 32, 128, "bfloat16"),
                     (4, 10, 2048, 64, "float32"))
SERVE_PROMPTS = (32, 2048)
SERVE_NEW_TOKENS = 32
# kernel route vs plain route and decode vs prefill, olmo-1b in bf16: the
# two attention routes round to bf16 at different elements, and 16 layers
# carry such 1-ulp (0.4 %) flips into the logits; the bar is 5 % of the
# largest logit (f32 routes are held exactly, by their greedy tokens)
BF16_LOGIT_BAR = 5e-2
LARGE = {"n": 4096, "dim": 24, "steps": 150, "seeds": 1024}
# the engine's LARGE workload as a node-count sweep: one padded call, a row
# per N, 1024 seeds each (B = 3072 trajectories, a 1.2 GB gradient tensor)
LARGE_SWEEP = {"n_grid": (1024, 2048, 4096), "dim": 24, "steps": 150,
               "seeds": 1024}
# LARGE with a 16-antenna edge: gbma at a static M, K1 at (B, M, N, d) =
# (1024, 16, 4096, 24)
LARGE_MRC = {"n": 4096, "dim": 24, "steps": 150, "seeds": 1024, "m": 16}
FIG_DIM = 90  # figures.MSDProblem's default width
# main-path launches of the OTA kernel: name -> (B trajectories, M antennas
# or None for the single-antenna form, N_max, d, each row's node count
# where the rows differ, else None); the rows of a launch hold
# B / len(counts) seeds each. LARGE first. Kept in step with
# figures.FIG3 ... FIG8 / ABLATIONS by `main_shapes`.
MAIN_SHAPES = {
    "large": (1024, None, 4096, 24, None),
    "fig3 (a)": (12, None, 500, 90, (50, 160, 500)),
    "fig3 (b)": (12, None, 500, 90, None),
    "fig4": (4, None, 800, 90, None),
    "fig5": (3, None, 200, 2, None),
    "fig6": (12, None, 800, 90, (100, 200, 400, 800)),
    "fig7 (a)": (12, 1, 500, 90, (50, 160, 500)),
    "fig7 (b)": (4, 1, 160, 90, None),
    "fig8 (a)": (12, 1, 80, 16, (20, 40, 80)),
    "fig8 (b)": (12, None, 40, 16, None),
    "ablation (a), (g)": (15, None, 200, 90, None),
    "ablation (b), (c)": (3, None, 200, 90, None),
    "ablation (d) M=1": (3, 1, 200, 90, None),
    "ablation (d) M=4": (3, 4, 200, 90, None),
    "ablation (d) M=16": (3, 16, 200, 90, None),
    "ablation (e)": (9, None, 200, 90, None),
    "large sweep": (3072, None, 4096, 24, (1024, 2048, 4096)),
    "large mrc": (1024, 16, 4096, 24, None),
}
# route checks (kernel vs plain on the card) cut the steps, never N, d, M
# or the seeds: every ablation call, fig5, fig7, fig8 and LARGE MRC (at
# its 1,024 seeds) at these many steps; the main paths run in full
ABLATION_ROUTE_STEPS = 50
FIG5_ROUTE_STEPS = 150
FIG7_ROUTE_STEPS = 100
FIG8_ROUTE_STEPS = 100
LARGE_MRC_ROUTE_STEPS = 20


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
              out_bytes: int = 4, counts: bool = False,
              m: int = 1) -> tuple:
    """(least ms, what bounds it) for one OTA aggregation over M antennas:
    each input read once (g once whatever M; the (B,) f32 counts too,
    when given), each output written once; 2M flops per gradient
    element."""
    nbytes = b * n * d * g_bytes + 4 * b * m * n + 4 * b * m * d \
        + b * m * d * out_bytes + (4 * b if counts else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * m * n * d / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_shapes() -> dict:
    """MAIN_SHAPES, checked against the launches the figure twins and
    LARGE give the kernel: fig3 (a) one padded row of `seeds` per N and
    (b) one row per eps at the largest N; fig4 and fig5 the gbma row's
    group; fig6 one padded row per N; fig7 and fig8 (a) the gbma rows of
    the N sweep (M = 1 as per-row counts), fig7 (b) its one gbma row,
    fig8 (b) a row per batch fraction; the ablations' calls at N = 200,
    (d) one per M; the LARGE sweep one padded row per N; LARGE MRC."""
    from repro_torch.figures import (ABLATIONS, FIG3, FIG4, FIG5, FIG6,
                                     FIG7, FIG8, FIG8_DIM, FIG8_FRAC_GRID)

    s3, s6, sa = FIG3["seeds"], FIG6["seeds"], ABLATIONS["seeds"]
    na = ABLATIONS["n"]
    grid3, grid6 = tuple(FIG3["n_grid"]), tuple(FIG6["n_grid"])
    grid7, grid8 = tuple(FIG7["n_grid"]), tuple(FIG8["n_grid"])
    sweep = tuple(LARGE_SWEEP["n_grid"])
    shapes = {
        "large": (LARGE["seeds"], None, LARGE["n"], LARGE["dim"], None),
        "fig3 (a)": (len(grid3) * s3, None, max(grid3), FIG_DIM, grid3),
        "fig3 (b)": (len(FIG3["eps_grid"]) * s3, None, max(grid3), FIG_DIM,
                     None),
        "fig4": (FIG4["seeds"], None, FIG4["n"], FIG_DIM, None),
        "fig5": (FIG5["seeds"], None, FIG5["n"], 2, None),
        "fig6": (len(grid6) * s6, None, max(grid6), FIG_DIM, grid6),
        "fig7 (a)": (len(grid7) * FIG7["seeds"], 1, max(grid7), FIG_DIM,
                     grid7),
        "fig7 (b)": (FIG7["seeds"], 1, FIG7["n"], FIG_DIM, None),
        "fig8 (a)": (len(grid8) * FIG8["seeds"], 1, max(grid8), FIG8_DIM,
                     grid8),
        "fig8 (b)": (len(FIG8_FRAC_GRID) * FIG8["seeds"], None, FIG8["n"],
                     FIG8_DIM, None),
        "ablation (a), (g)": (5 * sa, None, na, FIG_DIM, None),
        "ablation (b), (c)": (sa, None, na, FIG_DIM, None),
        **{f"ablation (d) M={m}": (sa, m, na, FIG_DIM, None)
           for m in (1, 4, 16)},
        "ablation (e)": (3 * sa, None, na, FIG_DIM, None),
        "large sweep": (len(sweep) * LARGE_SWEEP["seeds"], None, max(sweep),
                        LARGE_SWEEP["dim"], sweep),
        "large mrc": (LARGE_MRC["seeds"], LARGE_MRC["m"], LARGE_MRC["n"],
                      LARGE_MRC["dim"], None),
    }
    if shapes != MAIN_SHAPES:
        raise AssertionError(f"main-path shapes {shapes} != {MAIN_SHAPES}")
    return shapes


def trajectory_counts(b: int, n: int, counts):
    """(B,) f32 node counts on the card: each row's count repeated over
    its B / rows seeds, or None for a launch whose rows all hold n."""
    import torch

    if counts is None:
        return None
    return torch.tensor(counts, dtype=torch.float32, device="cuda") \
        .repeat_interleave(b // len(counts))


def ota_inputs(b, n, d, dtype, seed, offset=0.0, n_true=None, m=None):
    """Random kernel operands; `offset` shifts the gradients' mean, so the
    sum over nodes dominates and a wrong normalization stands out. With
    per-trajectory counts `n_true`, gradients and gains are 0 past each
    trajectory's count, as a padded node-count sweep gives them. With `m`
    antennas the gains are (B, M, N) and the noise (B, M, d)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = (torch.randn((b, n, d), generator=gen, device="cuda")
         + offset).to(dtype)
    ant = () if m is None else (m,)
    h = torch.randn((b,) + ant + (n,), generator=gen, device="cuda").abs()
    w = torch.randn((b,) + ant + (d,), generator=gen, device="cuda")
    if n_true is not None:
        lanes = torch.arange(n, device="cuda") < n_true[:, None]
        g = g * lanes[..., None].to(dtype)
        h = h * (lanes if m is None else lanes[:, None])
    return g, h, w


def check_kernel_vs_plain() -> dict:
    """The kernel against the plain version on the card, at the CPU tests'
    shapes and bars and at the main-path shapes (padded ones with their
    per-trajectory counts). Returns the max abs error per main-path
    launch."""
    import torch

    from repro_torch.kernels.ota.ops import ota_edge_aggregate
    from repro_torch.kernels.ota.ref import ota_edge_aggregate_ref

    def compare(label, b, n, d, dtype, atol, rtol, seed, offset=0.0,
                n_true=None, m=None, f64=False):
        g, h, w = ota_inputs(b, n, d, dtype, seed, offset, n_true, m)
        ker = ota_edge_aggregate(g, h, w, noise_scale=0.37, impl="kernel",
                                 n_true=n_true)
        ref = ota_edge_aggregate_ref(g, h, w, noise_scale=0.37,
                                     n_true=n_true)
        note = ""
        if f64:  # the plain version in f64: the f32 plain sums N terms in
            # sequence in its batched GEMM, errs by a few 1e-6 at N = 4096
            ref32 = ref
            ref = ota_edge_aggregate_ref(
                g.double(), h.double(), w.double(), noise_scale=0.37,
                n_true=None if n_true is None else n_true.double())
            note = (", against the plain version in f64 (the f32 plain "
                    f"version errs by {(ref32 - ref).abs().max().item():.3e})")
        torch.cuda.synchronize()
        err = (ker.double() - ref.double()).abs()
        bar = atol + rtol * ref.double().abs()
        ok = bool(torch.all(torch.isfinite(ker.float()))) \
            and bool(torch.all(err <= bar))
        log(f"kernel-vs-plain {label} (B={b}, "
            f"{'' if m is None else f'M={m}, '}N={n}, d={d}, {dtype}"
            f"{'' if n_true is None else ', per-trajectory counts'}{note}): "
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
    # the ragged case: rows of N in {50, 160, 500} zero-padded to 500, in
    # both dtypes at the reference's bars; a count of N everywhere gives
    # the bits of a launch without counts
    ragged = trajectory_counts(12, 500, (50, 160, 500))
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 5e-2)):
        seed += 1
        compare("ragged", 12, 500, 90, dtype, atol, 1e-2, seed,
                n_true=ragged)
    g, h, w = ota_inputs(12, 500, 90, torch.float32, seed)
    full = torch.full((12,), 500.0, device="cuda")
    same = torch.equal(
        ota_edge_aggregate(g, h, w, noise_scale=0.37, impl="kernel",
                           n_true=full),
        ota_edge_aggregate(g, h, w, noise_scale=0.37, impl="kernel"))
    log(f"uniform counts (B=12, N=500, d=90) == no counts: "
        f"{'bitwise ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("uniform counts change the kernel's bits")
    # the antenna axis at odd M, N and d, at M off the kernel's antenna
    # chunks (17, 20) and past the largest (64), with and without counts;
    # each antenna of an M-antenna launch has a single-antenna launch's
    # bits, LARGE MRC's included
    for b, m, n, d in ((3, 5, 131, 37), (4, 7, 33, 100), (2, 17, 131, 37),
                       (2, 20, 500, 24), (2, 64, 160, 90)):
        for counts in (None, (n // 2 + 1, n, n)):
            seed += 1
            compare("antenna axis", b * 3, n, d, torch.float32, 1e-6, 1e-5,
                    seed, n_true=trajectory_counts(b * 3, n, counts), m=m,
                    f64=True)
    for b, m, n, d in ((6, 4, 500, 90), (6, 20, 500, 37),
                       MAIN_SHAPES["large mrc"][:4]):
        g, h, w = ota_inputs(b, n, d, torch.float32, 98, m=m)
        full = ota_edge_aggregate(g, h, w, noise_scale=0.37, impl="kernel")
        same = all(torch.equal(full[:, j], ota_edge_aggregate(
            g, h[:, j].contiguous(), w[:, j].contiguous(), noise_scale=0.37,
            impl="kernel")) for j in range(m))
        log(f"antenna axis (B={b}, M={m}, N={n}, d={d}): each antenna == a "
            f"single-antenna launch: {'bitwise ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError("an antenna differs from a single-antenna "
                                 "launch")
    # main-path launches: gradients of mean 1 make v ~ 0.8, so a divisor
    # off by one node (N - 1) errs by v/N >= 2e-4 against a bar of ~9e-6
    errs = {}
    for name, (b, m, n, d, counts) in main_shapes().items():
        seed += 1
        n_true = trajectory_counts(b, n, counts)
        errs[name] = compare(f"main path {name}", b, n, d, torch.float32,
                             1e-6, 1e-5, seed, offset=1.0, n_true=n_true,
                             m=m, f64=m is not None)
        lanes = torch.ones((b, n), device="cuda") if n_true is None else (
            torch.arange(n, device="cuda") < n_true[:, None]).float()
        ant = () if m is None else (m,)
        gains = lanes if m is None else lanes[:, None].expand(b, m, n)
        probe = ota_edge_aggregate(
            lanes[..., None].expand(b, n, d).contiguous(),
            gains.contiguous(), torch.zeros((b,) + ant + (d,), device="cuda"),
            noise_scale=1.0, impl="kernel", n_true=n_true)
        torch.cuda.synchronize()
        err = (probe - 1.0).abs().max().item()
        log(f"normalization probe {name} (B={b}, "
            f"{'' if m is None else f'M={m}, '}N={n}, d={d}): g = h = 1 "
            f"on each trajectory's nodes, w = 0 -> max |v - 1| = {err:.3e} "
            "(bar 1e-06)")
        if not err <= 1e-6:
            raise AssertionError("the kernel does not normalize by N")
    return errs


def time_kernel(errs: dict) -> list:
    """Kernel, plain version and library-call times at the main-path
    launches, beside the bound computed from the same shapes. The library
    call is the einsum, divided by the counts where the rows differ, and
    over an antenna axis the einsum divided by N (or the counts)."""
    import torch

    from repro_torch.kernels.ota import kernel
    from repro_torch.kernels.ota.ops import ota_edge_aggregate
    from repro_torch.kernels.ota.ref import ota_edge_aggregate_ref

    rows = []
    for name, (b, m, n, d, counts) in main_shapes().items():
        n_true = trajectory_counts(b, n, counts)
        g, h, w = ota_inputs(b, n, d, torch.float32, 7, n_true=n_true, m=m)
        reps = 50 if b * (m or 1) * n * d > 1e7 else 500
        # the bare launch on prepared operands, and the wrapper call the
        # engine makes (validation, noise fold, output allocation)
        w_scaled, out = 0.37 * w, torch.empty_like(w)
        ker = cuda_ms(lambda: kernel.launch(g, h, w_scaled, out, n_true),
                      reps)
        wrapped = cuda_ms(lambda: ota_edge_aggregate(
            g, h, w, noise_scale=0.37, impl="kernel", n_true=n_true), reps)
        plain = cuda_ms(lambda: ota_edge_aggregate_ref(
            g, h, w, noise_scale=0.37, n_true=n_true), reps)
        if m is None and n_true is None:
            lib = cuda_ms(lambda: torch.einsum("bn,bnd->bd", h, g), reps)
        elif m is None:
            lib = cuda_ms(lambda: torch.einsum("bn,bnd->bd", h, g)
                          / n_true[:, None], reps)
        else:  # the antenna axis' yardstick, einsum / N
            div = n if n_true is None else n_true[:, None, None]
            lib = cuda_ms(lambda: torch.einsum("bmn,bnd->bmd", h, g) / div,
                          reps)
        bound, bound_by = ota_bound(b, n, d, counts=n_true is not None,
                                    m=m or 1)
        row = {"launch": name, "shape": [b, n, d], "antennas": m,
               "dtype": "float32",
               "counts": list(counts) if counts else None, "ms": ker,
               "wrapper_ms": wrapped, "plain_ms": plain, "library_ms": lib,
               "bound_ms": bound, "bound_by": bound_by,
               "max_abs_err": errs[name]}
        log(f"ota timing {name} B={b}{'' if m is None else f' M={m}'} N={n}"
            f" d={d}{'' if counts is None else f' counts {counts}'}: kernel "
            f"{ker:.6f} ms (wrapper call {wrapped:.6f} ms), plain "
            f"{plain:.6f} ms, einsum {lib:.6f} ms, bound {bound:.6f} ms "
            f"({bound_by}), kernel at {bound / ker:.1%} of bound")
        rows.append(row)
    return rows


def _within(out, ref, atol: float = 0.0) -> tuple:
    """(max rel diff, whether |out - ref| <= 1e-5 |ref| + atol
    everywhere)."""
    import numpy as np

    diff = np.abs(out - ref)
    rel = float(np.max(diff / np.maximum(np.abs(ref), 1e-30)))
    return rel, bool(np.all(diff <= 1e-5 * np.abs(ref) + atol))


def logistic_atol(probs) -> float:
    """The floor of the logistic excess risk's bar: 4 ulps of the f32
    objective F* it is taken from (ROADMAP §3, F8)."""
    import numpy as np

    f_star = max(float(p.data["f_star"]) for p in probs)
    return 4 * float(np.spacing(np.float32(f_star)))


def check_cuda_matches_cpu() -> None:
    """Small sweeps on the card (kernel route) against the same sweeps on
    the CPU (the plain version, the path the CPU tests hold to the JAX
    reference): one gbma call, one padded call mixing gbma, fdm and
    power_control rows with node participation, and one padded logistic
    call mixing gbma, blind and blind_ec rows at per-row antenna counts,
    finite and infinite power budgets, with minibatches."""
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.figures import MSDProblem, _fig8_problem

    def both(label, make, *args, atol=0.0, **kw):
        gpu = run_mc(make("cuda"), *args, device="cuda", **kw)
        cpu = run_mc(make("cpu"), *args, device="cpu", **kw)
        rel, ok = _within(gpu.risks, cpu.risks, atol)
        log(f"run_mc cuda (kernel) vs cpu (plain), {label}: max rel diff "
            f"of risks {rel:.3e} (bar 1e-05{f' + {atol:.3e}' if atol else ''}"
            f")")
        if not ok:
            raise AssertionError(f"run_mc on the card disagrees with the "
                                 f"CPU: {label}")

    chs = [ChannelConfig(fading="rayleigh", energy=e) for e in (1.0, 0.5)]
    both("N=48 d=16 2 rows x 2 seeds x 40 steps",
         lambda dev: MSDProblem.make(48, dim=16).to_mc(dev), chs, "gbma",
         [0.01, 0.02], 40, 2)
    chs = [ChannelConfig(fading="rayleigh", energy=e) for e in
           (1.0, 0.5, 0.25)]
    both("padded N in (20, 33, 48), gbma / fdm / power_control rows, "
         "participation (1, 0.7, 0.5), d=16, 2 seeds x 40 steps",
         lambda dev: [MSDProblem.make(n, dim=16).to_mc(dev)
                      for n in (20, 33, 48)], chs,
         ("gbma", "fdm", "power_control"), [0.01, 0.01, 0.01], 40, 2,
         participation=[1.0, 0.7, 0.5])
    probs = {n: _fig8_problem(n, "cpu") for n in (20, 40)}
    chs = [ChannelConfig(fading="rayleigh", noise_std=0.5, energy=1 / n)
           for n in (20, 40, 40, 20)]
    beta = probs[20][1]
    both("logistic, padded N in (20, 40), gbma (M=1) / blind (M=3) / "
         "blind_ec (M=5, budget 0.05) / blind_ec (M=2, unbounded) rows, "
         "batch_frac 0.5, d=16, 2 seeds x 40 steps",
         lambda dev: [_fig8_problem(n, dev)[0] for n in (20, 40, 40, 20)],
         chs, ("gbma", "blind", "blind_ec", "blind_ec"), [beta] * 4, 40, 2,
         n_antennas=(1, 3, 5, 2),
         power_budget=[float("inf"), float("inf"), 0.05, float("inf")],
         batch_frac=0.5, atol=logistic_atol([p for p, _ in probs.values()]))


def check_routes(label: str, call, fields=("risks", "cum_energy", "mean"),
                 risk_atol: float = 0.0) -> None:
    """`call(ota_impl)` through the kernel and through the plain version
    on the card: each `fields` array within 1e-5 rel (risks and mean
    plus `risk_atol`: the logistic floor), and finite."""
    import numpy as np

    out = {impl: call(impl) for impl in ("kernel", "ref")}
    rel, ok = {}, True
    for name in fields:
        ker, ref = getattr(out["kernel"], name), getattr(out["ref"], name)
        if not np.all(np.isfinite(ker)):
            raise AssertionError(f"{label}: non-finite {name}")
        rel[name], within = _within(
            ker, ref, risk_atol if name in ("risks", "mean") else 0.0)
        ok = ok and within
    log(f"{label} kernel vs plain route on the card: max rel diff {rel} "
        f"(bar 1e-05{f' + {risk_atol:.3e} on risks' if risk_atol else ''})")
    if not ok:
        raise AssertionError(f"{label}: kernel and plain routes disagree")


def check_fig3_routes() -> None:
    """fig3's two calls — (a) the padded N sweep, the (12, 500, 90)
    launches with counts, and (b) 3 rows at N = 500 — through the kernel
    and through the plain version on the card."""
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.core.theory import stepsize_theorem1
    from repro_torch.figures import FIG3, MSDProblem

    grid, steps, seeds = FIG3["n_grid"], FIG3["steps"], FIG3["seeds"]
    probs = [MSDProblem.make(n) for n in grid]
    mcs = [p.to_mc("cuda") for p in probs]
    chs = [ChannelConfig(fading=FIG3["fading"], scale=1.0, noise_std=1.0,
                         energy=1.0) for _ in grid]
    betas = [stepsize_theorem1(p.pc, c, n, safety=0.9)
             for p, c, n in zip(probs, chs, grid)]
    check_routes(f"fig3 part (a) (B=12, N={grid} padded to {max(grid)}, "
                 f"d=90, {steps} steps)", lambda impl: run_mc(
                     mcs, chs, "gbma", betas, steps, seeds, ota_impl=impl,
                     device="cuda"))
    n = grid[-1]
    chs = [ChannelConfig(fading=FIG3["fading"], scale=1.0, noise_std=1.0,
                         energy=float(n) ** (eps - 2.0))
           for eps in FIG3["eps_grid"]]
    betas = [stepsize_theorem1(probs[-1].pc, c, n, safety=0.9) for c in chs]
    check_routes(f"fig3 part (b) (B=12, N={n}, d=90, {steps} steps)",
                 lambda impl: run_mc(mcs[-1], chs, "gbma", betas, steps,
                                     seeds, ota_impl=impl, device="cuda"))


def _finite_rows(label: str, rows: list) -> None:
    """Every figure row's numbers (the value, and a ±ci95 column) are
    finite."""
    for r in rows:
        log(r)
        for field in r.split(",")[-2:]:
            value = field.rpartition("=")[2].lstrip("±")
            try:
                number = float(value)
            except ValueError:
                continue  # a key field, not a number
            if not math.isfinite(number):
                raise AssertionError(f"{label}: non-finite row {r!r}")


def run_figure_main_path(ops, label: str, run, expected: int) -> tuple:
    """One figure twin through the port's entry point with the OTA launch
    count set to 0 just before and read just after: (launches, rows,
    wall seconds). Fails unless the kernel ran `expected` times."""
    ops.launch_count = 0
    t0 = time.perf_counter()
    rows = run(device="cuda")
    wall = time.perf_counter() - t0
    launches = ops.launch_count
    _finite_rows(label, rows)
    log(f"{label} main path: {launches} OTA kernel launches; wall "
        f"{wall:.3f} s")
    if launches != expected:
        raise AssertionError(f"{label}: expected {expected} kernel "
                             f"launches, got {launches}")
    return launches, rows, wall


def run_fig3_main_path(ops) -> int:
    """The paper's operating point (fig3: N in (50, 160, 500), d = 90, 300
    steps, 4 seeds, Rayleigh) through the port's entry point: two
    `run_mc` calls, the padded N sweep and the energy sweep."""
    from repro_torch.figures import FIG3, run_fig3

    steps = 2 * FIG3["steps"]
    launches, rows, wall = run_figure_main_path(ops, "fig3", run_fig3,
                                                steps)
    log(f"fig3 main path: 2 run_mc calls x {FIG3['steps']} steps, "
        f"{wall / steps * 1e3:.3f} ms per step")
    for n in FIG3["n_grid"]:
        if f"fig3a,N={n},bound_holds,1" not in rows:
            raise AssertionError(f"fig3 N={n}: Theorem-1 bound violated")
    return launches


def run_fig4_main_path(ops) -> int:
    """Fig. 4 at N = 800 (gbma / fdm / centralized, one mixed call, 4
    seeds, 300 steps): the gbma row's group launches the kernel once a
    step. Route check first, then the main path."""
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.figures import FIG4, fig4_call, run_fig4

    mc, chs, algos, betas = fig4_call("cuda", **FIG4)
    check_routes(f"fig4 (B=12, N={FIG4['n']}, d=90, {algos}, "
                 f"{FIG4['steps']} steps)", lambda impl: run_mc(
                     mc, chs, algos, betas, FIG4["steps"], FIG4["seeds"],
                     ota_impl=impl, device="cuda"))
    launches, rows, wall = run_figure_main_path(ops, "fig4", run_fig4,
                                                FIG4["steps"])
    log(f"fig4: {wall / FIG4['steps'] * 1e3:.3f} ms per step; "
        + "; ".join(r for r in rows if "gbma_" in r))
    return launches


def run_fig6_main_path(ops) -> int:
    """Fig. 6 (N in (100, 200, 400, 800), one padded call, 3 seeds, 400
    steps): route check, then the main path."""
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.figures import FIG6, fig6_call, run_fig6

    mcs, chs, betas = fig6_call("cuda", **FIG6)
    check_routes(f"fig6 (B=12, N={FIG6['n_grid']} padded, d=90, "
                 f"{FIG6['steps']} steps)", lambda impl: run_mc(
                     mcs, chs, "gbma", betas, FIG6["steps"], FIG6["seeds"],
                     ota_impl=impl, device="cuda"))
    launches, rows, wall = run_figure_main_path(ops, "fig6", run_fig6,
                                                FIG6["steps"])
    log(f"fig6: {wall / FIG6['steps'] * 1e3:.3f} ms per step; "
        + "; ".join(r for r in rows if "decreases" in r))
    return launches


def _k1_launches(algos, steps: int) -> int:
    """K1 launches of one call: one a step when some row's slot goes
    through the OTA kernel (the gbma family, power_control)."""
    algos = (algos,) if isinstance(algos, str) else algos
    on_k1 = {"gbma", "momentum", "nesterov", "power_control"}
    return steps if on_k1 & set(algos) else 0


def run_ablations_main_path(ops) -> dict:
    """Ablations at N = 200: every call of every part through both routes
    at ABLATION_ROUTE_STEPS, then (a)(b)(c)(e)(g), (d) and (f) through
    the port's entry point in full, each its own main path (each OTA call
    one launch a step; (d) twice the steps; (f), blind rows only, none).
    Returns the launches of each main path."""
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.figures import (ABLATION_PARTS, ABLATIONS, MSDProblem,
                                     ablation_calls, run_ablations)

    n, steps, seeds = ABLATIONS["n"], ABLATIONS["steps"], ABLATIONS["seeds"]
    prob = MSDProblem.make(n)
    mc = prob.to_mc("cuda")
    expected = {}
    for part in ABLATION_PARTS:
        expected[part] = 0
        for label, chs, algos, betas, kw, factor in ablation_calls(part,
                                                                   prob, n):
            expected[part] += _k1_launches(algos, factor * steps)
            check_routes(
                f"ablation ({part}) {label} (B={len(chs) * seeds}, N={n}, "
                f"{ABLATION_ROUTE_STEPS} steps)", lambda impl: run_mc(
                    mc, chs, algos, betas, ABLATION_ROUTE_STEPS, seeds,
                    ota_impl=impl, device="cuda", **kw))
    launches = {}
    for parts in (("a", "b", "c", "e", "g"), ("d",), ("f",)):
        label = "ablations " + "".join(f"({p})" for p in parts)
        want = sum(expected[p] for p in parts)
        launches[label], _, wall = run_figure_main_path(
            ops, label, lambda device, parts=parts: run_ablations(
                device=device, parts=parts), want)
        log(f"{label}: {want} K1 launches expected, wall {wall:.3f} s")
    return launches


def run_fig5_main_path(ops) -> int:
    """Fig. 5 (localization, N = 200, d = 2, gbma / fdm / centralized from
    θ0 = (45, 45), 3 seeds, 3,000 steps): the route check at
    FIG5_ROUTE_STEPS, then the main path, one K1 launch a step."""
    import numpy as np

    from repro_torch.core.mc.engine import run_mc
    from repro_torch.figures import FIG5, FIG5_THETA0, fig5_call, run_fig5

    mc, chs, algos, betas = fig5_call("cuda", **FIG5)
    check_routes(f"fig5 (B=9, N={FIG5['n']}, d=2, {algos}, "
                 f"{FIG5_ROUTE_STEPS} steps)", lambda impl: run_mc(
                     mc, chs, algos, betas, FIG5_ROUTE_STEPS, FIG5["seeds"],
                     theta0=np.array(FIG5_THETA0), ota_impl=impl,
                     device="cuda"))
    launches, rows, wall = run_figure_main_path(ops, "fig5", run_fig5,
                                                FIG5["steps"])
    log(f"fig5: {wall / FIG5['steps'] * 1e3:.3f} ms per step; "
        + "; ".join(r for r in rows if "converges" in r))
    if "fig5,gbma_converges,1" not in rows:
        raise AssertionError("fig5: gbma does not converge")
    return launches


def run_fig7_main_path(ops) -> int:
    """Fig. 7 (blind transmitters: (a) N in (50, 160, 500) at M = 32, (b)
    M in (1, 4, 16, 64) at N = 160; d = 90, 4 seeds, 600 steps): both
    calls through both routes at FIG7_ROUTE_STEPS, then the main path;
    the gbma group (M = 1 as a per-row count) launches K1 once a step."""
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.figures import FIG7, fig7_calls, run_fig7

    for part, (mcs, chs, algos, betas, kw) in zip(
            "ab", fig7_calls("cuda", **FIG7)):
        check_routes(f"fig7 ({part}) (B={len(chs) * FIG7['seeds']}, "
                     f"M={kw['n_antennas']}, d=90, {FIG7_ROUTE_STEPS} "
                     "steps)", lambda impl: run_mc(
                         mcs, chs, algos, betas, FIG7_ROUTE_STEPS,
                         FIG7["seeds"], ota_impl=impl, device="cuda", **kw))
    steps = 2 * FIG7["steps"]
    launches, rows, wall = run_figure_main_path(ops, "fig7", run_fig7,
                                                steps)
    log(f"fig7: 2 run_mc calls x {FIG7['steps']} steps, "
        f"{wall / steps * 1e3:.3f} ms per step")
    return launches


def run_fig8_main_path(ops) -> int:
    """Fig. 8 (federated logistic regression: (a) N in (20, 40, 80) at
    minibatch fraction 1/2 with blind rows at M = 16, (b) fractions (1,
    1/2, 1/4) at N = 40; d = 16, 4 seeds, 300 steps): both calls through
    both routes at FIG8_ROUTE_STEPS (risks also within the logistic
    floor, ROADMAP §3 F8), then the main path, one K1 launch a step of
    each call."""
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.figures import FIG8, fig8_calls, run_fig8

    for part, (probs, chs, algos, betas, kw) in zip(
            "ab", fig8_calls("cuda", **FIG8)):
        listed = probs if isinstance(probs, list) else [probs]
        check_routes(f"fig8 ({part}) (B={len(chs) * FIG8['seeds']}, "
                     f"{kw}, d=16, {FIG8_ROUTE_STEPS} steps)",
                     lambda impl: run_mc(probs, chs, algos, betas,
                                         FIG8_ROUTE_STEPS, FIG8["seeds"],
                                         ota_impl=impl, device="cuda", **kw),
                     risk_atol=logistic_atol(listed))
    steps = 2 * FIG8["steps"]
    launches, rows, wall = run_figure_main_path(ops, "fig8", run_fig8,
                                                steps)
    log(f"fig8: 2 run_mc calls x {FIG8['steps']} steps, "
        f"{wall / steps * 1e3:.3f} ms per step")
    return launches


def large_workload():
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.figures import MSDProblem

    prob = MSDProblem.make(LARGE["n"], dim=LARGE["dim"])
    ch = ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                       energy=1.0 / LARGE["n"])
    return prob.to_mc("cuda"), ch, 0.01


def large_sweep_workload():
    """LARGE as a node-count sweep: a row per N at E_N = 1/N, β = 0.01."""
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.figures import MSDProblem

    grid, dim = LARGE_SWEEP["n_grid"], LARGE_SWEEP["dim"]
    mcs = [MSDProblem.make(n, dim=dim).to_mc("cuda") for n in grid]
    chs = [ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                         energy=1.0 / n) for n in grid]
    return mcs, chs, [0.01] * len(grid)


def large_mrc_workload():
    """LARGE with a 16-antenna edge: gbma at E_N = 1/N, β = 0.01."""
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.figures import MSDProblem

    prob = MSDProblem.make(LARGE_MRC["n"], dim=LARGE_MRC["dim"])
    ch = ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                       energy=1.0 / LARGE_MRC["n"])
    return prob.to_mc("cuda"), ch, 0.01


def run_large_main_path(ops, label: str, mcs, chs, betas, steps: int,
                        seeds: int, route_seeds: int = 64,
                        route_steps: int = None, **kw) -> tuple:
    """A LARGE-scale gbma call (keep_seed_curves=False): the kernel and
    plain routes at `route_seeds` seeds a row (`route_steps` steps, all
    by default), then the call at `seeds` seeds a row with its wall, peak
    device memory and launches (one per step for all trajectories).
    Returns (launches, seconds per step)."""
    import numpy as np
    import torch

    from repro_torch.core.mc.engine import run_mc

    check_routes(f"{label} at {route_seeds} seeds a row, "
                 f"{route_steps or steps} steps", lambda impl: run_mc(
                     mcs, chs, "gbma", betas, route_steps or steps,
                     route_seeds, keep_seed_curves=False, ota_impl=impl,
                     device="cuda", **kw), fields=("mean",))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.launch_count = 0
    t0 = time.perf_counter()
    res = run_mc(mcs, chs, "gbma", betas, steps, seeds,
                 keep_seed_curves=False, device="cuda", **kw)
    wall = time.perf_counter() - t0
    launches = ops.launch_count
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} main path: {len(chs)} row(s) x {seeds} seeds x {steps} "
        f"steps: wall {wall:.3f} s, {wall / steps * 1e3:.3f} ms per step, "
        f"peak device memory {peak / 2**20:.1f} MiB, {launches} OTA kernel "
        f"launches; mean risk per row {res.mean[:, 0]} -> "
        f"{res.mean[:, -1]}")
    if launches != steps:
        raise AssertionError(f"{label}: expected {steps} launches, got "
                             f"{launches}")
    if not (np.all(np.isfinite(res.mean))
            and np.all(res.mean[:, -1] < res.mean[:, 0])):
        raise AssertionError(f"{label}: mean curves not finite or not "
                             "falling")
    return launches, wall / steps


# the "exec plans" phase at LARGE: the reference's chunk of its
# hoisted throughput path (`bench_montecarlo.py:370-374`), and the resume
# and retry run's chunk, stop offset and fault offset
EXEC_CHUNK = 32
EXEC_RESUME_CHUNK = 128
EXEC_STOP_AT = 384
EXEC_FAULT_AT = 512


def run_exec_plans(ops) -> dict:
    """Execution plans at LARGE (N = 4096, d = 24, 150 steps, 1,024
    seeds, gbma, Rayleigh), every call through `run_mc`: (a) 'inscan', all
    seeds live, curves kept; (b) 'hoisted', the same; (c) 'hoisted' in
    chunks of 32, reduced; (e) `plan="auto"`; (f) 'hoisted' in chunks of
    128, reduced, run uninterrupted, stopped by a chunk fault at offset
    384 and resumed from its `resume_dir`, and with one fault at offset
    512 under `RetryPolicy(max_attempts=2)`; then (d) 'inscan' in chunks
    of 32, reduced, the long one (32 host-bound chunks), once the others
    have warmed everything. Each prints its wall (host clock, ending in a
    synchronize), K1's launches (150 a chunk), and its measured peak
    device memory beside `estimate_peak_bytes`. Checks (b) == (a), (c) ==
    (d) and (e) == (c) bit for bit, (e) resolving to chunks of 32, (c)'s
    mean within 1e-5 rel of (a)'s and its ci95 within F3's bar, and the
    resumed and retried runs equal to the uninterrupted one bit for bit.
    Returns (K1's launches per call, each call's record)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.core.mc import exec as exec_mod
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.core.mc.plan import ExecPlan, RetryPolicy

    mc, ch, beta = large_workload()
    n, d, steps, seeds = (LARGE["n"], LARGE["dim"], LARGE["steps"],
                          LARGE["seeds"])
    args = (mc, [ch], "gbma", [beta], steps, seeds)
    launches, record = {}, {}

    def call(label: str, chunks: int, est: dict, stops: bool = False,
             **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.launch_count = 0
        t0 = time.perf_counter()
        try:
            res = run_mc(*args, device="cuda", **kw)
        except RuntimeError as err:
            if not stops:
                raise
            res = None
            log(f"exec plans {label}: the sweep stopped as injected: {err}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        count = ops.launch_count
        peak = torch.cuda.max_memory_allocated()
        if stops and res is not None:
            raise AssertionError(f"exec plans {label}: the injected fault "
                                 "did not stop the sweep")
        estimate = exec_mod.estimate_peak_bytes(
            n_rows=1, seeds=seeds, steps=steps, n_max=n, dim=d,
            **est)["device_peak_bytes"]
        record[label] = {"wall_s": wall, "launches": count,
                         "chunks": chunks, "peak_bytes": peak,
                         "resident_bytes": base,
                         "estimate_bytes": estimate,
                         "peak_over_estimate": peak / estimate}
        launches[f"exec plans {label}"] = count
        log(f"exec plans {label}: wall {wall:.3f} s, {count} OTA kernel "
            f"launches ({chunks} chunk(s) x {steps}), peak device memory "
            f"{peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB resident "
            f"before the call), estimate_peak_bytes {estimate / 2**20:.1f} "
            f"MiB, peak / estimate {peak / estimate:.3f}")
        if count != steps * chunks:
            raise AssertionError(f"exec plans {label}: expected "
                                 f"{steps * chunks} launches, got {count}")
        return res

    def same(label: str, a, b, fields) -> None:
        for f in fields:
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"exec plans: {label} differ in {f}")
        log(f"exec plans: {label} equal bit for bit in {fields}")

    whole = {"seed_chunk": None, "keep_seed_curves": True}
    chunked = {"seed_chunk": EXEC_CHUNK, "keep_seed_curves": False}
    a = call("(a) inscan, all live, curves", 1,
             {"rng_plan": "inscan", **whole}, rng_plan="inscan")
    b = call("(b) hoisted, all live, curves", 1,
             {"rng_plan": "hoisted", **whole}, rng_plan="hoisted")
    same("(b) and (a)", b, a, ("risks", "cum_energy", "mean", "ci95"))
    c = call("(c) hoisted, chunks of 32, reduced", seeds // EXEC_CHUNK,
             {"rng_plan": "hoisted", **chunked}, rng_plan="hoisted",
             **chunked)
    e = call("(e) plan='auto'", seeds // EXEC_CHUNK,
             {"rng_plan": "hoisted", **chunked}, plan="auto")
    log(f"exec plans (e): auto_plan resolved {e.plan}")
    if e.plan.seed_chunk != EXEC_CHUNK or e.plan.keep_seed_curves:
        raise AssertionError(f"exec plans (e): expected chunks of "
                             f"{EXEC_CHUNK}, reduced; got {e.plan}")
    same("(e) and (c)", e, c, ("mean", "ci95"))
    rel = float(np.max(np.abs(c.mean - a.mean) / np.abs(a.mean)))
    ci_ok = bool(np.all(np.abs(c.ci95 - a.ci95)
                        <= 1e-5 * np.abs(a.ci95) + 1e-5 * np.abs(a.mean)))
    log(f"exec plans: (c) mean vs (a): max rel {rel:.3e} (bar 1e-05); ci95 "
        f"within F3's bar (rtol 1e-5 + atol 1e-5 |mean|): {ci_ok}")
    if rel > 1e-5 or not ci_ok:
        raise AssertionError("exec plans: (c) moments off (a)'s curves")

    plan = ExecPlan(seed_chunk=EXEC_RESUME_CHUNK, keep_seed_curves=False)
    per = seeds // EXEC_RESUME_CHUNK
    est = {"rng_plan": "hoisted", "seed_chunk": EXEC_RESUME_CHUNK,
           "keep_seed_curves": False}
    f_clean = call("(f) hoisted, chunks of 128, uninterrupted", per, est,
                   plan=plan)

    def fault_at(off: int, times: int):
        fired = []

        def hook(info):
            if info["off"] == off and info["attempt"] <= times:
                fired.append(info)
                raise RuntimeError(f"injected chunk fault at off={off}")
        return fired, exec_mod.install_chunk_fault_hook(hook)

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as resume_dir:
        fired, remove = fault_at(EXEC_STOP_AT, 1)
        try:
            call("(f) stopped at 384", EXEC_STOP_AT // EXEC_RESUME_CHUNK,
                 est, stops=True, plan=plan, resume_dir=resume_dir)
        finally:
            remove()
        if len(fired) != 1:
            raise AssertionError(f"exec plans (f): {len(fired)} faults "
                                 "fired at the stop")
        saved = ckpt.peek(os.path.join(resume_dir, exec_mod._RESUME_FILE))
        if int(saved["next_off"]) != EXEC_STOP_AT:
            raise AssertionError(f"exec plans (f): checkpoint at "
                                 f"{int(saved['next_off'])}, not "
                                 f"{EXEC_STOP_AT}")
        resumed = call("(f) resumed from 384",
                       per - EXEC_STOP_AT // EXEC_RESUME_CHUNK, est,
                       plan=plan, resume_dir=resume_dir)
    same("(f) resumed and uninterrupted", resumed, f_clean, ("mean", "ci95"))
    fired, remove = fault_at(EXEC_FAULT_AT, 1)
    try:
        retried = call("(f) one fault at 512, retried", per, est,
                       plan=plan.replace(retry=RetryPolicy(
                           max_attempts=2, sleep=lambda dt: None)))
    finally:
        remove()
    if len(fired) != 1:
        raise AssertionError(f"exec plans (f): {len(fired)} faults fired")
    same("(f) retried and uninterrupted", retried, f_clean, ("mean", "ci95"))

    dd = call("(d) inscan, chunks of 32, reduced", seeds // EXEC_CHUNK,
              {"rng_plan": "inscan", **chunked}, rng_plan="inscan",
              **chunked)
    same("(c) and (d)", c, dd, ("mean", "ci95"))
    log(f"exec plans: {json.dumps(record)}")
    return launches, record


def step_breakdown() -> dict:
    """CUDA-event times of the pieces of one LARGE step (B = 1024
    trajectories) and one LARGE MRC step (the same with M = 16 antennas):
    the antenna keys, the gain draws (per antenna at MRC: B·M·N complex
    gains) and the noise draws, the gradient, the risk, the energy sum,
    the OTA kernel, the mean over the antennas and the θ update, and the
    gbma slot whole — where a step's time goes. Returns ms per piece per
    cell."""
    import torch

    from repro_torch.core import rng
    from repro_torch.core.mc.engine import ChannelBatch
    from repro_torch.core.mc.problems import MCProblemBatch
    from repro_torch.core.mc.slots import (SlotCtx, _antenna_mean, _gains,
                                           _gbma_slot, _ota_draw,
                                           _step_antenna_keys, with_antennas)
    from repro_torch.kernels.ota.ops import ota_edge_aggregate

    mc, ch, beta = large_workload()
    b, n, d = LARGE["seeds"], LARGE["n"], LARGE["dim"]
    batch = MCProblemBatch.stack([mc])
    p = {k: v.to("cuda").repeat(b) for k, v in
         ChannelBatch.stack([ch]).params.items()}
    p["n_nodes"] = torch.full((b,), float(n), device="cuda")
    ctx = SlotCtx(fading="rayleigh", p=p,
                  mask=torch.ones((b, n), device="cuda"),
                  counts=torch.full((b,), n, device="cuda"), n_sizes=(n,),
                  phase_zero=True)
    keys = rng.key(torch.arange(b, device="cuda"))
    theta = torch.zeros((1, b, d), device="cuda")
    mom = torch.zeros((b, d), device="cuda")
    gamma = torch.zeros((b,), device="cuda")
    betas = torch.full((b,), beta, device="cuda")
    g = batch.grad_fn(batch.data, theta).reshape(b, n, d)
    dr = _ota_draw(keys, ctx, n, d)
    common = {
        "gradient (B,N,d)": lambda: batch.grad_fn(batch.data, theta),
        "risk": lambda: batch.risk_fn(batch.data, theta),
        "energy sum": lambda: (g * g).sum(dim=(1, 2)),
        "theta update": lambda: theta[0] - betas[:, None] * (
            gamma[:, None] * mom + dr["w"]),
    }
    cells = {"LARGE": {
        "draws (gains + noise, threefry)": lambda: _ota_draw(keys, ctx, n,
                                                             d),
        **common,
        "OTA kernel": lambda: ota_edge_aggregate(
            g, dr["h"], dr["w"], noise_scale=1.0, impl="kernel"),
    }}
    m = LARGE_MRC["m"]
    mctx = with_antennas(ctx, m, ())
    akeys = rng.split(_step_antenna_keys(keys, mctx))
    h = _gains(akeys[:, 0], mctx.ant, n).view(b, m, n)
    w = rng.normal(akeys[:, 1], (d,)).view(b, m, d)
    v = ota_edge_aggregate(g, h, w, noise_scale=1.0, impl="kernel")
    cells["LARGE MRC"] = {
        "antenna keys (B -> B*M, then k_h, k_w)": lambda: rng.split(
            _step_antenna_keys(keys, mctx)),
        "gain draws (B*M*N gains)": lambda: _gains(
            akeys[:, 0], mctx.ant, n),
        "noise draws (B*M*d)": lambda: rng.normal(akeys[:, 1], (d,)),
        **common,
        "OTA kernel (B, M, N, d)": lambda: ota_edge_aggregate(
            g, h, w, noise_scale=1.0, impl="kernel"),
        "antenna mean": lambda: _antenna_mean(v, mctx),
        "gbma slot whole (keys, draws, kernel, mean)": lambda: _gbma_slot(
            g, keys, mctx),
    }
    out = {}
    for cell, parts in cells.items():
        total = 0.0
        out[cell] = {}
        for name, fn in parts.items():
            ms = cuda_ms(fn, reps=20)
            out[cell][name] = ms
            if "whole" not in name:
                total += ms
            log(f"{cell} step breakdown: {name}: {ms:.4f} ms")
        log(f"{cell} step breakdown: sum of parts {total:.4f} ms")
    return out


_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def _profile_counts(fn, kernel: str = "ota_aggregate") -> dict:
    """Run `fn` under torch.profiler: kernel launches, host synchronizing
    calls and copies issued, the device's busy time (the sum of its
    kernel, copy and fill intervals, one stream), its host-to-device
    copies, and the launches and device time of the kernels whose name
    holds `kernel`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {"launches": 0, "syncs": 0, "memcpy": 0, "device_us": 0.0,
              "device_events": 0, "h2d": 0, "kernel_us": 0.0, "kernel": 0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            counts["device_us"] += us
            counts["device_events"] += 1
            counts["h2d"] += "HtoD" in e.name
            if kernel in e.name:
                counts["kernel_us"] += us
                counts["kernel"] += 1
        elif e.name.startswith(("cudaLaunch", "cuLaunch")):
            counts["launches"] += 1
        elif e.name in _SYNC_CALLS:
            counts["syncs"] += 1
        elif e.name.startswith("cudaMemcpy"):
            counts["memcpy"] += 1
    return counts


def _base_profile_cases() -> dict:
    """The step profile's cases that every slice of the port runs: one
    N = 500 fig3 row of 4 seeds under `run_mc`'s default RNG plan
    ('hoisted' since execution plans; the tree of `--profile-src` must
    take `rng_plan`) and under 'inscan', and LARGE ('inscan': hoisted, it
    holds 2.5 GB of draws). name -> (run(steps), n, dim, trajectories)."""
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.core.theory import stepsize_theorem1
    from repro_torch.figures import MSDProblem

    prob = MSDProblem.make(500)
    fig3_ch = ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                            energy=1.0)
    fig3 = (prob.to_mc("cuda"), fig3_ch,
            stepsize_theorem1(prob.pc, fig3_ch, 500, safety=0.9), 4)
    cases = {"fig3": fig3 + ({},),
             "fig3 (inscan)": fig3 + ({"rng_plan": "inscan"},),
             "large": large_workload() + (LARGE["seeds"],
                                          {"rng_plan": "inscan"})}
    out = {}
    for name, (mc, ch, beta, seeds, kw) in cases.items():
        out[name] = (lambda steps, mc=mc, ch=ch, beta=beta, seeds=seeds,
                     kw=kw: run_mc(mc, [ch], "gbma", [beta], steps, seeds,
                                   keep_seed_curves=False, device="cuda",
                                   **kw),
                     mc.n_nodes, mc.dim, seeds)
    return out


def _new_path_profile_cases() -> dict:
    """The step profile's cases of the later slices' paths: fig4, fig5,
    fig6, fig7 (b), fig8 (a), one call of each ablation part, the LARGE
    sweep and LARGE MRC."""
    import numpy as np

    from repro_torch.core.mc.engine import run_mc
    from repro_torch.figures import (ABLATION_PARTS, ABLATIONS, FIG4, FIG5,
                                     FIG5_THETA0, FIG6, FIG7, FIG8,
                                     MSDProblem, ablation_calls, fig4_call,
                                     fig5_call, fig6_call, fig7_calls,
                                     fig8_calls)

    def case(mcs, chs, algos, betas, seeds, **kw):
        n = max(m.n_nodes for m in mcs) if isinstance(mcs, list) \
            else mcs.n_nodes
        dim = (mcs[0] if isinstance(mcs, list) else mcs).dim
        return (lambda steps: run_mc(mcs, chs, algos, betas, steps, seeds,
                                     keep_seed_curves=False, device="cuda",
                                     **kw),
                n, dim, len(chs) * seeds)

    mc, chs, algos, betas = fig4_call("cuda", **FIG4)
    cases = {"fig4": case(mc, chs, algos, betas, FIG4["seeds"])}
    mc, chs, algos, betas = fig5_call("cuda", **FIG5)
    cases["fig5"] = case(mc, chs, algos, betas, FIG5["seeds"],
                         theta0=np.array(FIG5_THETA0))
    mcs, chs, betas = fig6_call("cuda", **FIG6)
    cases["fig6"] = case(mcs, chs, "gbma", betas, FIG6["seeds"])
    mc, chs, algos, betas, kw = fig7_calls("cuda", **FIG7)[1]
    cases["fig7 (b)"] = case(mc, chs, algos, betas, FIG7["seeds"], **kw)
    probs, chs, algos, betas, kw = fig8_calls("cuda", **FIG8)[0]
    cases["fig8 (a)"] = case(probs, chs, algos, betas, FIG8["seeds"], **kw)
    n = ABLATIONS["n"]
    prob = MSDProblem.make(n)
    mc = prob.to_mc("cuda")
    # part (b): rician (the most draws); (c): the power_control call;
    # (d): M = 16; (e): gamma = 0.9; (a), (f), (g): their one call
    pick = {"a": 0, "b": 2, "c": 1, "d": 2, "e": 1, "f": 0, "g": 0}
    for part in ABLATION_PARTS:
        label, chs, algos, betas, kw, _ = ablation_calls(part, prob, n)[
            pick[part]]
        cases[f"ablation ({part})"] = case(mc, chs, algos, betas,
                                           ABLATIONS["seeds"], **kw)
    mcs, chs, betas = large_sweep_workload()
    cases["large sweep"] = case(mcs, chs, "gbma", betas,
                                LARGE_SWEEP["seeds"], rng_plan="inscan")
    mc, ch, beta = large_mrc_workload()
    cases["large mrc"] = case(mc, [ch], "gbma", [beta], LARGE_MRC["seeds"],
                              n_antennas=LARGE_MRC["m"], rng_plan="inscan")
    return cases


def step_profile(cases: dict) -> dict:
    """Per-step cost of `run_mc` calls (`cases`: name -> (run(steps), n,
    dim, trajectories)): wall time from the host clock without the
    profiler, and launches, synchronizations, copies and device busy time
    from torch.profiler. Each is the difference of a long and a short run
    over the difference of their steps, so set-up and read-back cancel."""
    import torch

    out = {}
    for name, (run, n, dim, trajectories) in cases.items():
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
            "n": n, "dim": dim, "trajectories": trajectories,
            "wall_ms_per_step": wall_ms,
            "launches_per_step": per["launches"],
            "ota_launches_per_step": per["kernel"],
            "syncs_per_step": per["syncs"],
            "memcpy_per_step": per["memcpy"],
            "h2d_copies_per_step": per["h2d"],
            "ota_device_us_per_launch": per["kernel_us"] / per["kernel"]
            if per["kernel"] else None,
            "device_busy_ms_per_step": busy_ms if hi["device_events"]
            else None,
            "device_idle_share": 1.0 - busy_ms / wall_ms
            if hi["device_events"] else None}
        log(f"step profile {name}: {json.dumps(out[name])}")
    return out


# ---------------------------------------------------------------- serving
def build_kernels() -> tuple:
    """Build every CUDA source at once (one nvcc each) and print what
    ptxas reports (registers, spills), the dynamic shared memory of each
    attention kernel per head_dim, K1's registers, spills and shared
    memory per instantiation (`ota_build_summary`), the SASS of the bf16
    (`sass_summary`) and the f32 (`f32_sass_summary`) attention kernels
    and the WKV kernel's registers, spills and shared memory
    (`wkv_build_summary`), which it returns."""
    import torch

    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.ota import kernel as ota_kernel
    from repro_torch.kernels.wkv import kernel as wkv_kernel

    builds = {"ota_aggregate": (ota_kernel.build, ota_kernel.SOURCE),
              "flash_attention": (attn_kernel.build, attn_kernel.SOURCE),
              "flash_attention_sm90": (attn_kernel.build_sm90,
                                       attn_kernel.SM90_SOURCE),
              "wkv6": (wkv_kernel.build, wkv_kernel.SOURCE)}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futs = {name: pool.submit(fn) for name, (fn, _) in builds.items()}
        infos = {name: f.result() for name, f in futs.items()}
    log(f"build: {len(builds)} sources in {time.perf_counter() - t0:.2f} s "
        "wall")
    for name, info in infos.items():
        log(f"build: {builds[name][1].name} -> {info.path.name} in "
            f"{info.seconds:.2f} s")
        if name == "ota_aggregate":  # 24 instantiations: their summary
            continue
        for line in info.log.splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"  {line.strip()}")
    for dtype in (torch.float32, torch.bfloat16):
        smem = {d: attn_kernel.smem_bytes(d, dtype)
                for d in attn_kernel.HEAD_DIMS}
        log(f"flash_attention {dtype} dynamic shared memory per block by "
            f"head_dim: {smem}")
    return (ota_build_summary(infos["ota_aggregate"]),
            sass_summary(infos["flash_attention_sm90"].path),
            f32_sass_summary(infos["flash_attention"]),
            wkv_build_summary(infos["wkv6"]))


def _sass(lib) -> str:
    """`cuobjdump -sass` of a built library, or "" where the tool is
    missing."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return ""
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def sass_summary(lib) -> dict:
    """Per kernel instantiation of the bf16 attention library, keyed
    "d=<head_dim>" and "d=<head_dim> softcap", from its SASS
    (`cuobjdump -sass`): the HGMMA (wgmma) instructions, the waits on
    them (WARPGROUP.DEPBAR; one after every HGMMA means ptxas serialized
    them) and the highest register. Raises if one has no HGMMA; logs and
    returns None per head_dim where the tool is missing."""
    import re

    from repro_torch.kernels.attention import kernel as attn_kernel

    sass = _sass(lib)
    if not sass:
        log("flash_attention_sm90 SASS: cuobjdump not found, HGMMA count "
            "skipped")
        return {f"d={d}": None for d in attn_kernel.HEAD_DIMS}
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"flash_attention_sm90_kernelILi(\d+)ELb(\d)E", fn)
        if m:
            key = f"d={m.group(1)}" + (" softcap" if m.group(2) == "1"
                                       else "")
            out[key] = {
                "hgmma": len(re.findall(r"\bHGMMA\.", fn)),
                "hgmma_waits": len(re.findall(r"WARPGROUP\.DEPBAR", fn)),
                "max_register": max(int(r) for r in
                                    re.findall(r"\bR(\d+)\b", fn))}
    log(f"flash_attention_sm90 SASS per kernel: {out}")
    if len(out) != 2 * len(attn_kernel.HEAD_DIMS) or not all(
            v["hgmma"] for v in out.values()):
        raise AssertionError("the bf16 attention kernel has no HGMMA "
                             "(wgmma) instruction in some instantiation")
    return out


def ptxas_by_kernel(log: str, key) -> dict:
    """Registers and spill bytes per kernel from `ptxas -v` output, keyed
    by `key(mangled name)` (kernels it maps to None are left out)."""
    import re

    out = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            name = key(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if name and m:
            out.setdefault(name, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if name and m:
            out.setdefault(name, {})["static_smem_bytes"] = int(m.group(1))
    return out


# K1's instantiations: (antennas per block, columns per thread)
OTA_CHUNKS = ((1, 1), (8, 1), (8, 2))


def ota_build_summary(info) -> dict:
    """Per instantiation of K1, keyed "g=<f32|bf16> out=<f32|bf16>
    counts=<0|1> chunk=<antennas per block> vec=<columns per thread>":
    ptxas's registers, spill bytes and static shared memory. Raises if
    the report is empty or lacks an instantiation."""
    import re

    def dt(code):  # a repeated bf16 is mangled as a substitution, S<n>_
        return "f32" if code == "f" else "bf16"

    def key(mangled):
        m = re.search(r"ota_aggregate_kernelI(f|13__nv_bfloat16)"
                      r"(f|13__nv_bfloat16|S\d*_)Lb(\d)ELi(\d+)ELi(\d+)E",
                      mangled)
        if not m:
            return None
        return (f"g={dt(m.group(1))} out={dt(m.group(2))} "
                f"counts={m.group(3)} chunk={m.group(4)} vec={m.group(5)}")

    out = ptxas_by_kernel(info.log, key)
    want = {f"g={g} out={o} counts={c} chunk={k} vec={v}"
            for g in ("f32", "bf16") for o in ("f32", "bf16")
            for c in (0, 1) for k, v in OTA_CHUNKS}
    spills = sum(r.get("spill_stores", 0) + r.get("spill_loads", 0)
                 for r in out.values())
    regs = sorted({r.get("registers") for r in out.values()})
    log(f"ota_aggregate ptxas per instantiation (registers {regs}, spill "
        f"bytes {spills} in all): {json.dumps(out)}")
    if set(out) != want or not all("registers" in r for r in out.values()):
        raise AssertionError(f"K1's ptxas report lacks instantiations: "
                             f"{sorted(want - set(out))}")
    return out


def wkv_build_summary(info) -> dict:
    """Per instantiation of the WKV library, keyed "<dtype> d=<head_dim>
    copy=<16|element>": ptxas's registers and spill bytes and the block's
    dynamic shared memory. Raises if an instantiation is missing."""
    import re

    import torch

    from repro_torch.kernels.wkv import kernel as wkv_kernel

    def key(mangled):
        m = re.search(r"wkv6_kernelI(13__nv_bfloat16|f)Li(\d+)ELb(\d)E",
                      mangled)
        if not m:
            return None
        dtype = "bf16" if m.group(1) != "f" else "f32"
        copy = "16" if m.group(3) == "1" else "element"
        return f"{dtype} d={m.group(2)} copy={copy}"

    out = ptxas_by_kernel(info.log, key)
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for d in wkv_kernel.HEAD_DIMS:
            smem = wkv_kernel.smem_bytes(d, dtype)
            for copy in ("16", "element"):
                out.setdefault(f"{name} d={d} copy={copy}", {})[
                    "smem_bytes"] = smem
    log(f"wkv6 ptxas and shared memory per kernel: {out}")
    if info.log and not all("registers" in v for v in out.values()):
        raise AssertionError("the WKV library lacks an instantiation")
    return out


def f32_sass_summary(info) -> dict:
    """Per instantiation of the f32 attention library, keyed
    "d=<head_dim> copy=<16|4>": from its SASS the FFMA count, the 128-bit
    shared loads (LDS.128) against the narrower ones (LDS, LDS.32,
    LDS.64) and the highest register; from ptxas (`info.log`) its
    registers and spill bytes. Raises if any instantiation holds a
    tensor-core instruction (HMMA, HGMMA): the f32 products must stay on
    the CUDA cores (TF32 cannot hold the f32 bar). Logs and returns None
    per instantiation where cuobjdump is missing."""
    import re

    from repro_torch.kernels.attention import kernel as attn_kernel

    def key(mangled):
        m = re.search(r"flash_attention_kernelILi(\d+)E(?:Lb(\d)E)?",
                      mangled)
        if not m:
            return None
        width = {"1": " copy=16", "0": " copy=4"}.get(m.group(2), "")
        return f"d={m.group(1)}{width}"

    ptxas = ptxas_by_kernel(info.log, key)
    sass = _sass(info.path)
    if not sass:
        log("flash_attention SASS: cuobjdump not found, FFMA and LDS counts "
            f"skipped; ptxas: {ptxas}")
        return {f"d={d} copy={w}": None for d in attn_kernel.HEAD_DIMS
                for w in (16, 4)}
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = key(fn.split("\n", 1)[0])
        if not name:
            continue
        lds = re.findall(r"\bLDS((?:\.[A-Z0-9]+)*)\s", fn)
        out[name] = {
            "ffma": len(re.findall(r"\bFFMA\b", fn)),
            "lds128": sum("128" in x for x in lds),
            "lds_narrower": sum("128" not in x for x in lds),
            "tensor_core": len(re.findall(r"\bH(?:G)?MMA\b", fn)),
            "max_register": max(int(r) for r in
                                re.findall(r"\bR(\d+)\b", fn)),
            **ptxas.get(name, {})}
    log(f"flash_attention (f32) SASS and ptxas per kernel: {out}")
    if {k.split()[0] for k in out} != {f"d={d}"
                                       for d in attn_kernel.HEAD_DIMS}:
        raise AssertionError("the f32 attention library lacks an "
                             "instantiation")
    if any(v["tensor_core"] for v in out.values()):
        raise AssertionError("the f32 attention kernel holds a tensor-core "
                             "instruction (HMMA/HGMMA): TF32 is barred")
    return out


def attention_bound(b, h, s, d, dtype_name) -> tuple:
    """(least ms, what bounds it) for one causal self-attention call: q, k,
    v read once and o written once, against 4·d flops (the QKᵀ and PV
    products) for each of the s(s + 1)/2 live (query, key) pairs, at the
    peak rate of the inputs' type (bf16: tensor cores; f32: the CUDA
    cores, since TF32 cannot meet the kernel's bar)."""
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = elt * b * h * d * 4 * s
    flops = 4.0 * b * h * d * (s * (s + 1) // 2)
    peak = BF16_FLOPS_PER_S if dtype_name == "bfloat16" else F32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_inputs(b, hq, hkv, s, d, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((b, h, s, d), generator=gen, device="cuda")
                 .to(dtype) for h in (hq, hkv, hkv))


def check_attention_vs_plain() -> dict:
    """The attention kernels against their plain version on the card: at
    the reference tests' seven cases in f32 (the CUDA-core kernel; atol
    5e-5 + rtol 1e-4) and in bf16 (the Hopper kernel; atol 3e-2), at the
    serving slice's shapes, and on (B, S, H, d) views, bit for bit
    against contiguous copies: in both dtypes views of the projections'
    memory, read in place, and views offset by one element in 68-wide
    rows, which the f32 kernel reads with its 4-byte copies and the bf16
    kernel, whose TMA cannot load them, from copies (`ops.tma_ready`).
    Each line names its route: the f32 copy width (`kernel.copy_bytes`),
    or which bf16 operands were copied. Returns the max abs error per
    slice shape."""
    import torch

    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ops import multi_head_attention

    def route(q, k, v):
        if q.dtype == torch.bfloat16:
            copied = [name for name, t in zip("qkv", (q, k, v))
                      if not attn_ops.tma_loadable(t)]
            return "TMA" + (f" on copies of {', '.join(copied)}"
                            if copied else "")
        return f"{kernel.copy_bytes(q, k, v)}-byte copies"

    def compare(label, q, k, v, kw, atol, rtol):
        scale = q.shape[-1] ** -0.5
        ker = multi_head_attention(q, k, v, scale=scale, impl="kernel", **kw)
        ref = multi_head_attention(q, k, v, scale=scale, impl="ref", **kw)
        torch.cuda.synchronize()
        err = (ker.float() - ref.float()).abs()
        ok = bool(torch.all(torch.isfinite(ker.float()))) and bool(
            torch.all(err <= atol + rtol * ref.float().abs()))
        log(f"attention kernel-vs-plain {label} q{tuple(q.shape)} "
            f"kv{tuple(k.shape)} {q.dtype} ({route(q, k, v)}) {kw}: "
            f"max_abs_err={err.max().item():.3e} atol={atol} rtol={rtol} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"attention kernel disagrees with its "
                                 f"plain version at {label}")
        return err.max().item()

    bars = {torch.float32: (5e-5, 1e-4), torch.bfloat16: (3e-2, 0.0)}
    for dtype, (atol, rtol) in bars.items():
        for i, (b, hq, hkv, s, d, kw) in enumerate(ATTN_TEST_SHAPES):
            q, k, v = attn_inputs(b, hq, hkv, s, d, dtype, 100 + i)
            compare("test shape", q, k, v, kw, atol, rtol)
    # the projections' (B, S, H, d) memory seen as (B, H, S, d), and q,
    # k, v sliced at column 1 of 68-wide rows
    gen = torch.Generator(device="cuda").manual_seed(5)
    views = {}
    for dtype in (torch.float32, torch.bfloat16):
        views[f"{dtype} strided views"] = [
            torch.randn((2, 100, h, 64), generator=gen, device="cuda")
            .to(dtype).transpose(1, 2) for h in (4, 2, 2)]
    for dtype in (torch.float32, torch.bfloat16):
        views[f"{dtype} misaligned strided views"] = [
            torch.randn((2, 100, h, 68), generator=gen, device="cuda")
            .to(dtype)[..., 1:65].transpose(1, 2) for h in (4, 2, 2)]
    kw = {"scale": 0.125, "window": 30, "impl": "kernel"}
    for label, (q, k, v) in views.items():
        compare(label, q, k, v, {"window": 30}, *bars[q.dtype])
        same = torch.equal(multi_head_attention(q, k, v, **kw),
                           multi_head_attention(q.contiguous(),
                                                k.contiguous(),
                                                v.contiguous(), **kw))
        log(f"attention {label} ({route(q, k, v)}) == contiguous copies "
            f"({route(q.contiguous(), k.contiguous(), v.contiguous())}): "
            f"bitwise {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"attention kernel: {label} differ from "
                                 "contiguous copies")
    errs = {}
    for b, h, s, d, dt in ATTN_SLICE_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = attn_inputs(b, h, h, s, d, dtype, s + d)
        atol, rtol = (5e-5, 1e-4) if dt == "float32" else (3e-2, 0.0)
        errs[(b, h, s, d, dt)] = compare("slice shape", q, k, v, {}, atol,
                                         rtol)
    return errs


def time_attention(errs: dict) -> list:
    """Kernel (bare launch and wrapper call), plain version and the SDPA
    library call at the slice's shapes, in one call, beside the bound and
    with the kernel's achieved TFLOP/s (the bound's operation count over
    its time). The kernels K2 had before its redesigns (the CUDA-core
    bf16 kernel, the earlier f32 kernel) are not re-run: PERF.md quotes
    their times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ops import multi_head_attention

    rows = []
    for b, h, s, d, dt in ATTN_SLICE_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = attn_inputs(b, h, h, s, d, dtype, 7)
        scale = d ** -0.5
        out = torch.empty_like(q)
        reps = 20 if s > 512 else 200
        ker = cuda_ms(lambda: kernel.launch(q, k, v, out, scale=scale,
                                            causal=True, window=None,
                                            softcap=None), reps)
        wrapped = cuda_ms(lambda: multi_head_attention(
            q, k, v, scale=scale, impl="kernel"), reps)
        plain = cuda_ms(lambda: multi_head_attention(
            q, k, v, scale=scale, impl="ref"), reps)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), reps)
        bound, bound_by = attention_bound(b, h, s, d, dt)
        tflops = 4.0 * b * h * d * (s * (s + 1) // 2) / (ker * 1e-3) / 1e12
        rows.append({"shape": [b, h, s, d], "dtype": dt, "ms": ker,
                     "wrapper_ms": wrapped, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": bound,
                     "bound_by": bound_by, "tflops": tflops,
                     "max_abs_err": errs[(b, h, s, d, dt)]})
        log(f"attention timing B={b} H={h} S={s} d={d} {dt}: kernel "
            f"{ker:.6f} ms (wrapper call {wrapped:.6f} ms), plain "
            f"{plain:.6f} ms, SDPA {lib:.6f} ms, bound {bound:.6f} ms "
            f"({bound_by}), kernel at {bound / ker:.1%} of bound, "
            f"{tflops:.1f} TFLOP/s, {ker / lib:.2f}x SDPA")
    return rows


def wkv_bound(b, h, t, d, dtype_name) -> tuple:
    """(least ms, what bounds it) for one WKV6 call: r, k, v, w read once
    and o written once (model dtype), u read once, the f32 state read
    once and written once, against 5 flops (the k v product, an FMA into
    o, an FMA for the decay) for each (t, i, j) and 5 for each (t, i) (the
    bonus dot product sum_i r_i u_i k_i, then one FMA into each o_j), at
    the f32 rate outside the tensor cores (the recurrence has no matrix
    product for them)."""
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = elt * 5 * b * h * t * d + 4 * h * d + 4 * 2 * b * h * d * d
    flops = 5.0 * b * h * t * d * (d + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wkv_inputs(b, h, t, d, dtype, seed, layout="bhtd"):
    """r, k, v, w in `dtype` (w = exp(-exp(N(0, 1))) in (0, 1)), as
    (B, H, T, D) tensors or, for layout 'bthd', as (B, H, T, D) views of
    (B, T, H, D) memory (the model's projections); u and s0 f32."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, h, t, d) if layout == "bhtd" else (b, t, h, d)
    r, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(shape, generator=gen,
                                         device="cuda")))
    rkvw = [x.to(dtype) for x in (r, k, v, w)]
    if layout == "bthd":
        rkvw = [x.transpose(1, 2) for x in rkvw]
    u = 0.5 * torch.randn((h, d), generator=gen, device="cuda")
    s0 = 0.1 * torch.randn((b, h, d, d), generator=gen, device="cuda")
    return (*rkvw, u, s0)


def check_wkv_vs_plain() -> dict:
    """The WKV kernel against its plain version on the card: at the
    reference tests' shapes in f32 (o and state atol 1e-4 + rtol 1e-4),
    at rwkv6-7b's prefill and decode shapes in bf16 with f32 state
    (WKV_BF16_O_BAR, WKV_STATE_BAR), as the model hands them over
    ((B, T, H, D) views), and at the lengths WKV_RAGGED_T off the
    kernel's chunk (f32 at every head_dim, bf16 at the model's widths).
    Also: two halves chained through the state equal one pass, the state
    written over s0 equals the state written to a new buffer, and strided
    views equal contiguous copies, bit for bit, both views the kernel
    stages by 16-byte copies and views off 16 bytes, which it stages by
    element copies. Returns the max abs error of o per slice shape."""
    import torch

    from repro_torch.kernels.wkv import kernel
    from repro_torch.kernels.wkv.ops import wkv6

    def compare(label, args, o_bar, s_bar):
        ker_o, ker_s = wkv6(*args, impl="kernel")
        ref_o, ref_s = wkv6(*args, impl="ref")
        torch.cuda.synchronize()
        errs = []
        ok = True
        for ker, ref, (atol, rtol) in ((ker_o.float(), ref_o.float(), o_bar),
                                       (ker_s, ref_s, s_bar)):
            err = (ker - ref).abs()
            ok = ok and bool(torch.all(torch.isfinite(ker))) and bool(
                torch.all(err <= atol + rtol * ref.abs()))
            errs.append(err.max().item())
        log(f"wkv kernel-vs-plain {label} r{tuple(args[0].shape)} "
            f"{args[0].dtype}: max_abs_err o={errs[0]:.3e} (atol {o_bar[0]} "
            f"rtol {o_bar[1]}), state={errs[1]:.3e} (atol {s_bar[0]} rtol "
            f"{s_bar[1]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"WKV kernel disagrees with its plain "
                                 f"version at {label}")
        return errs[0]

    for i, (b, h, t, d) in enumerate(WKV_TEST_SHAPES):
        compare("test shape", wkv_inputs(b, h, t, d, torch.float32, 200 + i),
                (1e-4, 1e-4), (1e-4, 1e-4))
    for t in WKV_RAGGED_T:
        for i, d in enumerate(kernel.HEAD_DIMS):
            compare("ragged length", wkv_inputs(2, 4, t, d, torch.float32,
                                                500 + t + i),
                    (1e-4, 1e-4), (1e-4, 1e-4))
        compare("ragged length", wkv_inputs(4, 64, t, 64, torch.bfloat16,
                                            600 + t, layout="bthd"),
                WKV_BF16_O_BAR, WKV_STATE_BAR)
    errs = {}
    for b, h, t, d in WKV_SLICE_SHAPES:
        args = wkv_inputs(b, h, t, d, torch.bfloat16, 300 + t,
                          layout="bthd")
        errs[(b, h, t, d)] = compare("slice shape", args, WKV_BF16_O_BAR,
                                     WKV_STATE_BAR)
    # bit-for-bit properties at the prefill shape, strided bf16 inputs
    b, h, t, d = WKV_SLICE_SHAPES[0]
    r, k, v, w, u, s0 = wkv_inputs(b, h, t, d, torch.bfloat16, 400,
                                   layout="bthd")
    o, s = wkv6(r, k, v, w, u, s0, impl="kernel")
    half = t // 2
    o1, s1 = wkv6(r[:, :, :half], k[:, :, :half], v[:, :, :half],
                  w[:, :, :half], u, s0, impl="kernel")
    o2, s2 = wkv6(r[:, :, half:], k[:, :, half:], v[:, :, half:],
                  w[:, :, half:], u, s1, impl="kernel")
    state = s0.clone()
    o_in, s_in = wkv6(r, k, v, w, u, state, impl="kernel", s_out=state)
    o_dense, s_dense = wkv6(*(x.contiguous() for x in (r, k, v, w)), u, s0,
                            impl="kernel")
    torch.cuda.synchronize()
    at = f"at {(b, h, t, d)} bf16"
    checks = {
        f"two halves chained == one pass {at}":
            torch.equal(torch.cat([o1, o2], dim=2), o) and torch.equal(s2, s),
        f"state in place == out of place {at}":
            s_in is state and torch.equal(o_in, o) and torch.equal(s_in, s),
        f"strided views == contiguous copies {at}":
            torch.equal(o_dense, o) and torch.equal(s_dense, s)
            and kernel.copy_bytes(r, k, v, w) == 16,
    }
    # (B, T, H, D) memory one element past a 16-byte boundary: staged by
    # element copies, it must give the bits of 16-byte-staged copies
    for dtype in (torch.float32, torch.bfloat16):
        shape = (2, 8, 100, 64)
        n = math.prod(shape)
        args = wkv_inputs(*shape, dtype, 700)
        views = []
        for x in args[:4]:
            buf = torch.empty(n + 1, dtype=dtype, device="cuda")
            views.append(buf[1:].view(2, 100, 8, 64).transpose(1, 2))
            views[-1].copy_(x)
        o_off, s_off = wkv6(*views, *args[4:], impl="kernel")
        o_cont, s_cont = wkv6(*args, impl="kernel")
        torch.cuda.synchronize()
        checks[f"views off 16 bytes == contiguous copies at {shape} "
               f"{str(dtype)[6:]}"] = (
            kernel.copy_bytes(*views) == views[0].element_size()
            and kernel.copy_bytes(*args[:4]) == 16
            and torch.equal(o_off, o_cont) and torch.equal(s_off, s_cont))
    for name, ok in checks.items():
        log(f"wkv {name}: bitwise {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"WKV kernel: {name} failed")
    return errs


def time_wkv(errs: dict) -> list:
    """Kernel (bare launch and wrapper call) and plain version at
    rwkv6-7b's prefill and decode shapes, beside the bound. No single
    PyTorch call computes WKV6: no library time."""
    import torch

    from repro_torch.kernels.wkv import kernel
    from repro_torch.kernels.wkv.ops import wkv6

    rows = []
    for b, h, t, d in WKV_SLICE_SHAPES:
        r, k, v, w, u, s0 = wkv_inputs(b, h, t, d, torch.bfloat16, 7,
                                       layout="bthd")
        o = torch.empty((b, t, h, d), dtype=torch.bfloat16,
                        device="cuda").transpose(1, 2)
        s_out = torch.empty_like(s0)
        reps = 20 if t > 1 else 500
        ker = cuda_ms(lambda: kernel.launch(r, k, v, w, u, s0, s_out, o),
                      reps)
        wrapped = cuda_ms(lambda: wkv6(r, k, v, w, u, s0, impl="kernel"),
                          reps)
        plain = cuda_ms(lambda: wkv6(r, k, v, w, u, s0, impl="ref"),
                        2 if t > 1 else 50, warmup=1)
        bound, bound_by = wkv_bound(b, h, t, d, "bfloat16")
        rows.append({"shape": [b, h, t, d], "dtype": "bfloat16", "ms": ker,
                     "wrapper_ms": wrapped, "plain_ms": plain,
                     "library_ms": None, "bound_ms": bound,
                     "bound_by": bound_by,
                     "max_abs_err": errs[(b, h, t, d)]})
        log(f"wkv timing B={b} H={h} T={t} D={d} bfloat16: kernel "
            f"{ker:.6f} ms (wrapper call {wrapped:.6f} ms), plain "
            f"{plain:.6f} ms, no library call, bound {bound:.6f} ms "
            f"({bound_by}), kernel at {bound / ker:.1%} of bound")
    return rows


def build_rwkv() -> tuple:
    """rwkv6-7b at full width and depth with seeded random weights on the
    card, and the peak device memory of their initialization (each leaf
    is drawn in f32 before its cast to bf16)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, params = _serve_model("rwkv6-7b")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"rwkv6-7b weights: {n_params / 1e9:.4f} B parameters, "
        f"{weights / 2**30:.3f} GiB on the card; initialization took "
        f"{wall:.2f} s with a peak of {peak / 2**30:.3f} GiB")
    return model, params, {"params": n_params, "weights_bytes": weights,
                           "init_peak_bytes": peak, "init_s": wall}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _serve_model(arch: str, params=None, impl: str = "auto"):
    """(model, params) at full width and depth; weights from a generator
    seeded 0 on the card unless `params` is given. `impl` picks the
    route of the model's kernel."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model

    model = build_model(get_config(arch), impl)
    return model, params if params is not None else model.init_params(
        device="cuda")


def _prompt(vocab: int, s: int, seed: int = 1):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, (SERVE_BATCH, s), generator=gen,
                         device="cuda")


def _rel_to_max(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def run_serve_main_path(ops, model, params, *, kernel: str,
                        per_generate: int) -> dict:
    """`model` served by `Engine.generate` at each prompt length, after
    one untimed warm-up run: the kernel's launch count (`ops`) is set to 0
    before and read after the timed run and must be `per_generate`, and
    the tokens are checked to lie in the vocabulary. A further run under
    torch.profiler counts launches, syncs, copies and device busy time
    (idle share against the timed run's wall)."""
    import torch

    from repro_torch.serving.engine import Engine, ServeConfig

    cfg = model.cfg
    eng = Engine(model, params, ServeConfig(max_new_tokens=SERVE_NEW_TOKENS))
    out = {}
    for s in SERVE_PROMPTS:
        tokens = _prompt(cfg.vocab_size, s)
        # warm-up at this prompt length (cuBLAS plans, allocator growth),
        # so the timed run below is the steady state
        eng.generate({"tokens": tokens})
        torch.cuda.synchronize()
        ops.launch_count = 0
        t0 = time.perf_counter()
        gen = eng.generate({"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_count
        ok_vocab = bool(((gen >= 0) & (gen < cfg.vocab_size)).all())
        log(f"serve {cfg.arch_id} (full: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.dtype}) B={SERVE_BATCH} prompt={s} "
            f"new={SERVE_NEW_TOKENS}: wall {wall:.4f} s, "
            f"{SERVE_BATCH * SERVE_NEW_TOKENS / wall:.1f} tok/s, "
            f"{launches} {kernel} kernel launches, tokens in vocabulary: "
            f"{ok_vocab}; first row {gen[0, :8].tolist()}")
        if launches != per_generate:
            raise AssertionError(f"expected {per_generate} {kernel} kernel "
                                 f"launches per generate, got {launches}")
        if gen.shape != (SERVE_BATCH, SERVE_NEW_TOKENS) or not ok_vocab:
            raise AssertionError("generated ids out of shape or vocabulary")
        prof = _profile_counts(lambda: eng.generate({"tokens": tokens}),
                               kernel=kernel)
        busy = prof["device_us"] / 1e6
        out[s] = {"wall_s": wall, "launches": launches,
                  "tok_per_s": SERVE_BATCH * SERVE_NEW_TOKENS / wall,
                  "generate_profile": {
                      "launches": prof["launches"], "syncs": prof["syncs"],
                      "memcpy": prof["memcpy"], "device_busy_s": busy,
                      "device_idle_share": 1.0 - busy / wall}}
        log(f"serve {cfg.arch_id} prompt={s} generate profile: "
            f"{json.dumps(out[s]['generate_profile'])}")
    return out


def check_serve_routes(model, params) -> dict:
    """olmo-1b in bf16 at each prompt length: prefill logits finite and
    within the bar between the kernel route and the plain route, and
    prefill(S) + one decode step against prefill(S + 1)."""
    import torch

    cfg = model.cfg
    plain, _ = _serve_model(cfg.arch_id, params, impl="ref")
    out = {}
    for s in SERVE_PROMPTS:
        tokens = _prompt(cfg.vocab_size, s + 1, seed=2)
        ker_logits, cache = model.prefill(params, {"tokens": tokens[:, :s]},
                                          s + 1)
        ref_logits, _ = plain.prefill(params, {"tokens": tokens[:, :s]},
                                      s + 1)
        finite = bool(torch.isfinite(ker_logits).all())
        routes = _rel_to_max(ker_logits, ref_logits)
        inc, _ = model.decode_step(params, cache, tokens[:, s], s)
        full, _ = model.prefill(params, {"tokens": tokens}, s + 1)
        decode = _rel_to_max(inc, full)
        agree = (ker_logits.argmax(-1) == ref_logits.argmax(-1)).sum().item()
        log(f"serve {cfg.arch_id} prompt={s}: logits finite {finite}, "
            f"max |logit| {ref_logits.abs().max().item():.4f}; kernel vs "
            f"plain route max|diff|/max|logit| {routes:.3e} (bar "
            f"{BF16_LOGIT_BAR}), argmax agree {agree}/{SERVE_BATCH}; "
            f"prefill({s})+decode vs prefill({s + 1}) {decode:.3e} (bar "
            f"{BF16_LOGIT_BAR})")
        if not (finite and routes <= BF16_LOGIT_BAR
                and decode <= BF16_LOGIT_BAR):
            raise AssertionError(f"serve {cfg.arch_id} prompt={s}: route "
                                 "or decode consistency check failed")
        out[s] = {"routes_rel": routes, "decode_rel": decode}
    return out


def check_rwkv_routes(model, params) -> dict:
    """rwkv6-7b at full width and depth, on the served bf16 weights.

    In f32 (the same weights upcast; TF32 off), where rounding cannot
    hide a fault: at the first prompt the kernel route against the plain
    route (`impl="ref"`), logits and WKV state, within
    RWKV_F32_ROUTE_BAR of the largest magnitude; at each prompt length
    prefill(S) + one decode step against prefill(S + 1) within
    RWKV_F32_DECODE_BAR, through the kernel route and, at the first
    prompt, through the plain route too (the same amplified rounding
    whichever route runs the recurrence).

    In bf16, the served model: logits finite, and each route held to the
    f32 model rather than to the other route. Through 32 recurrent layers
    a one-ulp flip in one route grows into logit differences of several
    per cent (9 % of the largest logit on an H100), so the two bf16
    routes are not held to each other; the kernel route must instead lie
    no further than RWKV_BF16_RATIO times as far from the f32 logits as
    the plain route does, and prefill(S) + decode no further than that
    from the f32 prefill(S + 1) than the bf16 prefill(S + 1) does."""
    import torch

    from repro_torch.models.model import build_model

    cfg = model.cfg
    cfg32 = cfg.with_(dtype="float32")
    params32 = _tree_map(lambda x: x.float(), params)
    f32 = {impl: build_model(cfg32, impl) for impl in ("auto", "ref")}
    plain = build_model(cfg, impl="ref")
    out = {}
    for i, s in enumerate(SERVE_PROMPTS):
        tokens = _prompt(cfg.vocab_size, s + 1, seed=2)
        head, nxt = {"tokens": tokens[:, :s]}, tokens[:, s]
        row = {}
        f_logits, f_state = f32["auto"].prefill(params32, head)
        if i == 0:
            p_logits, p_state = f32["ref"].prefill(params32, head)
            row["f32_routes_rel"] = _rel_to_max(f_logits, p_logits)
            row["f32_routes_state_rel"] = _rel_to_max(f_state["wkv"],
                                                      p_state["wkv"])
        f_inc, _ = f32["auto"].decode_step(params32, f_state, nxt, s)
        f_full, _ = f32["auto"].prefill(params32, {"tokens": tokens})
        row["f32_decode_rel"] = _rel_to_max(f_inc, f_full)
        if i == 0:
            p_inc, _ = f32["ref"].decode_step(params32, p_state, nxt, s)
            p_full, _ = f32["ref"].prefill(params32, {"tokens": tokens})
            row["f32_plain_decode_rel"] = _rel_to_max(p_inc, p_full)
        ok = all(v <= (RWKV_F32_DECODE_BAR if "decode" in k
                       else RWKV_F32_ROUTE_BAR) for k, v in row.items())

        b_logits, b_state = model.prefill(params, head)
        finite = bool(torch.isfinite(b_logits).all())
        row["bf16_kernel_vs_f32"] = _rel_to_max(b_logits, f_logits)
        msg = ""
        if i == 0:
            bp_logits, _ = plain.prefill(params, head)
            row["bf16_plain_vs_f32"] = _rel_to_max(bp_logits, f_logits)
            row["bf16_routes_rel"] = _rel_to_max(b_logits, bp_logits)
            ok = ok and row["bf16_kernel_vs_f32"] <= (
                RWKV_BF16_RATIO * row["bf16_plain_vs_f32"])
            msg = (f"bf16 kernel route vs f32 {row['bf16_kernel_vs_f32']:.3e}"
                   f", plain route vs f32 {row['bf16_plain_vs_f32']:.3e} "
                   f"(bar: at most {RWKV_BF16_RATIO}x), kernel vs plain "
                   f"{row['bf16_routes_rel']:.3e}; ")
        b_inc, _ = model.decode_step(params, b_state, nxt, s)
        b_full, _ = model.prefill(params, {"tokens": tokens})
        row["bf16_decode_vs_f32"] = _rel_to_max(b_inc, f_full)
        row["bf16_prefill_vs_f32"] = _rel_to_max(b_full, f_full)
        row["bf16_decode_rel"] = _rel_to_max(b_inc, b_full)
        ok = ok and finite and row["bf16_decode_vs_f32"] <= (
            RWKV_BF16_RATIO * row["bf16_prefill_vs_f32"])
        log(f"serve {cfg.arch_id} prompt={s}: bf16 logits finite {finite}, "
            f"max |logit| {f_full.abs().max().item():.4f}; f32: "
            + ", ".join(f"{k[4:]} {v:.3e}" for k, v in row.items()
                        if k.startswith("f32_"))
            + f" (bars: routes {RWKV_F32_ROUTE_BAR}, decode "
            f"{RWKV_F32_DECODE_BAR}); {msg}bf16 prefill({s})+decode vs "
            f"f32 {row['bf16_decode_vs_f32']:.3e}, bf16 prefill({s + 1}) vs "
            f"f32 {row['bf16_prefill_vs_f32']:.3e} (bar: at most "
            f"{RWKV_BF16_RATIO}x), decode vs prefill "
            f"{row['bf16_decode_rel']:.3e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"serve {cfg.arch_id} prompt={s}: route "
                                 "or decode consistency check failed")
        out[s] = row
    del params32
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def serve_repro_100m(attn_ops) -> tuple:
    """repro-100m (f32, 14 layers) at a 2048-token prompt: greedy tokens
    through the kernel route and through the plain route are identical.
    Returns the kernel launches of the `generate` and `serve_timing` of
    its prefill and one decode step."""
    import torch

    from repro_torch.serving.engine import Engine, ServeConfig

    model, params = _serve_model("repro-100m")
    plain, _ = _serve_model("repro-100m", params, impl="ref")
    tokens = _prompt(model.cfg.vocab_size, SERVE_PROMPTS[-1], seed=3)
    scfg = ServeConfig(max_new_tokens=SERVE_NEW_TOKENS)
    attn_ops.launch_count = 0
    ker = Engine(model, params, scfg).generate({"tokens": tokens})
    torch.cuda.synchronize()
    launches = attn_ops.launch_count
    ref = Engine(plain, params, scfg).generate({"tokens": tokens})
    same = bool(torch.equal(ker, ref))
    log(f"serve repro-100m (full, f32) B={SERVE_BATCH} prompt="
        f"{SERVE_PROMPTS[-1]} new={SERVE_NEW_TOKENS}: {launches} attention "
        f"kernel launches; greedy tokens kernel route == plain route: "
        f"{same}")
    if launches != model.cfg.n_layers or not same:
        raise AssertionError("repro-100m: launches or greedy tokens differ")
    del plain
    return launches, serve_timing(model, params, "flash_attention",
                                  prompts=SERVE_PROMPTS[-1:])


def serve_timing(model, params, kernel: str,
                 prompts: tuple = SERVE_PROMPTS) -> dict:
    """Prefill ms and decode ms per step (host clock around work that ends
    in a synchronize; best of 3 after a warm-up) at each prompt length,
    and a torch.profiler count of one prefill and one decode step
    (launches, host syncs, device busy time, idle share against the
    profiler-free wall time, and the launches and device time of the
    kernels named `kernel`)."""
    import torch

    out = {}
    for s in prompts:
        tokens = _prompt(model.cfg.vocab_size, s)
        max_len = s + SERVE_NEW_TOKENS
        tok = tokens[:, -1]

        def prefill():
            return model.prefill(params, {"tokens": tokens}, max_len)

        _, cache = prefill()

        def decode():
            model.decode_step(params, cache, tok, s)

        def best(fn, reps=3):
            fn()
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return min(times) * 1e3

        pre_ms, dec_ms = best(prefill), best(decode)
        prof = {name: _profile_counts(fn, kernel=kernel)
                for name, fn in (("prefill", prefill), ("decode", decode))}
        row = {"prefill_ms": pre_ms, "decode_ms_per_step": dec_ms,
               "decode_tok_per_s": SERVE_BATCH / dec_ms * 1e3}
        for name, wall in (("prefill", pre_ms), ("decode", dec_ms)):
            p = prof[name]
            busy = p["device_us"] / 1e3
            row[name] = {"launches": p["launches"], "syncs": p["syncs"],
                         "memcpy": p["memcpy"], "device_busy_ms": busy,
                         "device_idle_share": 1.0 - busy / wall,
                         f"{kernel}_kernels": p["kernel"],
                         f"{kernel}_device_ms": p["kernel_us"] / 1e3}
        log(f"serve timing {model.cfg.arch_id} B={SERVE_BATCH} prompt={s}: "
            f"{json.dumps(row)}")
        out[s] = row
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
        prof = step_profile(_base_profile_cases())
        print(json.dumps({"profile_src": src_root, "steps": prof}),
              flush=True)
        return 0
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ota import ops
    from repro_torch.kernels.wkv import ops as wkv_ops

    t_start = time.perf_counter()

    def elapsed(phase: str) -> None:
        torch.cuda.synchronize()
        log(f"elapsed {time.perf_counter() - t_start:.1f} s after {phase}")

    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    ota_build, sass, f32_sass, wkv_build = build_kernels()
    elapsed('the build')

    # K1 and the Monte Carlo path
    errs = check_kernel_vs_plain()
    torch.cuda.synchronize()
    timings = time_kernel(errs)
    torch.cuda.synchronize()
    check_cuda_matches_cpu()
    elapsed("K1's checks and timing, the card against the CPU")
    torch.cuda.synchronize()
    check_fig3_routes()
    torch.cuda.synchronize()
    mc_launches = {"fig3": run_fig3_main_path(ops)}
    torch.cuda.synchronize()
    mc, ch, beta = large_workload()
    mc_launches["large"], large_step_s = run_large_main_path(
        ops, "LARGE", mc, [ch], [beta], LARGE["steps"], LARGE["seeds"],
        rng_plan="inscan")
    del mc
    torch.cuda.synchronize()
    mc_launches["fig4"] = run_fig4_main_path(ops)
    torch.cuda.synchronize()
    mc_launches["fig6"] = run_fig6_main_path(ops)
    torch.cuda.synchronize()
    mc_launches.update(run_ablations_main_path(ops))
    elapsed('fig3, LARGE, fig4, fig6, the ablations')
    torch.cuda.synchronize()
    mc_launches["fig5"] = run_fig5_main_path(ops)
    torch.cuda.synchronize()
    mc_launches["fig7"] = run_fig7_main_path(ops)
    torch.cuda.synchronize()
    mc_launches["fig8"] = run_fig8_main_path(ops)
    elapsed('fig5, fig7, fig8')
    torch.cuda.synchronize()
    mcs, chs, betas = large_sweep_workload()
    mc_launches["large sweep"], sweep_step_s = run_large_main_path(
        ops, f"LARGE sweep N={LARGE_SWEEP['n_grid']}", mcs, chs, betas,
        LARGE_SWEEP["steps"], LARGE_SWEEP["seeds"], rng_plan="inscan")
    del mcs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mc, ch, beta = large_mrc_workload()
    mc_launches["large mrc"], mrc_step_s = run_large_main_path(
        ops, f"LARGE MRC M={LARGE_MRC['m']}", mc, [ch], [beta],
        LARGE_MRC["steps"], LARGE_MRC["seeds"],
        route_seeds=LARGE_MRC["seeds"], route_steps=LARGE_MRC_ROUTE_STEPS,
        n_antennas=LARGE_MRC["m"], rng_plan="inscan")
    del mc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    breakdown = step_breakdown()
    elapsed('the LARGE sweep, LARGE MRC and the step breakdown')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    exec_launches, exec_record = run_exec_plans(ops)
    mc_launches.update(exec_launches)
    elapsed('the exec plans')
    torch.cuda.synchronize()
    prof = step_profile({**_base_profile_cases(),
                         **_new_path_profile_cases()})
    elapsed('the step profile')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # K2 and the serving path
    attn_errs = check_attention_vs_plain()
    attn_timings = time_attention(attn_errs)
    olmo, olmo_params = _serve_model("olmo-1b")
    served = run_serve_main_path(attn_ops, olmo, olmo_params,
                                 kernel="flash_attention",
                                 per_generate=olmo.cfg.n_layers)
    routes = check_serve_routes(olmo, olmo_params)
    serve_times = serve_timing(olmo, olmo_params, "flash_attention")
    del olmo, olmo_params
    torch.cuda.empty_cache()
    repro_launches, repro_times = serve_repro_100m(attn_ops)
    elapsed('K2 and serving olmo-1b, repro-100m')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # K3 and the RWKV6 serving path: one launch per layer in the prefill
    # and in each decode step
    wkv_errs = check_wkv_vs_plain()
    wkv_timings = time_wkv(wkv_errs)
    rwkv, rwkv_params, rwkv_init = build_rwkv()
    rwkv_served = run_serve_main_path(
        wkv_ops, rwkv, rwkv_params, kernel="wkv6",
        per_generate=rwkv.cfg.n_layers * (1 + SERVE_NEW_TOKENS))
    rwkv_routes = check_rwkv_routes(rwkv, rwkv_params)
    rwkv_times = serve_timing(rwkv, rwkv_params, "wkv6")
    elapsed('K3 and serving rwkv6-7b')
    del rwkv, rwkv_params
    torch.cuda.synchronize()

    primary = timings[0]  # the LARGE shape
    ota_entry = {
        "name": "ota_aggregate", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES,
        "launches": sum(mc_launches.values()),
        "max_abs_err": max(errs.values()), "tolerance": "atol 1e-06 + "
        "rtol 1e-05 at main-path shapes",
        "ms": primary["ms"], "kernel_ms": primary["ms"],
        "plain_ms": primary["plain_ms"], "bound_ms": primary["bound_ms"],
        "bound_by": primary["bound_by"],
        "library_ms": primary["library_ms"],
        "launches_by_run": mc_launches,
        "large_ms_per_step": large_step_s * 1e3,
        "large_sweep_ms_per_step": sweep_step_s * 1e3,
        "large_mrc_ms_per_step": mrc_step_s * 1e3,
        "step_breakdown": breakdown, "exec_plans": exec_record,
        "build": ota_build,
        "padded": next(r for r in timings if r["launch"] == "fig3 (a)"),
        "large_mrc": next(r for r in timings if r["launch"] == "large mrc"),
        "shapes": timings, "step_profile": prof,
    }
    attn_primary = attn_timings[0]  # olmo-1b prefill at 2048, bf16
    attn_f32 = next(r for r in attn_timings if r["dtype"] == "float32")
    attn_entry = {
        "name": "flash_attention", "route": "cuda", "source": ATTN_SOURCE,
        "f32_source": ATTN_F32_SOURCE, "replaces": ATTN_REPLACES,
        "sass": sass,
        "launches": sum(r["launches"] for r in served.values()),
        "max_abs_err": max(attn_errs.values()), "tolerance": "f32 atol "
        "5e-05 + rtol 1e-04, bf16 atol 3e-02 at the slice's shapes",
        "tflops": attn_primary["tflops"],
        "ms": attn_primary["ms"], "plain_ms": attn_primary["plain_ms"],
        "bound_ms": attn_primary["bound_ms"],
        "bound_by": attn_primary["bound_by"],
        "library_ms": attn_primary["library_ms"],
        "launches_by_run": {f"olmo-1b prompt {s}": r["launches"]
                            for s, r in served.items()}
        | {"repro-100m prompt 2048 (route check)": repro_launches},
        "shapes": attn_timings,
        "f32": {"source": ATTN_F32_SOURCE, "launches": repro_launches,
                "sass": f32_sass,
                **{key: attn_f32[key] for key in (
                    "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "tflops", "max_abs_err")}},
        "serve": {"olmo-1b": {str(s): {**served[s], **routes[s],
                                       **serve_times[s]}
                              for s in SERVE_PROMPTS},
                  "repro-100m": {str(s): row
                                 for s, row in repro_times.items()}},
    }
    wkv_primary = wkv_timings[0]  # rwkv6-7b prefill at 2048, bf16
    wkv_entry = {
        "name": "wkv6", "route": "cuda", "source": WKV_SOURCE,
        "replaces": WKV_REPLACES,
        "launches": sum(r["launches"] for r in rwkv_served.values()),
        "max_abs_err": max(wkv_errs.values()), "tolerance": "bf16 o atol "
        f"{WKV_BF16_O_BAR[0]} + rtol {WKV_BF16_O_BAR[1]}, f32 state atol "
        f"{WKV_STATE_BAR[0]} + rtol {WKV_STATE_BAR[1]} at the slice's "
        "shapes",
        "ms": wkv_primary["ms"], "plain_ms": wkv_primary["plain_ms"],
        "bound_ms": wkv_primary["bound_ms"],
        "bound_by": wkv_primary["bound_by"], "library_ms": None,
        "launches_by_run": {f"rwkv6-7b prompt {s}": r["launches"]
                            for s, r in rwkv_served.items()},
        "shapes": wkv_timings, "build": wkv_build,
        "serve": {"rwkv6-7b": {"init": rwkv_init} | {
            str(s): {**rwkv_served[s], **rwkv_routes[s], **rwkv_times[s]}
            for s in SERVE_PROMPTS}},
    }
    print(json.dumps({"kernels": [ota_entry, attn_entry, wkv_entry]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
