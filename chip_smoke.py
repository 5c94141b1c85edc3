#!/usr/bin/env python3
"""GPU check of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-src DIR   # step profile of DIR/src only

Builds the hand-written CUDA kernels from the checkout's sources (one
nvcc per source, all started together: K1, K2's f32 and bf16 kernels, K3
and its backward),
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
  `estimate_peak_bytes` and the server's price (plus
  `draw_scratch_bytes`), the plans held to each other bit for bit;
* seed and row placement over a (rows x mc) mesh ("placement"): LARGE
  at `ExecPlan(n_shards=4)` over four entries of one card (and over the
  distinct cards where there are two or more) and the LARGE sweep at 3
  row blocks x 2 seed blocks, each bit for bit the unplaced main-path
  call (curves kept), K1 150 times a block; LARGE in chunks of 256
  placed over 4 within the reference's bars of the unplaced chunks, its
  checkpoint refused at 2 seed blocks and that sweep started over; each
  call's wall beside the unplaced one, each block's peak memory;
* the MC sweep server ("serve mc"): the launcher's selftests on the
  card; the reference's serving mix per request, monolithic and bucketed
  (walls, K1 launches, engine calls, program shapes, each batch's layout,
  pad ratio and wall beside `predict_run_us`; demuxed curves within
  1e-6 of the per-request calls, then within 1e-5 of the plain route);
  a LARGE-shaped whale beside fig3-shaped minnows at the card's budget
  (each batch's admission price against its measured peak, the minnows
  before the whale's last quantum); the committed `cuda/1` calibration
  and a smoke calibration into a temporary file;
* the channel-transport substrate ("transport") at repro-100m's full
  width (112,248,960 parameters, N = 8 nodes, the reference launcher's
  channel): every registered algorithm through `transport.aggregate`
  untiled, tiled at 2^20 columns and as one concatenated block (K1 one
  launch per block for the gbma family and power_control, each block a
  strided view; the tied embedding and every other leaf past
  gridDim.y's 65,535 tiles in one launch), kernel vs plain route, bf16
  transmit, the card vs the CPU on the reduced tree, gbma's slot timed
  (wall, K1 alone against its bound, the draw alone, peak memory),
  `GBMASimulator` (300 K1 launches) and the three baselines at fig3's
  point, and `shard_map_aggregate` over NCCL at world size 1;
* serving (`Engine.generate`: prefill, then decode) through the
  flash-attention kernels: olmo-1b at full width and depth in bf16 (the
  Hopper kernel: wgmma fed by TMA) at a 32- and a 2048-token prompt, and
  repro-100m in f32 (the CUDA-core kernel) at 2048, with the
  kernel route held to the plain route, decode held to prefill, and the
  prefill and a decode step of each model timed and profiled;
* training over the MAC ("train"): K2's f32 kernel with its row
  log-sum-exp against its plain version (and its output bits unchanged
  without it), `flash_attention`'s gradients against `full_attention`'s
  autograd, the training launcher at its defaults, and repro-100m at
  full width and depth trained 2 steps on the fused gbma route and
  through the transport (gbma, receiver momentum): K2 in every forward,
  K1 in every slot, the kernel route held to the plain route, each
  step timed whole and by part with its peak memory, and the card held
  to the CPU on the reduced model; then 2 steps each on the fused gbma
  route and through the transport with rbg keys (`rng_impl="rbg"`) and
  with unsafe_rbg keys, the card's bits for the transport's full-D draw
  held to the CPU's bit for bit and the draw timed beside threefry's;
* training five models over the MAC ("train models"), each layer
  recomputed in the backward (`cfg.remat`): K2's bf16 kernel with its
  row log-sum-exp against its plain version (its output bits unchanged
  without it) and timed at olmo-1b's training shape, and with lse at
  hymba's, whisper's and pixtral's training shapes timed beside SDPA;
  the hand-written WKV backward against the plain backward and timed at
  rwkv6-7b's training shape and a transport node's; the launcher on
  olmo-1b and on whisper-small; olmo-1b and hymba-1.5b at full width
  and depth, rwkv6-7b at full width with 4 of its 32 layers,
  whisper-small at full width and depth over 1,500 f32 frames and
  pixtral-12b at full width with 4 of its 40 layers after 1,024
  patches, in bf16, 2 steps each on the fused gbma route and through the
  transport with gbma (olmo-1b and rwkv6-7b also with receiver momentum
  through the transport): K2 twice
  in every attention layer a step, K3 twice and the backward once in
  every rwkv6-7b layer, K1 in every slot, each step timed whole and by
  part with its peak memory and its model FLOPs' share of the card's
  peak; the kernel route held to the
  plain route on the first batch, and the card to the CPU on the reduced
  models;
* training over a (data x model) mesh ("mesh train", M12a): olmo-1b at
  full width and depth in bf16, 2 steps of the fused gbma route through
  `build_train_step` under `use_mesh` on a (2, 2) mesh of four entries of
  cuda:0, with `fsdp` off and on (and over the distinct cards where the
  machine has two or more, bit for bit the run over entries of cuda:0):
  K2 on each entry's heads, twice a layer a step; the final parameters
  held to the unmeshed step's by "train models"' route bar (losses, and
  each leaf's distance to the f32 model against the unmeshed step's),
  every shard its block of `unshard`; each step's wall, the card's peak
  over resident and each entry's resident bytes;
* serving over a (data x model) mesh ("mesh serve", M12b): olmo-1b at
  full width and depth in bf16 on a (2, 2) mesh of four entries of
  cuda:0 (`fsdp` off at a 32- and a 2048-token prompt, on at 32) and
  repro-100m in f32 on (1, 4) with `opt_pad_heads` off and on, B = 4,
  through `Model.prefill` and 16 `Model.decode_step`s under `use_mesh`,
  teacher-forced on the unmeshed run's greedy tokens, and olmo-1b's
  `Engine.generate` on (2, 2) (and over the distinct cards where the
  machine has two or more, bit for bit the run over entries of cuda:0):
  K2 once a layer on each entry's (or padded) heads in every prefill;
  olmo-1b's logits no farther from the f32 model's than twice the
  unmeshed run's, with the first greedy tokens equal, repro-100m's
  within atol 1e-4 + rtol 1e-4 of the unmeshed run's; every cache shard
  its block of `unshard`; each prefill and decode step timed and
  profiled beside the unmeshed run's, each entry's resident bytes and
  the card's peak over resident;
* serving rwkv6-7b through the WKV6 kernel, at full width and depth in
  bf16 at a 32- and a 2048-token prompt, with the same checks (the plain
  route at the 32-token prompt) and the weights' initialization peak;
* serving the window, softcap and qk-norm families ("serve S2"): K2's
  bf16 kernel at their shapes (head_dim 256, GQA groups of 2 and 3, the
  attention softcap, a 4,096-token window at 8,192 tokens) against its
  plain version and timed beside its bound and SDPA; gemma2-9b, gemma-7b
  and minitron-4b at full width and depth in bf16 (B = 4, 32- and
  2048-token prompts; gemma2-9b also at B = 1 over its 8,192-token
  context), with the kernel route held to the plain route, decode held
  to prefill and each prefill and decode step timed and profiled; and
  the reduced models on the card against the CPU;
* the int8 KV cache and head padding ("serve S3"): gemma-7b at full
  width and depth in bf16 with `opt_int8_cache=True` (B = 4, a
  2,048-token prompt, 32 new tokens) through `Engine.generate`; its
  prefill and decode logits held, in the same weights upcast to f32, to
  the f32 cache's at the reference's bars (0.05, 0.08), in bf16 to the
  f32 model no farther than twice the bf16 cache's, with the first
  greedy token equal; both caches' bytes, the decode step of each timed
  and profiled, and `opt_pad_heads=True` bit for bit the unpadded
  logits;
* hymba-1.5b, whisper-small and pixtral-12b ("serve S6-S7"): K2 at their
  shapes (groups of 5 at head_dim 64 under a 1,024-token window, a
  non-causal f32 encoder over 1,500 frames, groups of 4 over 3,072
  positions) against its plain version and timed beside its bound and
  the library call; each model at full width and depth in bf16 (B = 4;
  hymba at 32- and 2048-token prompts after its 128 meta tokens,
  whisper over 1,500 frames at 32 and 448, pixtral after 1,024 patches
  at 32 and 2048; 32 new tokens) through `Engine.generate`, the kernel
  route held to the plain route, decode held to prefill, each prefill
  and decode step timed and profiled, pixtral's initialization peak,
  hymba's selective scan timed; and the reduced models on the card
  against the CPU;
* MoE and MLA ("serve S4-S5"): K2 at llama4-maverick's shapes (groups
  of 5 at head_dim 128; its 8,192-token window at 16,384 tokens) against
  its plain version and timed beside its bound and the library call;
  llama4-maverick-400b-a17b (2 of its 48 layers: one local dense and one
  global MoE layer) and deepseek-v3-671b (4 of its 61: three dense and
  one MoE layer, MLA attention in plain PyTorch, its MTP head's weights)
  at full width in bf16 (B = 4 at 32- and 2048-token prompts; maverick
  also at B = 1 over 16,384) through `Engine.generate`, each prefill and
  decode step timed and profiled, the sublayers timed alone, capacity's
  dropped share of each MoE prefill's token-slots, the kernel route
  held to the plain route over the batch rows where no token's experts
  differ between them (maverick; deepseek-v3's path runs no kernel), the
  initialization peaks; and the reduced models
  on the card against the CPU, with decode after a dropless prefill
  against a longer prefill.

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
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# The training phases alternate multi-GB per-node gradient trees, noise
# draws and activations; with fixed-size segments the caching allocator
# held 35 GiB reserved but unallocated and refused an 8 GiB block in
# rwkv6-7b's transport step on an H100. Expandable segments map memory
# as it is needed (read when the allocator first runs).
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

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
# its 1,024 seeds) at these many steps; the main paths run in full (fig5,
# fig7 and fig8 halved to make room for the "train models" phase)
ABLATION_ROUTE_STEPS = 50
FIG5_ROUTE_STEPS = 75
FIG7_ROUTE_STEPS = 50
FIG8_ROUTE_STEPS = 50
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
    # a column block of a leaf whose rows lie 7e7 elements apart: a step of
    # kUnroll nodes of a node group (4 or 8 of them, 8 rows each) passes
    # 2^31 elements at N = 64, so the node offsets must be 64-bit; the
    # leaf outside the block is NaN, which a wrapped address would read
    size, lo, hi = 70_000_000, 70_000_000 - 4098, 70_000_000 - 2
    for m in (None, 8):
        full = torch.full((64, size), float("nan"), dtype=torch.bfloat16,
                          device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(64)
        full[:, lo:hi] = torch.randn((64, hi - lo), generator=gen,
                                     device="cuda").to(torch.bfloat16)
        g = full[None, :, lo:hi]
        h = torch.rand((1, 64) if m is None else (1, m, 64), generator=gen,
                       device="cuda")
        w = torch.randn(h.shape[:-1] + (hi - lo,), generator=gen,
                        device="cuda")
        out = ota_edge_aggregate(g, h, w, noise_scale=0.37, impl="kernel",
                                 out_dtype=torch.float32)
        dense = g.contiguous()
        del full
        same = torch.equal(out, ota_edge_aggregate(
            dense, h, w, noise_scale=0.37, impl="kernel",
            out_dtype=torch.float32))
        ref = ota_edge_aggregate_ref(dense, h, w, noise_scale=0.37,
                                     out_dtype=torch.float32)
        err = (out.double() - ref.double()).abs()
        ok = same and bool(torch.all(
            err <= 1e-6 + 1e-5 * ref.double().abs()))
        log(f"kernel-vs-plain row stride {size:,} (B=1, "
            f"{'' if m is None else f'M={m}, '}N=64, d={hi - lo}, bf16 "
            f"in, f32 out): == a contiguous copy {same}, max_abs_err="
            f"{err.max().item():.3e} atol=1e-06 rtol=1e-05 "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the OTA kernel misreads rows 7e7 apart")
        del dense, out, ref, err
        torch.cuda.empty_cache()
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
                        route_steps: int = None, keep_curves: bool = False,
                        **kw) -> tuple:
    """A LARGE-scale gbma call: the kernel and plain routes at
    `route_seeds` seeds a row (`route_steps` steps, all by default,
    keep_seed_curves=False), then the call at `seeds` seeds a row with
    its wall, peak device memory and launches (one per step for all
    trajectories), its curves kept when `keep_curves` (the "placement"
    phase holds its placed runs to them). Returns (launches, seconds per
    step, wall seconds, the `MCResult`)."""
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
                 keep_seed_curves=keep_curves, device="cuda", **kw)
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
    return launches, wall / steps, wall, res


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
        # the sweep server's price: the estimate plus the draw scratch of
        # LARGE's channel (Rayleigh, no phase error, one N)
        scratch = exec_mod.draw_scratch_bytes(
            n_rows=1, seeds=seeds, steps=steps, n_max=n, dim=d,
            fading="rayleigh", phase_zero=True, **est)
        price = estimate + scratch
        record[label] = {"wall_s": wall, "launches": count,
                         "chunks": chunks, "peak_bytes": peak,
                         "resident_bytes": base,
                         "estimate_bytes": estimate,
                         "scratch_bytes": scratch,
                         "peak_over_estimate": peak / estimate,
                         "price_over_peak": price / peak,
                         "price_over_own_peak": price / (peak - base)}
        launches[f"exec plans {label}"] = count
        log(f"exec plans {label}: wall {wall:.3f} s, {count} OTA kernel "
            f"launches ({chunks} chunk(s) x {steps}), peak device memory "
            f"{peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB resident "
            f"before the call), estimate_peak_bytes {estimate / 2**20:.1f} "
            f"MiB, peak / estimate {peak / estimate:.3f}; "
            f"draw_scratch_bytes {scratch / 2**20:.1f} MiB, price / peak "
            f"{price / peak:.3f}, price / (peak - resident) "
            f"{price / (peak - base):.3f}")
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


# the "placement" phase: LARGE's seeds over a mesh of 4 entries, the LARGE
# sweep's rows and seeds over (3 x 2), LARGE chunked at 256 over 4
PLACEMENT_SHARDS = 4
PLACEMENT_SWEEP_MESH = (3, 2)
PLACEMENT_CHUNK = 256


def run_placement(ops, large: tuple, sweep: tuple) -> tuple:
    """Seed and row placement (M8) on the card, every call through
    `run_mc` with K1: (a) LARGE ('inscan', curves kept) at
    `ExecPlan(n_shards=4)` over four entries of cuda:0, and over the
    distinct cards where there are two or more; (b) the LARGE sweep
    ('inscan', 3 rows) at `row_shards=3, n_shards=2` over six entries;
    (c) LARGE in chunks of 256, reduced ('hoisted'), unplaced and at
    `n_shards=4` with a `resume_dir`, whose checkpoint a resume at
    `n_shards=2` must refuse (the reference's fingerprint error; nothing
    runs), after which the 2-shard sweep starts over in a fresh directory
    and runs every chunk. `large` and `sweep` are the unplaced main-path
    calls (wall seconds, `MCResult` with curves). Checks (a) and (b)
    against them bit for bit (curves, energies, mean, ci95), (c)'s means
    within rtol 1e-6 and ci95 within rtol 1e-5 + atol 1e-9 of the
    unplaced chunked run (the reference's placement bars), and K1's
    launches: 150 a block. Prints each call's wall beside the unplaced
    wall and each block's peak device memory (the allocator's, read as
    the block issues), with the card's name and power limit. Returns (K1's
    launches per call, the record)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.mc import exec as exec_mod
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.core.mc.plan import ExecPlan

    t_phase = time.perf_counter()
    smi = smi_line()
    steps = LARGE["steps"]
    card = torch.device("cuda", 0)
    launches, record = {}, {"card": smi}
    blocks = []
    real_block = exec_mod._run_block

    def measured_block(*a, **kw):
        # the caching allocator counts on the host as the block issues:
        # no synchronize between blocks
        dev = a[1].device  # the block's betas
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = real_block(*a, **kw)
        blocks.append({"device": str(dev), "resident_mib": base / 2**20,
                       "peak_mib": torch.cuda.max_memory_allocated(dev)
                       / 2**20})
        return out

    def call(label: str, args, n_blocks: int, unplaced_s=None, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        blocks.clear()
        ops.launch_count = 0
        exec_mod._run_block = measured_block
        t0 = time.perf_counter()
        try:
            res = run_mc(*args, **kw)
            torch.cuda.synchronize()
        finally:
            exec_mod._run_block = real_block
        wall = time.perf_counter() - t0
        count = ops.launch_count
        record[label] = {"wall_s": wall, "unplaced_wall_s": unplaced_s,
                         "launches": count, "blocks": list(blocks),
                         "plan": res.plan.asdict(), "device": res.device}
        launches[f"placement {label}"] = count
        peaks = ", ".join(f"{b['peak_mib']:.1f}" for b in blocks)
        log(f"placement {label}: wall {wall:.3f} s"
            + (f" (unplaced {unplaced_s:.3f} s)" if unplaced_s else "")
            + f", {count} OTA kernel launches ({len(blocks)} blocks x "
            f"{steps} steps), each block's peak device memory {peaks} MiB; "
            f"{smi}")
        if count != n_blocks * steps or len(blocks) != n_blocks:
            raise AssertionError(
                f"placement {label}: expected {n_blocks} blocks and "
                f"{n_blocks * steps} launches, got {len(blocks)} and {count}")
        return res

    def same(label: str, a, b) -> None:
        for f in ("risks", "cum_energy", "mean", "ci95"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                bad = int(np.sum(getattr(a, f) != getattr(b, f)))
                raise AssertionError(f"placement {label}: {f} differs from "
                                     f"the unplaced call at {bad} entries")
        log(f"placement {label}: curves, energies, mean and ci95 equal the "
            "unplaced call's bit for bit")

    # (a) LARGE's seeds over four entries of one card
    large_wall, large_res = large
    mc, ch, beta = large_workload()
    args = (mc, [ch], "gbma", [beta], steps, LARGE["seeds"])
    placed = call(f"(a) LARGE, n_shards={PLACEMENT_SHARDS} on cuda:0",
                  args, PLACEMENT_SHARDS, large_wall,
                  plan=ExecPlan(rng_plan="inscan", n_shards=PLACEMENT_SHARDS),
                  device=[card] * PLACEMENT_SHARDS)
    same("(a)", placed, large_res)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        k = PLACEMENT_SHARDS if n_cards >= PLACEMENT_SHARDS else 2
        placed = call(f"(a) LARGE, n_shards={k} over {k} cards", args, k,
                      large_wall, plan=ExecPlan(rng_plan="inscan",
                                                n_shards=k), device="cuda")
        same("(a) over distinct cards", placed, large_res)
    del placed

    # (b) the LARGE sweep's rows and seeds over (3 x 2)
    sweep_wall, sweep_res = sweep
    mcs, chs, betas = large_sweep_workload()
    rows, k = PLACEMENT_SWEEP_MESH
    placed = call(f"(b) LARGE sweep, row_shards={rows}, n_shards={k}",
                  (mcs, chs, "gbma", betas, LARGE_SWEEP["steps"],
                   LARGE_SWEEP["seeds"]), rows * k, sweep_wall,
                  plan=ExecPlan(rng_plan="inscan", n_shards=k,
                                row_shards=rows), device=[card] * (rows * k))
    same("(b)", placed, sweep_res)
    del mcs, placed

    # (c) LARGE in chunks of 256, reduced, placed and resumed under
    # another mesh
    chunks = LARGE["seeds"] // PLACEMENT_CHUNK

    def chunked(n_shards: int) -> ExecPlan:
        return ExecPlan(seed_chunk=PLACEMENT_CHUNK, n_shards=n_shards,
                        keep_seed_curves=False)

    label = f"(c) LARGE chunks of {PLACEMENT_CHUNK}"
    plain = call(f"{label}, unplaced", args, chunks, plan=chunked(0),
                 device=card)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as resume_dir:
        four = call(f"{label}, n_shards={PLACEMENT_SHARDS}",
                    args, chunks * PLACEMENT_SHARDS,
                    record[f"{label}, unplaced"]["wall_s"],
                    plan=chunked(PLACEMENT_SHARDS),
                    device=[card] * PLACEMENT_SHARDS, resume_dir=resume_dir)
        ops.launch_count = 0
        try:
            run_mc(*args, plan=chunked(2), device=[card] * 2,
                   resume_dir=resume_dir)
        except ValueError as err:
            if "fingerprint" not in str(err) or ops.launch_count:
                raise
            log(f"placement (c): the 4-shard checkpoint refused at "
                f"n_shards=2, {ops.launch_count} launches: {err}")
        else:
            raise AssertionError("placement (c): a resume under another "
                                 "mesh took the 4-shard checkpoint")
        with tempfile.TemporaryDirectory(dir=build) as fresh:
            two = call(f"{label}, n_shards=2, started over",
                       args, chunks * 2,
                       record[f"{label}, unplaced"]["wall_s"],
                       plan=chunked(2), device=[card] * 2, resume_dir=fresh)
    for label, res in (("n_shards=4", four), ("n_shards=2", two)):
        rel = float(np.max(np.abs(res.mean - plain.mean)
                           / np.abs(plain.mean)))
        ci_ok = bool(np.all(np.abs(res.ci95 - plain.ci95)
                            <= 1e-5 * np.abs(plain.ci95) + 1e-9))
        record[f"(c) {label} mean max rel"] = rel
        log(f"placement (c) {label}: mean vs unplaced chunks max rel "
            f"{rel:.3e} (bar 1e-06), ci95 within rtol 1e-5 + atol 1e-9: "
            f"{ci_ok}")
        if rel > 1e-6 or not ci_ok or not np.all(np.isfinite(res.mean)):
            raise AssertionError(f"placement (c) {label}: moments off the "
                                 "unplaced chunked run")
    del mc
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"placement: phase {record['phase_s']:.1f} s; {json.dumps(record)}")
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
        # 10 and 40 steps, once each (cut from 10 and 60, then from two
        # runs of each, to keep the script inside its 1,200 s time limit)
        for steps in (10, 40):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(steps)
            walls.setdefault(steps, []).append(time.perf_counter() - t0)
        # short profiled runs: the profiler adds ~0.5 ms a launch, and a
        # step's launch count is the same at any length (1 and 2 steps)
        lo, hi = (_profile_counts(lambda s=s: run(s)) for s in (1, 2))
        per = {k: hi[k] - lo[k] for k in lo}
        wall_ms = (min(walls[40]) - min(walls[10])) / 30 * 1e3
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


# ------------------------------------------------------------- serve mc
# the reference's serving mix (`benchmarks/bench_montecarlo.py:61-75,
# 108-116, 585-660`): MSD problems at these node counts (two N-buckets,
# {96, 100, 120} -> 128 and {384, 400} -> 512), 300 steps, 4 seeds,
# Rayleigh at E_N = N^-1.5 and noise 1, the Theorem-1 stepsize at 0.9;
# served per request, monolithically and bucketed after 5 passes
SERVE_MC_N_GRID = (96, 100, 120, 384, 400)
SERVE_MC_STEPS = 300
SERVE_MC_SEEDS = 4
SERVE_MC_PASSES = 5
# the whale and its minnows: a LARGE-shaped request beside fig3-shaped
# ones (fig3 part (a)'s three rows and part (b)'s first), quanta of 64
WHALE_QUANTUM = 64


def _recording_server(ops, cfg):
    """A sweep server on the card (inline executor) that records each
    engine call: its job, seed offset, wall (host clock; the call ends in
    the host copy of its curves), K1 launches, its own peak device memory
    (`max_memory_allocated` over the call, less what was allocated when
    it started) and how many batches had finished before it; and each
    finished job, in the order of `stats.batches`."""
    import torch

    from repro_torch.serving.mc_server import InlineExecutor, McSweepServer

    class RecordingServer(McSweepServer):
        def __init__(self):
            super().__init__(cfg, executor=InlineExecutor(), device="cuda")
            self.calls, self.finished = [], []

        def _engine_call(self, job, off, q):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            k0 = ops.launch_count
            t0 = time.perf_counter()
            out = super()._engine_call(job, off, q)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            top = torch.cuda.max_memory_allocated()
            self.calls.append({
                "job": job, "off": off, "wall_s": wall,
                "launches": ops.launch_count - k0,
                "max_memory_allocated": top, "peak_bytes": top - base,
                "resident_bytes": base,
                "finished_before": len(self.finished)})
            return out

        def _finish(self, job):
            super()._finish(job)
            self.finished.append(job)

    return RecordingServer()


def _serve_mc_mix():
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.theory import stepsize_theorem1
    from repro_torch.figures import MSDProblem
    from repro_torch.serving.mc_server import SweepRequest

    probs = [MSDProblem.make(n) for n in SERVE_MC_N_GRID]
    chs = [ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                         energy=float(n) ** (-1.5)) for n in SERVE_MC_N_GRID]
    betas = [stepsize_theorem1(p.pc, ch, n, safety=0.9)
             for p, ch, n in zip(probs, chs, SERVE_MC_N_GRID)]
    return [SweepRequest(problem=p.to_mc("cuda"), channels=[ch],
                         algo="gbma", betas=[b], steps=SERVE_MC_STEPS,
                         seeds=SERVE_MC_SEEDS)
            for p, ch, b in zip(probs, chs, betas)]


def _solo_mc(req, **kw):
    """A request as one dedicated `run_mc` call on the server's row path."""
    from repro_torch.core.mc.engine import run_mc
    from repro_torch.core.mc.problems import MCProblemBatch

    return run_mc(MCProblemBatch.stack([req.problem]), req.channels,
                  req.algo, req.betas, req.steps, req.seeds,
                  seed0=req.seed0, shard_seeds=False, device="cuda", **kw)


def _max_rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def run_serve_mc(ops) -> tuple:
    """The sweep server (`serving.mc_server`) on the card:

    (a) the launcher's `--selftest` and `--selftest --chaos`;
    (b) the reference's serving mix served per request (one `run_mc`
        each), monolithically (`bucket_base=0`) and bucketed on a
        persistent server after 5 passes: each serving's wall, K1
        launches, engine calls, `trace_count()`, and each batch's layout,
        pad_flops_ratio and measured wall beside `predict_run_us`; every
        demuxed curve within 1e-6 rel of its per-request call and K1 at
        300 launches an engine call (each batch one quantum);
    (c) a whale (LARGE-shaped) and four fig3-shaped minnows at quanta of
        64 and the card's budget: each batch's admission price
        (`estimate_peak_bytes` + `draw_scratch_bytes`) against its
        measured peak (each quantum's own, over what was allocated when
        it started), failing if a peak exceeds its price; the minnows
        resolve before the whale's last quantum;
    (d) (b)'s bucketed results against the requests through the plain
        route (`ota_impl="ref"`) on the card, within 1e-5 rel;
    (e) the committed `cuda/1` calibration entry loads as 'measured', and
        a `CalibrationConfig.smoke()` run into a temporary file gives
        finite, non-negative coefficients.

    Returns (K1 launches of the main-path servings, the record)."""
    import asyncio
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.mc import costmodel
    from repro_torch.core.mc import exec as exec_mod
    from repro_torch.core.mc.plan import (ExecPlan,
                                          device_memory_budget_bytes)
    from repro_torch.core.theory import stepsize_theorem1
    from repro_torch.figures import FIG3, MSDProblem
    from repro_torch.launch import serve_mc
    from repro_torch.serving.mc_server import (McServeConfig, PartialResult,
                                               SweepRequest, serve_sync)

    record, launches = {}, {}
    t_phase = time.perf_counter()

    # (a) the launcher's selftests, in-process on the card
    for argv in (["--selftest", "--device", "cuda"],
                 ["--selftest", "--chaos", "--device", "cuda"]):
        try:
            serve_mc.main(argv)
            code = 0
        except SystemExit as e:
            code = e.code
        log(f"serve mc (a): serve_mc {' '.join(argv)} on the card: exit "
            f"{code}")
        if code != 0:
            raise AssertionError(f"serve mc (a): {argv} exited {code}")

    # (b) the serving mix
    reqs = _serve_mc_mix()
    k = len(reqs)
    bucketed = _recording_server(ops, McServeConfig(
        quantum_seeds=SERVE_MC_SEEDS))
    mono = _recording_server(ops, McServeConfig(
        quantum_seeds=SERVE_MC_SEEDS, bucket_base=0))
    model = bucketed.cost_model()
    log(f"serve mc (b): routing cost model source={model.source}, "
        f"dispatch_us={model.dispatch_us}, compile_s={model.compile_s}")
    for _ in range(SERVE_MC_PASSES):  # convergence: first sight, layouts
        serve_sync(reqs, server=bucketed)
    per_req = [_solo_mc(r) for r in reqs]  # warm the solo shapes too
    serve_sync(reqs, server=mono)

    def serving(label, run, server=None):
        torch.cuda.synchronize()
        n0 = len(server.calls) if server else 0
        b0 = len(server.stats.batches) if server else 0
        exec_mod.trace_count(reset=True)
        ops.launch_count = 0
        t0 = time.perf_counter()
        results = run()
        wall = time.perf_counter() - t0
        count = ops.launch_count
        shapes = exec_mod.trace_count()
        calls = server.calls[n0:] if server else [{"wall_s": None}] * k
        batches = server.stats.batches[b0:] if server else []
        rows = []
        for b, c in zip(batches, calls):
            wl = costmodel.Workload(
                n_rows=b["rows"], seeds=b["seeds"], steps=SERVE_MC_STEPS,
                n_max=b["n_max"], dim=reqs[0].problem.dim)
            plan = ExecPlan(seed_chunk=min(SERVE_MC_SEEDS, b["seeds"]),
                            n_shards=0, row_shards=1)
            rows.append({**{key: b[key] for key in (
                "requests", "rows", "n_max", "bucket", "layout",
                "pad_flops_ratio")}, "wall_s": c["wall_s"],
                "predict_run_s": model.predict_run_us(
                    plan, wl, device_count=1) / 1e6})
        n_calls = len(calls)
        rec = {"wall_s": wall, "launches": count, "engine_calls": n_calls,
               "trace_count": shapes, "batches": rows}
        log(f"serve mc (b) {label}: wall {wall:.4f} s, {count} OTA kernel "
            f"launches, {n_calls} engine calls, trace_count {shapes}")
        for r in rows:
            log(f"serve mc (b) {label} batch: {json.dumps(r)}")
        if count != SERVE_MC_STEPS * n_calls:
            raise AssertionError(f"serve mc (b) {label}: {count} launches "
                                 f"for {n_calls} engine calls")
        launches[f"serve mc (b) {label}"] = count
        record[f"(b) {label}"] = rec
        return results

    per_req = serving("per request", lambda: [_solo_mc(r) for r in reqs])
    mono_res = serving("monolithic", lambda: serve_sync(reqs, server=mono),
                       mono)
    buck_res = serving("bucketed", lambda: serve_sync(
        reqs, server=bucketed), bucketed)
    for label, res in (("monolithic", mono_res), ("bucketed", buck_res)):
        rel = max(max(_max_rel(r.risks, s.risks), _max_rel(r.mean, s.mean))
                  for r, s in zip(res, per_req))
        log(f"serve mc (b) {label} vs per request: max rel {rel:.3e} "
            "(bar 1e-06)")
        if not rel <= 1e-6:
            raise AssertionError(f"serve mc (b): {label} demux off the "
                                 "per-request calls")
        record[f"(b) {label}"]["max_rel_vs_per_request"] = rel
    record["(b) layouts"] = bucketed.stats.layouts
    record["(b) bucket_occupancy"] = {
        str(b): n for b, n in bucketed.stats.bucket_occupancy.items()}

    # (d) the bucketed results against the plain route on the card
    plain = [_solo_mc(r, ota_impl="ref") for r in reqs]
    rel = max(max(_max_rel(r.risks, p.risks), _max_rel(r.mean, p.mean),
                  _max_rel(r.cum_energy, p.cum_energy))
              for r, p in zip(buck_res, plain))
    log(f"serve mc (d): bucketed (kernel route) vs plain route on the "
        f"card: max rel {rel:.3e} (bar 1e-05)")
    if not rel <= 1e-5:
        raise AssertionError("serve mc (d): kernel and plain routes differ")
    record["(d) max_rel_vs_plain"] = rel

    # (c) a whale and its minnows at the card's budget
    torch.cuda.empty_cache()
    whale_p = MSDProblem.make(LARGE["n"], dim=LARGE["dim"])
    whale = SweepRequest(
        problem=whale_p.to_mc("cuda"),
        channels=[ChannelConfig(fading="rayleigh", scale=1.0, noise_std=1.0,
                                energy=1.0 / LARGE["n"])],
        algo="gbma", betas=[0.01], steps=LARGE["steps"],
        seeds=LARGE["seeds"])
    minnows = []
    for n in FIG3["n_grid"]:
        p = MSDProblem.make(n)
        ch = ChannelConfig(fading=FIG3["fading"], scale=1.0, noise_std=1.0,
                           energy=1.0)
        minnows.append(SweepRequest(
            problem=p.to_mc("cuda"), channels=[ch], algo="gbma",
            betas=[stepsize_theorem1(p.pc, ch, n, safety=0.9)],
            steps=FIG3["steps"], seeds=FIG3["seeds"]))
    n = FIG3["n_grid"][-1]
    p = MSDProblem.make(n)
    ch = ChannelConfig(fading=FIG3["fading"], scale=1.0, noise_std=1.0,
                       energy=float(n) ** (FIG3["eps_grid"][0] - 2.0))
    minnows.append(SweepRequest(
        problem=p.to_mc("cuda"), channels=[ch], algo="gbma",
        betas=[stepsize_theorem1(p.pc, ch, n, safety=0.9)],
        steps=FIG3["steps"], seeds=FIG3["seeds"]))
    budget = device_memory_budget_bytes("cuda")
    srv = _recording_server(ops, McServeConfig(
        quantum_seeds=WHALE_QUANTUM, memory_budget_bytes=budget))
    whale_sig = srv._normalize(whale).signature

    async def drive():
        tasks = [asyncio.ensure_future(srv.submit(r))
                 for r in [whale] + minnows]
        await asyncio.sleep(0)
        await srv.drain()
        return await asyncio.gather(*tasks)

    ops.launch_count = 0
    t0 = time.perf_counter()
    results = asyncio.run(drive())
    wall = time.perf_counter() - t0
    count = ops.launch_count
    if any(isinstance(r, PartialResult) or not np.all(np.isfinite(r.mean))
           for r in results):
        raise AssertionError("serve mc (c): a request did not finish")
    rows, ok = [], True
    for b, job in zip(srv.stats.batches, srv.finished):
        calls = [c for c in srv.calls if c["job"] is job]
        peak = max(c["peak_bytes"] for c in calls)
        price = b["estimate_bytes"] + b["scratch_bytes"]
        top = max(c["max_memory_allocated"] for c in calls)
        rows.append({"signature": b["signature"], "rows": b["rows"],
                     "n_max": b["n_max"], "seeds": b["seeds"],
                     "quanta": b["quanta"],
                     "estimate_bytes": b["estimate_bytes"],
                     "scratch_bytes": b["scratch_bytes"],
                     "price_bytes": price, "peak_bytes": peak,
                     "max_memory_allocated": top,
                     "price_over_peak": price / peak,
                     "peak_over_estimate": peak / b["estimate_bytes"]})
        log(f"serve mc (c) batch {b['signature']} rows={b['rows']} "
            f"N_max={b['n_max']} seeds={b['seeds']} quanta={b['quanta']}: "
            f"price {price / 2**20:.1f} MiB (estimate "
            f"{b['estimate_bytes'] / 2**20:.1f} + scratch "
            f"{b['scratch_bytes'] / 2**20:.1f}); max_memory_allocated "
            f"{top / 2**20:.1f} MiB, of it {peak / 2**20:.1f} the "
            f"quantum's own peak over what was allocated when it started; "
            f"price / peak {price / peak:.3f}, peak / estimate "
            f"{peak / b['estimate_bytes']:.3f}")
        ok = ok and peak <= price
    whale_calls = [c for c in srv.calls
                   if c["job"].signature == whale_sig]
    minnow_jobs = [j for j in srv.finished if j.signature != whale_sig]
    early = all(srv.finished.index(j) < whale_calls[-1]["finished_before"]
                for j in minnow_jobs)
    log(f"serve mc (c): wall {wall:.3f} s, {count} OTA kernel launches, "
        f"{len(srv.calls)} engine calls ({len(whale_calls)} whale quanta "
        f"of {WHALE_QUANTUM}); budget {budget / 2**30:.2f} GiB; "
        f"{len(minnow_jobs)} minnow batch(es) resolved before the "
        f"whale's last quantum: {early}")
    if count != sum(c["launches"] for c in srv.calls) \
            or count != LARGE["steps"] * len(whale_calls) \
            + FIG3["steps"] * (len(srv.calls) - len(whale_calls)):
        raise AssertionError(f"serve mc (c): {count} launches")
    if not ok:
        raise AssertionError("serve mc (c): a batch peaked above its "
                             "admission price")
    if not early:
        raise AssertionError("serve mc (c): the whale starved its minnows")
    launches["serve mc (c)"] = count
    record["(c)"] = {"wall_s": wall, "launches": count,
                     "budget_bytes": budget, "batches": rows}

    # (e) the calibration
    committed = costmodel.load_cost_model(device="cuda")
    key = costmodel.platform_key(device="cuda")
    log(f"serve mc (e): committed calibration for {key}: "
        f"{None if committed is None else committed.source}")
    if committed is None or committed.source != "measured":
        raise AssertionError("serve mc (e): no measured cuda/1 entry in "
                             f"{costmodel.default_calibration_path()}")
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t0 = time.perf_counter()
        entry = costmodel.calibrate(costmodel.CalibrationConfig.smoke(),
                                    path=os.path.join(tmp, "cal.json"),
                                    device="cuda")
        cal_s = time.perf_counter() - t0
    values = [c[key] for c in entry["coeffs"].values()
              for key in ("c0_us", "c1_us")] + [entry["dispatch_us"],
                                                entry["compile_s"]]
    log(f"serve mc (e): smoke calibration in {cal_s:.1f} s: coeffs "
        f"{entry['coeffs']}, dispatch_us {entry['dispatch_us']}, "
        f"compile_s {entry['compile_s']}, peaks {entry['peaks']}")
    if not all(math.isfinite(v) and v >= 0 for v in values):
        raise AssertionError("serve mc (e): bad smoke calibration")
    record["(e)"] = {"committed": key,
                     "smoke_s": cal_s, "smoke_coeffs": entry["coeffs"]}
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"serve mc: {json.dumps(record)}")
    return launches, record


# ---------------------------------------------------------------- transport
# the "transport" phase (M7): the reference launcher's defaults
# (src/repro/launch/train.py:37-48): repro-100m's parameter tree, N = 8
# nodes, Rayleigh fading, sigma_w = 0.01, E_N = 1; the reference tests'
# algorithm settings (tests/test_transport.py:44-55: gamma 0.9, budget
# 2.0) with M = 4 edge antennas for the blind family
TRANSPORT_ARCH = "repro-100m"
TRANSPORT_NODES = 8
TRANSPORT_NOISE_STD = 0.01
TRANSPORT_ANTENNAS = 4
TRANSPORT_BUDGET = 2.0
TRANSPORT_BLOCK_D = 2**20
# K1's route bar (kernel against the plain route): atol + rtol * |v|
TRANSPORT_ROUTE_BAR = (1e-6, 1e-5)
# tier (i) and the baselines at fig3's operating point
TRANSPORT_SIM = {"n": 500, "dim": 90, "steps": 300}


def transport_cfg(algo: str, **kw):
    """The phase's TransportConfig for `algo` (module constants above)."""
    from repro_torch.core import transport
    from repro_torch.core.channel import ChannelConfig

    spec = transport.resolve(algo)
    extra = {"n_antennas": TRANSPORT_ANTENNAS} if spec.blind else {}
    if spec.error_feedback:
        extra["power_budget"] = TRANSPORT_BUDGET
    return transport.TransportConfig(
        n_nodes=TRANSPORT_NODES, channel=ChannelConfig(
            fading="rayleigh", noise_std=TRANSPORT_NOISE_STD, energy=1.0),
        gamma=0.9, **extra, **kw)


def transport_tree(arch_cfg, device: str, seed: int = 0) -> tuple:
    """(the model's parameter tree, per-node gradients (N, *leaf.shape)
    from a generator seeded `seed` on `device`): there are no real
    gradients before the training substrate (T1-T3)."""
    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.models.model import build_model

    params = build_model(arch_cfg).init_params(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    grads = tree_map(lambda p: torch.randn(
        (TRANSPORT_NODES,) + tuple(p.shape), generator=gen, device=device),
        params)
    return params, grads


def _tree_err(out, ref, atol: float, rtol: float) -> tuple:
    """(max |out - ref| over the trees' leaves, whether every element is
    within atol + rtol·|ref|)."""
    from repro_torch.core.tree import tree_leaves

    err, ok = 0.0, True
    for o, r in zip(tree_leaves(out), tree_leaves(ref)):
        diff = (o.double() - r.double()).abs()
        err = max(err, diff.max().item())
        ok = ok and bool((diff <= atol + rtol * r.double().abs()).all())
    return err, ok


def _tree_rel_to_max(out, ref) -> float:
    """max over leaves of max |out - ref| / max |ref| (ref on any
    device)."""
    from repro_torch.core.tree import tree_leaves

    return max(((o.double().cpu() - r.double().cpu()).abs().max()
                / r.double().abs().max().clamp_min(1e-30)).item()
               for o, r in zip(tree_leaves(out), tree_leaves(ref)))


def _slot(algo, grads, params, key, cfg):
    """One `transport.aggregate` slot from a fresh state."""
    from repro_torch.core import transport

    state = transport.init_state(algo, params, cfg) \
        if transport.has_state(algo) else None
    return transport.aggregate(algo, grads, key, cfg, state)


def _peak_mib(fn):
    """(fn(), its peak device memory over what was allocated before, MiB).
    Garbage is collected first: memory freed late, inside `fn`, would
    let its peak read low."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**20


def _plain_simulator(gbma, grad_fn, ch, theta0, steps: int, key):
    """`GBMASimulator(grad_fn, ch, 1.0).run` with each slot's
    superposition on the plain route (`ota_aggregate(use_kernel=False)`):
    the same keys, the same loop."""
    import torch

    from repro_torch.core import rng

    keys = rng.split(key, steps)
    theta, traj = theta0, [theta0]
    for k in range(steps):
        theta = theta - gbma.ota_aggregate(grad_fn(theta), keys[k], ch,
                                           use_kernel=False)
        traj.append(theta)
    return torch.stack(traj)


def run_transport(ops) -> tuple:
    """The channel-transport substrate (`core.transport`, `core.gbma`,
    `core.baselines`) on the card, at repro-100m's full width:

    (a) every registered algorithm through `transport.aggregate`, one slot
        each from a fresh state: the default route (K1 for the gbma
        family and power_control: one launch per block) against the plain
        route (`ota_impl='ref'`) at K1's bar; tiled (block_d = 2^20) and
        FULL_CONCAT against untiled within 1e-6; `tx_energy` rtol 1e-5;
        gbma with bf16 transmit (f32 out, a bf16-sized step off f32,
        the kernel within K1's bar of the plain route on the same bf16
        blocks);
        each variant's peak device memory beside the card's;
    (b) every algorithm on the reduced repro-100m tree on the card and on
        the CPU, within 1e-5 of each leaf's largest |v|;
    (c) gbma at full width untiled, tiled and with bf16 transmit: ms per
        slot (host clock), K1 launches per slot, K1's bare launches over
        the slot's blocks (CUDA events) beside its byte bound, the
        draw's ms alone, peak memory; the plain route's and (f32) one
        addmm's ms over the same blocks;
    (d) `GBMASimulator` (one K1 launch a step) and the three baselines
        at fig3's operating point (N = 500, d = 90, 300 steps, Rayleigh)
        on a least-squares problem: finite trajectories, the simulator's
        kernel route within 1e-5 of the largest |theta| of its plain
        route;
    (e) `shard_map_aggregate` under NCCL at world size 1 (tcp on
        127.0.0.1): equal to h·g/N + the edge noise within K1's bar.

    Returns (K1 launches of the main-path slots, the record)."""
    import socket

    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.core import baselines, gbma, rng, transport
    from repro_torch.core.channel import ChannelConfig, sample_gains
    from repro_torch.core.mc.slots import ALGO_REGISTRY
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.ota import kernel
    from repro_torch.kernels.ota.ref import ota_edge_aggregate_ref

    t_phase = time.perf_counter()
    record, launches = {}, {}
    total_mib = torch.cuda.get_device_properties(0).total_memory / 2**20
    arch = get_config(TRANSPORT_ARCH)
    params, grads = transport_tree(arch, "cuda")
    sizes = [p.numel() for p in tree_leaves(params)]
    n_params = sum(sizes)
    n_blocks = len(transport._block_ranges(sizes, TRANSPORT_BLOCK_D))
    log(f"transport: {TRANSPORT_ARCH} at full width, {n_params:,} f32 "
        f"parameters in {len(sizes)} leaves (largest {max(sizes):,} "
        f"columns), N = {TRANSPORT_NODES} nodes, {n_blocks} blocks of <= "
        f"{TRANSPORT_BLOCK_D:,} columns; the card holds {total_mib:.0f} MiB")
    key = rng.key(3, "cuda")

    # (a) every algorithm, one slot each
    ota_algos = ("gbma", "momentum", "nesterov", "power_control")
    rows = {}
    ops.launch_count = 0
    for algo in ALGO_REGISTRY:
        k1 = algo in ota_algos
        row = {}
        runs = {}
        variants = [("untiled", {}), ("tiled", {"block_d": TRANSPORT_BLOCK_D}),
                    ("full concat", {"block_d": transport.FULL_CONCAT})]
        if algo == "gbma":
            variants.append(("bf16 transmit", {"transmit_dtype": "bfloat16"}))
        for label, kw in variants:
            before = ops.launch_count
            runs[label], mib = _peak_mib(lambda: _slot(
                algo, grads, params, key, transport_cfg(algo, **kw)))
            n_k1 = ops.launch_count - before
            want = 0 if not k1 else {"untiled": len(sizes),
                                     "tiled": n_blocks, "full concat": 1,
                                     "bf16 transmit": len(sizes)}[label]
            row[label] = {"k1_launches": n_k1, "peak_mib": mib}
            if n_k1 != want:
                raise AssertionError(f"transport (a) {algo} {label}: {n_k1} "
                                     f"K1 launches, expected {want}")
        torch.cuda.synchronize()
        v, st, aux = runs["untiled"]
        energy = float(aux["tx_energy"])
        checks = {}
        if k1:  # the plain route on the card
            ref, mib = _peak_mib(lambda: _slot(
                algo, grads, params, key, transport_cfg(algo,
                                                        ota_impl="ref")))
            checks["kernel vs plain route"] = _tree_err(
                v, ref[0], *TRANSPORT_ROUTE_BAR)
            row["plain route"] = {"peak_mib": mib}
            del ref
        for label in ("tiled", "full concat"):
            checks[f"{label} vs untiled"] = _tree_err(runs[label][0], v,
                                                      1e-6, 0.0)
            e = float(runs[label][2]["tx_energy"])
            checks[f"{label} tx_energy"] = (
                abs(e - energy) / energy, abs(e - energy) <= 1e-5 * energy)
            if st is not None and "e" in st:
                checks[f"{label} residual"] = _tree_err(
                    runs[label][1]["e"], st["e"], 1e-6, 0.0)
        if algo == "gbma":  # bf16 transmit: K1 on bf16 blocks, f32 sums
            ref = _slot(algo, grads, params, key, transport_cfg(
                algo, transmit_dtype="bfloat16", ota_impl="ref"))
            checks["bf16 transmit: kernel vs plain route"] = _tree_err(
                runs["bf16 transmit"][0], ref[0], *TRANSPORT_ROUTE_BAR)
            del ref
            bf = tree_leaves(runs["bf16 transmit"][0])
            dev = _tree_err(runs["bf16 transmit"][0], v, 0.0, 0.0)[0]
            checks["bf16 transmit: f32 out, 0 < |dv| < 0.05"] = (
                dev, all(x.dtype == torch.float32 for x in bf)
                and 0.0 < dev < 0.05)
        finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(v))
        checks["finite"] = (0.0, finite)
        row["checks"] = {k: {"value": c[0], "ok": c[1]}
                         for k, c in checks.items()}
        row["tx_energy"] = energy
        log(f"transport (a) {algo}: {json.dumps(row)}")
        if not all(c[1] for c in checks.values()):
            raise AssertionError(f"transport (a) {algo}: a check failed")
        rows[algo] = row
        del runs, v, st
        torch.cuda.empty_cache()
    launches["transport (a) full width"] = ops.launch_count
    record["(a)"] = rows

    # (b) the card against the CPU on the reduced tree
    small_params, small = transport_tree(arch.reduced(), "cpu", seed=1)
    small_cuda = tree_map(lambda g: g.to("cuda"), small)
    small_params_cuda = tree_map(lambda p: p.to("cuda"), small_params)
    rels, card_launches = {}, 0
    for algo in ALGO_REGISTRY:
        cfg = transport_cfg(algo)
        ops.launch_count = 0
        card, _, card_aux = _slot(algo, small_cuda, small_params_cuda, key,
                                  cfg)
        card_launches += ops.launch_count
        cpu, _, cpu_aux = _slot(algo, small, small_params, key.cpu(), cfg)
        rels[algo] = max(_tree_rel_to_max(card, cpu), abs(
            float(card_aux["tx_energy"]) / float(cpu_aux["tx_energy"]) - 1))
    launches["transport (b) reduced"] = card_launches
    small_n = sum(x.numel() for x in tree_leaves(small_params))
    log(f"transport (b) card vs CPU on the reduced tree ({small_n:,} "
        f"parameters), max |card - cpu| / max |cpu| per algorithm (bar "
        f"1e-5): {json.dumps(rels)}; {card_launches} K1 launches")
    if card_launches != 4 * len(tree_leaves(small_params)) \
            or not all(r <= 1e-5 for r in rels.values()):
        raise AssertionError("transport (b): the card disagrees with the "
                             "CPU or K1 was not launched per leaf")
    record["(b)"] = {"parameters": small_n, "rel_to_max": rels}
    del small_cuda, small_params_cuda

    # (c) gbma's slot at full width: wall, K1 alone, the draw alone
    spec = transport.resolve("gbma")
    timing = {}
    for label, kw, g_bytes in (
            ("untiled", {}, 4),
            ("tiled", {"block_d": TRANSPORT_BLOCK_D}, 4),
            ("bf16 transmit", {"transmit_dtype": "bfloat16"}, 2)):
        cfg = transport_cfg("gbma", **kw)
        slot = lambda: transport.aggregate("gbma", grads, key, cfg)
        ops.launch_count = 0
        _, mib = _peak_mib(slot)
        per_slot = ops.launch_count
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            slot()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        ctx = transport.make_ctx(cfg, spec, "cuda")
        draw_ms = cuda_ms(lambda: spec.hoist_draws(
            key[None, None], ctx, TRANSPORT_NODES, n_params), reps, warmup=1)
        # K1's bare launches over the slot's blocks on prepared operands
        dtype = torch.bfloat16 if g_bytes == 2 else torch.float32
        flat = [g.reshape(TRANSPORT_NODES, -1).to(dtype)
                for g in tree_leaves(grads)]
        h = torch.rand((1, TRANSPORT_NODES), device="cuda")
        w = torch.randn((1, n_params), device="cuda")
        out = torch.empty((1, n_params), device="cuda")
        blocks = [(flat[li][None, :, lo:hi], w[:, off + lo:off + hi],
                   out[:, off + lo:off + hi])
                  for li, lo, hi, off in transport._block_ranges(
                      [f.shape[1] for f in flat], cfg.block_d)]
        k1_ms = cuda_ms(lambda: [kernel.launch(gv, h, wv, ov)
                                 for gv, wv, ov in blocks], reps)
        plain_ms = cuda_ms(lambda: [ota_edge_aggregate_ref(
            gv, h, wv, noise_scale=1.0, out_dtype=torch.float32)
            for gv, wv, _ in blocks], reps)
        # one addmm a block, w + (1/N)·h@g; none takes bf16 g and f32 h
        lib_ms = None if g_bytes == 2 else cuda_ms(lambda: [torch.addmm(
            wv, h, gv[0], alpha=1.0 / TRANSPORT_NODES)
            for gv, wv, _ in blocks], reps)
        bound = sum(ota_bound(1, TRANSPORT_NODES, gv.shape[2],
                              g_bytes=g_bytes)[0] for gv, _, _ in blocks)
        timing[label] = {
            "ms_per_slot": wall_ms, "k1_launches_per_slot": per_slot,
            "k1_ms": k1_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "k1_bound_ms": bound, "k1_bound_by": "bytes",
            "draw_ms": draw_ms, "peak_mib": mib, "card_mib": total_mib}
        log(f"transport (c) gbma {label}: {wall_ms:.3f} ms per slot (host "
            f"clock), {per_slot} K1 launches; K1 alone {k1_ms:.4f} ms "
            f"against its {bound:.4f} ms bound (bytes: N·D·{g_bytes} + "
            f"2·D·4 + gains), {bound / k1_ms:.1%} of it; plain route "
            f"{plain_ms:.4f} ms, addmm "
            f"{'n/a (bf16)' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
            f"the draw alone "
            f"{draw_ms:.3f} ms; peak {mib:.0f} MiB of the card's "
            f"{total_mib:.0f}")
        del flat, w, out, blocks
        torch.cuda.empty_cache()
    record["(c)"] = timing

    # (d) tier (i) and the baselines at fig3's operating point
    n, d, steps = (TRANSPORT_SIM[k] for k in ("n", "dim", "steps"))
    gen = torch.Generator(device="cuda").manual_seed(2)
    X = torch.randn((n, d), generator=gen, device="cuda") / math.sqrt(d)
    y = X @ torch.randn((d,), generator=gen, device="cuda")
    grad_fn = lambda th: (X @ th - y)[:, None] * X + 0.1 * th[None, :]
    ch = ChannelConfig(fading="rayleigh", noise_std=TRANSPORT_NOISE_STD)
    theta0 = torch.zeros((d,), device="cuda")
    sim_key = rng.key(5, "cuda")
    runs = {
        "GBMASimulator": lambda: gbma.GBMASimulator(grad_fn, ch, 1.0).run(
            theta0, steps, sim_key),
        "GBMASimulator plain route": lambda: _plain_simulator(
            gbma, grad_fn, ch, theta0, steps, sim_key),
        "CentralizedGD": lambda: baselines.CentralizedGD(grad_fn, 1.0).run(
            theta0, steps),
        "FDMGD": lambda: baselines.FDMGD(grad_fn, ch, 1.0).run(
            theta0, steps, sim_key),
        "PowerControlOTA": lambda: baselines.PowerControlOTA(
            grad_fn, ch, 1.0).run(theta0, steps, sim_key)}
    trajs, sim = {}, {}
    for name, run in runs.items():
        ops.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trajs[name] = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        traj = trajs[name]
        sim[name] = {"k1_launches": ops.launch_count, "wall_s": wall,
                     "finite": bool(torch.isfinite(traj).all()),
                     "shape": list(traj.shape),
                     "final_dist": (traj[-1] - traj[0]).norm().item()}
        if name == "GBMASimulator":
            launches["transport (d) GBMASimulator"] = ops.launch_count
    err = (trajs["GBMASimulator"] - trajs["GBMASimulator plain route"]) \
        .abs().max().item()
    scale = trajs["GBMASimulator plain route"].abs().max().item()
    log(f"transport (d) at N = {n}, d = {d}, {steps} steps, Rayleigh: "
        f"{json.dumps(sim)}; simulator kernel vs plain route max |dtheta| "
        f"{err:.3e} (bar 1e-5 x {scale:.3f})")
    want = {"GBMASimulator": steps}
    if any(not s["finite"] or s["shape"] != [steps + 1, d]
           or s["k1_launches"] != want.get(k, 0) for k, s in sim.items()) \
            or not err <= 1e-5 * scale:
        raise AssertionError("transport (d): a trajectory failed")
    record["(d)"] = {**sim, "route_err": err}
    del trajs

    # (e) tier (iii) over NCCL at world size 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        gcfg = gbma.GBMAConfig(n_nodes=TRANSPORT_NODES, channel=ch)
        local = tree_map(lambda g: g[0], grads)
        k_h, k_w = rng.split(key)
        gain = sample_gains(k_h, ch, (1,))[0]
        t0 = time.perf_counter()
        v = gbma.shard_map_aggregate(local, gain, k_w, gcfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = gbma.perturb_gradients(tree_map(
            lambda g: g * gain / TRANSPORT_NODES, local), k_w, gcfg)
        err, ok = _tree_err(v, want, *TRANSPORT_ROUTE_BAR)
    finally:
        dist.destroy_process_group()
    log(f"transport (e) shard_map_aggregate, NCCL at world size 1, "
        f"{n_params:,} parameters: {wall * 1e3:.2f} ms, max |v - (h g / N "
        f"+ w)| = {err:.3e} (bar {TRANSPORT_ROUTE_BAR[0]} + "
        f"{TRANSPORT_ROUTE_BAR[1]}·|v|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("transport (e): shard_map_aggregate differs")
    record["(e)"] = {"ms": wall * 1e3, "max_abs_err": err}
    del params, grads, local, v, want
    torch.cuda.empty_cache()
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"transport: phase {record['phase_s']:.1f} s, K1 launches "
        f"{json.dumps(launches)}")
    return launches, record


# ---------------------------------------------------------------- serving
def build_kernels() -> tuple:
    """Build every CUDA source at once (one nvcc each) and print what
    ptxas reports (registers, spills), the dynamic shared memory of each
    attention kernel per head_dim, K1's registers, spills and shared
    memory per instantiation (`ota_build_summary`), the SASS of the bf16
    (`sass_summary`) and the f32 (`f32_sass_summary`) attention kernels
    and the WKV kernels' registers, spills and shared memory
    (`wkv_build_summary`, `wkv_bwd_build_summary`), which it returns."""
    import torch

    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.ota import kernel as ota_kernel
    from repro_torch.kernels.wkv import kernel as wkv_kernel

    builds = {"ota_aggregate": (ota_kernel.build, ota_kernel.SOURCE),
              "flash_attention": (attn_kernel.build, attn_kernel.SOURCE),
              "flash_attention_sm90": (attn_kernel.build_sm90,
                                       attn_kernel.SM90_SOURCE),
              "wkv6": (wkv_kernel.build, wkv_kernel.SOURCE),
              "wkv6_bwd": (wkv_kernel.build_backward,
                           wkv_kernel.BWD_SOURCE)}
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
            wkv_build_summary(infos["wkv6"]),
            wkv_bwd_build_summary(infos["wkv6_bwd"]))


def wkv_bwd_build_summary(info) -> dict:
    """Per instantiation of the WKV backward, keyed "<dtype> d=<head_dim>":
    ptxas's registers and spill bytes and the block's dynamic shared
    memory of the kernel, and the second pass's (summing the row groups'
    dv partials) registers and spills under "sum". Raises if an
    instantiation is missing."""
    import ctypes
    import re

    from repro_torch.kernels.wkv import kernel as wkv_kernel

    def keyer(name):
        def key(mangled):
            m = re.search(name + r"I(13__nv_bfloat16|f)Li(\d+)EE", mangled)
            if not m:
                return None
            return f"{'bf16' if m.group(1) != 'f' else 'f32'} d={m.group(2)}"
        return key

    out = ptxas_by_kernel(info.log, keyer("wkv6_bwd_kernel"))
    second = ptxas_by_kernel(info.log, keyer("wkv6_bwd_dv_sum_kernel"))
    smem = ctypes.CDLL(str(info.path)).wkv6_bwd_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_int
    for dtype in ("f32", "bf16"):
        for d in wkv_kernel.HEAD_DIMS:
            key = f"{dtype} d={d}"
            out.setdefault(key, {})["smem_bytes"] = smem(d, int(dtype ==
                                                                "bf16"))
            out[key]["sum"] = second.get(key, {})
    log(f"wkv6_bwd ptxas and shared memory per kernel: {out}")
    if not all("registers" in v and "registers" in v["sum"]
               for v in out.values()):
        raise AssertionError("the WKV backward library lacks an "
                             "instantiation")
    return out


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
    copy=<16|element>[ ckpt]" (ckpt: the training instantiation writing
    chunk checkpoints): ptxas's registers and spill bytes and the block's
    dynamic shared memory. Raises if an instantiation is missing."""
    import re

    import torch

    from repro_torch.kernels.wkv import kernel as wkv_kernel

    def key(mangled):
        m = re.search(r"wkv6_kernelI(13__nv_bfloat16|f)Li(\d+)ELb(\d)ELb"
                      r"(\d)E", mangled)
        if not m:
            return None
        dtype = "bf16" if m.group(1) != "f" else "f32"
        copy = "16" if m.group(3) == "1" else "element"
        ckpt = " ckpt" if m.group(4) == "1" else ""
        return f"{dtype} d={m.group(2)} copy={copy}{ckpt}"

    out = ptxas_by_kernel(info.log, key)
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for d in wkv_kernel.HEAD_DIMS:
            smem = wkv_kernel.smem_bytes(d, dtype)
            for copy in ("16", "element"):
                for ckpt in ("", " ckpt"):
                    out.setdefault(f"{name} d={d} copy={copy}{ckpt}", {})[
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


def live_pairs(s: int, window=None, causal: bool = True) -> int:
    """(query, key) pairs a causal self-attention over `s` positions
    computes, each query seeing at most `window` keys; s² without the
    causal mask."""
    if not causal:
        return s * s
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attention_bound(b, h, s, d, dtype_name, hkv=None, window=None,
                    causal: bool = True) -> tuple:
    """(least ms, what bounds it) for one causal self-attention call: q
    and o at `h` heads and k, v at `hkv` (default `h`) heads moved once,
    against 4·d flops (the QKᵀ and PV products) for each live (query,
    key) pair (`live_pairs`: s(s + 1)/2 without a window) and query head,
    at the peak rate of the inputs' type (bf16: tensor cores; f32: the
    CUDA cores, since TF32 cannot meet the kernel's bar). A softcap's
    tanh is not counted."""
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = elt * b * s * d * (2 * h + 2 * (hkv or h))
    flops = 4.0 * b * h * d * live_pairs(s, window, causal)
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


def build_served(arch: str = "rwkv6-7b", **overrides) -> tuple:
    """`arch` at full width and depth (or the config `overrides`, such as
    a depth cut) with seeded random weights on the card, and the peak
    device memory of their initialization (each leaf is drawn in f32
    before its cast to bf16; MoE experts one expert at a time)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, params = _serve_model(arch, **overrides)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"{arch} weights: {n_params / 1e9:.4f} B parameters, "
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


def _serve_model(arch: str, params=None, impl: str = "auto", **overrides):
    """(model, params) at full width and depth (or the config
    `overrides`); weights from a generator seeded 0 on the card unless
    `params` is given. `impl` picks the route of the model's kernel."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model

    model = build_model(get_config(arch).with_(**overrides), impl)
    return model, params if params is not None else model.init_params(
        device="cuda")


def _prompt(vocab: int, s: int, seed: int = 1, batch: int = SERVE_BATCH):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, (batch, s), generator=gen,
                         device="cuda")


def _serve_batch(cfg, s: int, seed: int = 1, batch: int = SERVE_BATCH,
                 device: str = "cuda") -> dict:
    """A prompt of `s` token ids (`_prompt` on the card) and, where the
    model takes them, f32 standard-normal frames (B, enc_seq, D) or
    patch embeddings (B, n_patches, D) from a generator seeded `seed` +
    100, as the launcher draws them in f32."""
    import torch

    if device == "cuda":
        out = {"tokens": _prompt(cfg.vocab_size, s, seed, batch)}
    else:
        gen = torch.Generator().manual_seed(seed)
        out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, s),
                                       generator=gen)}
    gen = torch.Generator(device=device).manual_seed(seed + 100)
    if cfg.n_patches:
        out["patch_embed"] = torch.randn((batch, cfg.n_patches, cfg.d_model),
                                         generator=gen, device=device)
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                    generator=gen, device=device)
    return out


def _prefix(cfg) -> int:
    """Positions before the prompt: the VLM's patches, hymba's meta
    tokens."""
    return (cfg.n_patches or 0) + (cfg.meta_tokens or 0)


def _rel_to_max(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def run_serve_main_path(ops, model, params, *, kernel: str,
                        per_generate: int, prompts: tuple = SERVE_PROMPTS,
                        batch: int = SERVE_BATCH) -> dict:
    """`model` served by `Engine.generate` at each prompt length, after
    an untimed warm-up run of 2 new tokens: the kernel's launch count
    (`ops`) is set to 0 before and read after the timed run and must be
    `per_generate`, and the tokens are checked to lie in the vocabulary.
    `serve_timing` profiles a prefill and one decode step (a whole
    `generate` under torch.profiler took up to a minute, so none is
    profiled whole)."""
    import torch

    from repro_torch.serving.engine import Engine, ServeConfig

    cfg = model.cfg
    eng = Engine(model, params, ServeConfig(max_new_tokens=SERVE_NEW_TOKENS))
    warm = Engine(model, params, ServeConfig(max_new_tokens=2))
    out = {}
    for s in prompts:
        inputs = _serve_batch(cfg, s, batch=batch)
        # warm-up at this prompt length (cuBLAS plans for the prefill and
        # the decode step, the cache's allocation), so the timed run
        # below is the steady state
        warm.generate(inputs)
        torch.cuda.synchronize()
        ops.launch_count = 0
        t0 = time.perf_counter()
        gen = eng.generate(inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_count
        ok_vocab = bool(((gen >= 0) & (gen < cfg.vocab_size)).all())
        log(f"serve {cfg.arch_id} ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.dtype}) B={batch} prompt={s} "
            f"new={SERVE_NEW_TOKENS}: wall {wall:.4f} s, "
            f"{batch * SERVE_NEW_TOKENS / wall:.1f} tok/s, "
            f"{launches} {kernel} kernel launches, tokens in vocabulary: "
            f"{ok_vocab}; first row {gen[0, :8].tolist()}")
        if launches != per_generate:
            raise AssertionError(f"expected {per_generate} {kernel} kernel "
                                 f"launches per generate, got {launches}")
        if gen.shape != (batch, SERVE_NEW_TOKENS) or not ok_vocab:
            raise AssertionError("generated ids out of shape or vocabulary")
        out[s] = {"wall_s": wall, "launches": launches,
                  "tok_per_s": batch * SERVE_NEW_TOKENS / wall}
    return out


def check_serve_routes(model, params, prompts: tuple = SERVE_PROMPTS,
                       batch: int = SERVE_BATCH, plain: bool = True) -> dict:
    """A model in bf16 (olmo-1b; the S2, S6 and S7 models) at each prompt
    length: prefill logits finite and (with `plain`) within the bar
    between the kernel route and the plain route, and prefill(S) + one
    decode step (at S plus the patches and meta tokens before the
    prompt) against prefill(S + 1)."""
    import torch

    from repro_torch.models.model import build_model

    cfg = model.cfg
    ref_model = build_model(cfg, impl="ref") if plain else None
    out = {}
    for s in prompts:
        full_in = _serve_batch(cfg, s + 1, seed=2, batch=batch)
        head = {**full_in, "tokens": full_in["tokens"][:, :s]}
        ker_logits, cache = model.prefill(params, head, s + 1)
        finite = bool(torch.isfinite(ker_logits).all())
        row, msg = {}, ""
        if plain:
            ref_logits, _ = ref_model.prefill(params, head, s + 1)
            row["routes_rel"] = _rel_to_max(ker_logits, ref_logits)
            agree = (ker_logits.argmax(-1)
                     == ref_logits.argmax(-1)).sum().item()
            msg = (f"kernel vs plain route max|diff|/max|logit| "
                   f"{row['routes_rel']:.3e} (bar {BF16_LOGIT_BAR}), argmax "
                   f"agree {agree}/{batch}; ")
        inc, _ = model.decode_step(params, cache, full_in["tokens"][:, s],
                                   s + _prefix(cfg))
        full, _ = model.prefill(params, full_in, s + 1)
        row["decode_rel"] = _rel_to_max(inc, full)
        log(f"serve {cfg.arch_id} prompt={s}: logits finite {finite}, "
            f"max |logit| {full.abs().max().item():.4f}; {msg}"
            f"prefill({s})+decode vs prefill({s + 1}) "
            f"{row['decode_rel']:.3e} (bar {BF16_LOGIT_BAR})")
        if not (finite and all(v <= BF16_LOGIT_BAR for v in row.values())):
            raise AssertionError(f"serve {cfg.arch_id} prompt={s}: route "
                                 "or decode consistency check failed")
        out[s] = row
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


def _best_ms(fn, reps: int = 3) -> float:
    """Best host-clock ms of `fn` over `reps` calls after one warm-up,
    each ending in a synchronize (host-bound steps vary by tens of per
    cent from call to call on a shared host)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3


def serve_timing(model, params, kernel: str,
                 prompts: tuple = SERVE_PROMPTS,
                 batch: int = SERVE_BATCH) -> dict:
    """Prefill ms and decode ms per step (host clock around work that ends
    in a synchronize; best of 3 after a warm-up) at each prompt length,
    and a torch.profiler count of one prefill and one decode step
    (launches, host syncs, device busy time, idle share against the
    profiler-free wall time, and the launches and device time of the
    kernels named `kernel`; beside them the kernel wrapper's own count of
    its launches in the profiled run, which the profiler can miss)."""
    import torch

    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.wkv import ops as wkv_ops

    counter = wkv_ops if kernel == "wkv6" else attn_ops
    out = {}
    for s in prompts:
        inputs = _serve_batch(model.cfg, s, batch=batch)
        max_len = s + SERVE_NEW_TOKENS
        tok = inputs["tokens"][:, -1]

        def prefill():
            return model.prefill(params, inputs, max_len)

        _, cache = prefill()

        def decode():
            model.decode_step(params, cache, tok, s + _prefix(model.cfg))

        pre_ms, dec_ms = _best_ms(prefill), _best_ms(decode)
        prof = {}
        for name, fn in (("prefill", prefill), ("decode", decode)):
            before = counter.launch_count
            prof[name] = _profile_counts(fn, kernel=kernel)
            prof[name]["wrapper"] = counter.launch_count - before
        row = {"prefill_ms": pre_ms, "decode_ms_per_step": dec_ms,
               "decode_tok_per_s": batch / dec_ms * 1e3}
        for name, wall in (("prefill", pre_ms), ("decode", dec_ms)):
            p = prof[name]
            busy = p["device_us"] / 1e3
            row[name] = {"launches": p["launches"], "syncs": p["syncs"],
                         "memcpy": p["memcpy"], "device_busy_ms": busy,
                         "device_idle_share": 1.0 - busy / wall,
                         f"{kernel}_kernels": p["kernel"],
                         f"{kernel}_device_ms": p["kernel_us"] / 1e3,
                         f"{kernel}_wrapper_launches": p["wrapper"]}
        log(f"serve timing {model.cfg.arch_id} B={batch} prompt={s}: "
            f"{json.dumps(row)}")
        out[s] = row
    return out


# --------------------------------------------------------------------------
# serving the window, softcap and qk-norm families (S2): gemma2-9b,
# gemma-7b and minitron-4b at full width and depth, through K2's bf16
# kernel at head_dim 256 with windows and softcaps
# --------------------------------------------------------------------------
S2_ARCHS = ("gemma2-9b", "gemma-7b", "minitron-4b")
# gemma2-9b's context length, served at B = 1: its local layers' window
# (4,096) masks keys in prefill and decode
S2_LONG_PROMPT = 8192
# and at B = 1 a prompt past the window and not a multiple of it, whose
# prefill must place each key in its ring slot for decode (c only)
S2_UNALIGNED_PROMPT = 5000
# K2's shapes on the S2 path (label, dtype, B, Hq, Hkv, S, d, causal,
# window, softcap): gemma2-9b's local layers at the 2048-token prompt (the
# window is passed and does not bite), its local and global layers at
# 8,192 tokens, gemma-7b (MHA) and minitron-4b (groups of 3) at 2048
S2_ATTN_CASES = (
    ("gemma2-9b local, prompt 2048", "bfloat16", 4, 16, 8, 2048, 256, True,
     4096, 50.0),
    ("gemma2-9b local, prompt 8192", "bfloat16", 1, 16, 8, 8192, 256, True,
     4096, 50.0),
    ("gemma2-9b global, prompt 8192", "bfloat16", 1, 16, 8, 8192, 256, True,
     None, 50.0),
    ("gemma-7b, prompt 2048", "bfloat16", 4, 16, 16, 2048, 256, True, None,
     None),
    ("minitron-4b, prompt 2048", "bfloat16", 4, 24, 8, 2048, 128, True,
     None, None),
)
# K2's bars (atol, rtol) by dtype, the reference's (tests/test_kernels.py)
ATTN_BARS = {"bfloat16": (3e-2, 0.0), "float32": (5e-5, 1e-4)}
# q's scale in (a)'s softcap cases: randn q and k give scaled logits of
# spread 1, within about ±5, where 50·tanh(s/50) moves a logit by < 0.01
# and a kernel without the softcap would meet the bar; at spread 10 the
# largest logits sit well into the cap
S2_SOFTCAP_Q_SCALE = 10.0
# (e) the reduced models in f32 on the card (K2's f32 kernel) against the
# CPU (its plain version): prefill past the reduced window of 16, then
# decode; logits within this share of the largest
S2_CPU_BAR = 1e-4
S2_CPU_PROMPT, S2_CPU_STEPS = 24, 3


def flex_library(q, k, v, scale: float, window, cap) -> tuple:
    """The one PyTorch call that computes K2's function under a softcap or
    a window: `flex_attention` compiled by torch.compile, the softcap its
    score_mod, causality and the window its block mask (built once, before
    any timing), GQA by `enable_gqa`. Returns (the call, seconds its first
    call took, compilation included)."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki
        if window is not None:
            keep = keep & (qi - ki < window)
        return keep

    def softcap(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    s = q.shape[-2]
    block_mask = create_block_mask(mask_mod, None, None, s, s,
                                   device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)
    kw = {"score_mod": softcap if cap is not None else None,
          "block_mask": block_mask, "scale": scale,
          "enable_gqa": q.shape[1] != k.shape[1]}

    def call():
        return flex(q, k, v, **kw)

    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return call, time.perf_counter() - t0


def check_attention_cases(phase: str, cases: tuple) -> list:
    """K2 at each case (label, dtype, B, Hq, Hkv, S, d, causal, window,
    softcap) against its plain version (`ATTN_BARS`: bf16 atol 3e-2, f32
    atol 5e-5 + rtol 1e-4 |ref|; `plain_attention`), timed with CUDA
    events beside its bound (by operations over the live pairs), the
    plain version and the one PyTorch call that computes the same
    function: `F.scaled_dot_product_attention` without a softcap or a
    window that masks keys (`enable_gqa` for groups), compiled
    `flex_attention` with them (`flex_library`), itself held to the plain
    version first. Under a
    softcap q is scaled by S2_SOFTCAP_Q_SCALE so the logits reach the
    cap. Controls hold the kernel against the plain version without the
    softcap, without the window where it bites, and with the causal mask
    for a non-causal case; each must miss the bar."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention.ops import (multi_head_attention,
                                                   plain_attention)

    rows = []
    for label, dt, b, hq, hkv, s, d, causal, window, cap in cases:
        atol, rtol = ATTN_BARS[dt]
        q, k, v = attn_inputs(b, hq, hkv, s, d, getattr(torch, dt), s + hq)
        if cap is not None:
            q = q * S2_SOFTCAP_Q_SCALE
        scale = d ** -0.5
        kw = {"scale": scale, "causal": causal, "window": window,
              "softcap": cap}
        ker = multi_head_attention(q, k, v, impl="kernel", **kw).float()
        ref = plain_attention(q, k, v, **kw).float()

        def excess(out) -> float:
            return ((out.float() - ref).abs() - rtol * ref.abs()).max().item()

        err = (ker - ref).abs().max().item()
        ok = bool(torch.isfinite(ker).all()) and excess(ker) <= atol
        controls = {}
        if cap is not None:
            controls["softcap"] = {**kw, "softcap": None}
        if window is not None and window < s:
            controls["window"] = {**kw, "window": None}
        if not causal:
            controls["causal mask"] = {**kw, "causal": True}
        for name, ckw in controls.items():
            ctl = plain_attention(q, k, v, **ckw).float()
            controls[name] = (ker - ctl).abs().max().item()
            ok = ok and controls[name] > atol
            del ctl
        if cap is None and (window is None or window >= s):
            gqa = {"enable_gqa": True} if hkv != hq else {}
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, scale=scale, **gqa)
            lib_note = "SDPA" + (" (enable_gqa)" if gqa else "")
        else:
            lib, compile_s = flex_library(q, k, v, scale, window, cap)
            lib_note = (f"flex_attention compiled ({compile_s:.1f} s to "
                        "its first result)")
        lib_out = lib()
        lib_err = (lib_out.float() - ref).abs().max().item()
        ok = ok and excess(lib_out) <= atol
        del ker, ref, lib_out
        reps = 5 if s > 4096 or dt == "float32" else 20
        ker_ms = cuda_ms(lambda: multi_head_attention(q, k, v, impl="kernel",
                                                      **kw), reps)
        plain_ms = cuda_ms(lambda: plain_attention(q, k, v, **kw), 2,
                           warmup=1)
        lib_ms = cuda_ms(lib, reps)
        bound, bound_by = attention_bound(b, hq, s, d, dt, hkv=hkv,
                                          window=window, causal=causal)
        flops = 4.0 * b * hq * d * live_pairs(s, window, causal)
        row = {"case": label, "shape": [b, hq, s, d], "kv_heads": hkv,
               "causal": causal, "window": window, "softcap": cap,
               "dtype": dt,
               "q_scale": S2_SOFTCAP_Q_SCALE if cap is not None else 1.0,
               "max_abs_err": err, "controls_max_abs_err": controls,
               "ms": ker_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": lib_note, "library_max_abs_err": lib_err,
               "bound_ms": bound, "bound_by": bound_by, "gflop": flops / 1e9,
               "tflops": flops / (ker_ms * 1e-3) / 1e12}
        ctl = "".join(f"; control: kernel vs plain without the {n} "
                      f"{e:.3e} (must miss the bar)"
                      for n, e in controls.items())
        log(f"{phase} K2 {label} q({b}, {hq}, {s}, {d}) kv heads {hkv} {dt} "
            f"causal {causal} window {window} softcap {cap} q scale "
            f"{row['q_scale']}: kernel vs plain max_abs_err {err:.3e} (atol "
            f"{atol} + rtol {rtol}){ctl}; {lib_note} vs plain {lib_err:.3e}; "
            f"{'ok' if ok else 'FAIL'}; kernel {ker_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms "
            f"({ker_ms / lib_ms:.2f}x), bound {bound:.4f} ms ({bound_by}, "
            f"{flops / 1e9:.1f} GFLOP), {bound / ker_ms:.1%} of the bound, "
            f"{row['tflops']:.1f} TFLOP/s")
        if not ok:
            raise AssertionError(f"K2 at {label}: the kernel, a control or "
                                 "the library call fails its check")
        rows.append(row)
        del q, k, v, lib
        torch.cuda.empty_cache()
    return rows


def check_s2_card_vs_cpu(attn_ops, cases=None,
                         phase: str = "serve S2 (e)") -> dict:
    """(e) Each reduced S2 model (and gemma-7b with qk-norm; or the
    `cases` given, (arch, config overrides)) in f32, from one CPU
    initialization: prefill past the reduced window and decode steps on
    the card (K2's f32 kernel) against the CPU (the plain version, which
    the CPU tests hold to the JAX reference), and on the card the first
    decode against a prefill one token longer: the prompt of 24 is past
    the window of 16 and not a multiple of it, so this reads the ring
    buffer as prefill placed it. Frames and patch embeddings, where the
    model takes them, are drawn on the CPU and copied; decode positions
    count the patches and meta tokens before the prompt."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model

    out = {}
    if cases is None:
        cases = [(a, {}) for a in S2_ARCHS] + [("gemma-7b",
                                                {"qk_norm": True})]
    for arch, extra in cases:
        name = arch + "".join(f" {k.replace('_', '-')}" for k in extra)
        cfg = get_config(arch).reduced().with_(**extra)
        model = build_model(cfg)
        cpu_params = model.init_params(device="cpu")
        cuda_params = _tree_map(lambda x: x.cuda(), cpu_params)
        max_len = S2_CPU_PROMPT + S2_CPU_STEPS
        inputs = _serve_batch(cfg, max_len, seed=4, batch=2, device="cpu")
        worst = 0.0
        attn_ops.launch_count = 0
        runs = {}
        for dev, params in (("cuda", cuda_params), ("cpu", cpu_params)):
            full = {k: v.to(dev) for k, v in inputs.items()}
            t = full["tokens"]
            logits, cache = model.prefill(
                params, {**full, "tokens": t[:, :S2_CPU_PROMPT]}, max_len)
            seq = [logits.cpu()]
            for i in range(S2_CPU_STEPS):
                pos = S2_CPU_PROMPT + i
                logits, cache = model.decode_step(params, cache, t[:, pos],
                                                  pos + _prefix(cfg))
                seq.append(logits.cpu())
            runs[dev] = seq
            if dev == "cuda":
                launches = attn_ops.launch_count
                longer, _ = model.prefill(
                    params, {**full, "tokens": t[:, :S2_CPU_PROMPT + 1]},
                    max_len)
                ring = _rel_to_max(seq[1], longer.cpu())
        for a, b in zip(runs["cuda"], runs["cpu"]):
            worst = max(worst, _rel_to_max(a, b))
        ok = (worst <= S2_CPU_BAR and ring <= S2_CPU_BAR
              and launches == cfg.n_layers + cfg.n_enc_layers)
        log(f"{phase} reduced {name} f32: card vs CPU logits over the "
            f"prefill ({S2_CPU_PROMPT} tokens, window "
            f"{cfg.sliding_window}) and {S2_CPU_STEPS} decode steps "
            f"{worst:.3e} of the largest; on the card prefill("
            f"{S2_CPU_PROMPT}) + decode vs prefill({S2_CPU_PROMPT + 1}) "
            f"{ring:.3e} (the prompt past the window and not a multiple "
            f"of it); bar {S2_CPU_BAR}; K2 {launches} launches on the card "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{phase} card vs CPU {name}")
        out[name] = {"card_vs_cpu": worst,
                     "decode_vs_longer_prefill": ring}
    return out


def serve_s2(attn_ops) -> tuple:
    """The "serve S2" phase: (a) K2 at the S2 shapes
    (`check_attention_cases`);
    then each S2 model at full width and depth in bf16 from seeded random
    weights, freed before the next: (b) `Engine.generate` at B = 4 with
    32- and 2048-token prompts and 32 new tokens (gemma2-9b also at B = 1
    with its 8,192-token context), K2 n_layers launches a generate; (c)
    the kernel route against the plain route and prefill(S) + decode
    against prefill(S + 1) at BF16_LOGIT_BAR, gemma2-9b also at B = 1
    with S2_UNALIGNED_PROMPT tokens; (d) prefill and decode ms,
    launches, device busy time and idle share, K2's device ms inside the
    prefill; then (e) the reduced models on the card against the CPU.
    Returns (K2 launches by run, the record)."""
    import torch

    t_phase = time.perf_counter()
    seconds = {}

    def mark(part: str) -> None:
        torch.cuda.synchronize()
        seconds[part] = time.perf_counter() - t_phase - sum(seconds.values())

    record = {"attention": check_attention_cases("serve S2 (a)",
                                                 S2_ATTN_CASES),
              "models": {},
              "seconds": seconds}
    mark("(a)")
    launches = {}
    for arch in S2_ARCHS:
        model, params, init = build_served(arch)
        runs = [(SERVE_PROMPTS, SERVE_BATCH)]
        if model.cfg.sliding_window:
            runs.append(((S2_LONG_PROMPT,), 1))
        rows = {}
        for prompts, batch in runs:
            served = run_serve_main_path(
                attn_ops, model, params, kernel="flash_attention",
                per_generate=model.cfg.n_layers, prompts=prompts,
                batch=batch)
            routes = check_serve_routes(model, params, prompts, batch)
            times = serve_timing(model, params, "flash_attention", prompts,
                                 batch)
            for s in prompts:
                key = f"B={batch} prompt {s}"
                rows[key] = {**served[s], **routes[s], **times[s]}
                launches[f"{arch} {key}"] = served[s]["launches"]
                # the wrapper's count gates: the profiler once saw 31 of
                # minitron-4b's 32 K2 launches in a prefill
                k2 = times[s]["prefill"]["flash_attention_wrapper_launches"]
                if k2 != model.cfg.n_layers:
                    raise AssertionError(
                        f"{arch} {key}: {k2} K2 launches in a profiled "
                        f"prefill, expected {model.cfg.n_layers}")
        if model.cfg.sliding_window:
            rows[f"B=1 prompt {S2_UNALIGNED_PROMPT} (c)"] = \
                check_serve_routes(model, params, (S2_UNALIGNED_PROMPT,),
                                   1)[S2_UNALIGNED_PROMPT]
        record["models"][arch] = {"init": init, **rows}
        del model, params
        torch.cuda.empty_cache()
        mark(f"(b)-(d) {arch}")
    record["card_vs_cpu"] = check_s2_card_vs_cpu(attn_ops)
    mark("(e)")
    log(f"serve S2: seconds by part {json.dumps(seconds)}")
    return launches, record


# --------------------------------------------------------------------------
# the int8 KV cache and head padding (S3): gemma-7b at full width and
# depth
# --------------------------------------------------------------------------
S3_ARCH = "gemma-7b"
S3_PROMPT = 2048
# the reference's int8-vs-fp bars (atol = rtol), tests/test_int8_cache.py,
# held where its test holds them: an f32 model
S3_BARS = {"prefill": 0.05, "decode": 0.08}
# in bf16, the int8 cache's logits at most this many times as far from the
# f32 model's as the bf16 cache's (relative to the largest logit): through
# 28 bf16 layers any perturbation of the cache, however small, moves a
# logit by a bf16 ulp of the hidden state times the embedding
S3_BF16_RATIO = 2.0


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def _decode_run(model, params, inputs, tokens=None) -> tuple:
    """Prefill `inputs` into a cache of S3_PROMPT + SERVE_NEW_TOKENS and
    decode SERVE_NEW_TOKENS steps: each step feeds `tokens[i]` when given,
    else this run's greedy token. Returns (logits of the prefill and each
    step, the tokens fed, the cache's bytes)."""
    logits, cache = model.prefill(params, inputs,
                                  S3_PROMPT + SERVE_NEW_TOKENS)
    seq, fed = [logits], []
    for i in range(SERVE_NEW_TOKENS):
        tok = logits.argmax(-1) if tokens is None else tokens[i]
        fed.append(tok)
        logits, cache = model.decode_step(params, cache, tok, S3_PROMPT + i)
        seq.append(logits)
    return seq, fed, _nbytes(cache)


def _share(ours, ref, bar: float) -> float:
    """The largest |ours - ref| over the reference's allowance
    bar * (1 + |ref|): at most 1 within atol = rtol = bar."""
    return ((ours - ref).abs() / (bar * (1.0 + ref.abs()))).max().item()


def serve_s3(attn_ops) -> tuple:
    """The "serve S3" phase: gemma-7b at full width and depth, B = 4, a
    2,048-token prompt and 32 new tokens, from seeded random weights.
    (a) `Engine.generate` in bf16 with `opt_int8_cache=True` through K2
    (28 launches a generate); (b) the prefill and 32 decode steps of the
    int8 and the bf16 cache, both fed the bf16 cache's greedy tokens: the
    first greedy token equal; then the same weights upcast to f32 (TF32
    off), where the reference's own test holds the int8 cache, the int8
    cache's logits within 0.05 (prefill) and 0.08 (decode) of the f32
    cache's (atol = rtol); in bf16 the int8 cache's logits at most
    S3_BF16_RATIO times as far from the f32 model's as the bf16 cache's,
    and their gap to the bf16 cache's at the reference's bars reported;
    (c) the caches' bytes; (d) the prefill and a decode step of each
    cache timed and profiled; (e) `opt_pad_heads=True` gives the bf16
    cache's prefill and decode logits bit for bit. Returns (K2 launches
    by run, the record)."""
    import torch

    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    model, params, init = build_served(S3_ARCH)
    cfg = model.cfg
    q8 = build_model(cfg.with_(opt_int8_cache=True))
    served = run_serve_main_path(attn_ops, q8, params,
                                 kernel="flash_attention",
                                 per_generate=cfg.n_layers,
                                 prompts=(S3_PROMPT,))
    times = {"bf16": serve_timing(model, params, "flash_attention",
                                  prompts=(S3_PROMPT,))[S3_PROMPT],
             "int8": serve_timing(q8, params, "flash_attention",
                                  prompts=(S3_PROMPT,))[S3_PROMPT]}
    log(f"serve S3 (d) decode step: int8 cache "
        f"{times['int8']['decode_ms_per_step']:.3f} ms "
        f"({times['int8']['decode']['launches']} launches) vs bf16 "
        f"{times['bf16']['decode_ms_per_step']:.3f} ms "
        f"({times['bf16']['decode']['launches']} launches)")
    pad = build_model(cfg.with_(opt_pad_heads=True))
    short = _serve_batch(cfg, SERVE_PROMPTS[0], seed=6)
    lp, cp = pad.prefill(params, short, SERVE_PROMPTS[0] + 1)
    lf, cf = model.prefill(params, short, SERVE_PROMPTS[0] + 1)
    same = bool(torch.equal(lp, lf))
    tok = lf.argmax(-1)
    lp, _ = pad.decode_step(params, cp, tok, SERVE_PROMPTS[0])
    lf, _ = model.decode_step(params, cf, tok, SERVE_PROMPTS[0])
    same = same and bool(torch.equal(lp, lf))
    log(f"serve S3 (e) opt_pad_heads=True prefill({SERVE_PROMPTS[0]}) and "
        f"a decode step == without it, bit for bit: {same}")
    del cf, cp
    inputs = _serve_batch(cfg, S3_PROMPT, seed=5)
    runs = {}
    runs["bf16"], tokens, bytes_fp = _decode_run(model, params, inputs)
    runs["bf16 int8"], _, bytes_q8 = _decode_run(q8, params, inputs, tokens)
    params32 = _tree_map(lambda x: x.float(), params)
    del model, q8, pad, params
    torch.cuda.empty_cache()
    cfg32 = cfg.with_(dtype="float32")
    runs["f32"], _, _ = _decode_run(build_model(cfg32), params32, inputs,
                                    tokens)
    runs["f32 int8"], _, _ = _decode_run(
        build_model(cfg32.with_(opt_int8_cache=True)), params32, inputs,
        tokens)
    del params32
    torch.cuda.empty_cache()

    def worst(ours, ref, kind) -> float:
        steps = runs[ours][:1] if kind == "prefill" else runs[ours][1:]
        refs = runs[ref][:1] if kind == "prefill" else runs[ref][1:]
        return max(_share(a, b, S3_BARS[kind]) for a, b in zip(steps, refs))

    def rel(ours, ref) -> float:
        return max(_rel_to_max(a, b) for a, b in zip(runs[ours], runs[ref]))

    shares = {f"{pair} {kind}": worst(*pair.split(" vs "), kind)
              for pair in ("f32 int8 vs f32", "bf16 int8 vs bf16")
              for kind in ("prefill", "decode")}
    dist = {"bf16 int8 vs f32": rel("bf16 int8", "f32"),
            "bf16 vs f32": rel("bf16", "f32")}
    first_equal = bool(torch.equal(runs["bf16 int8"][0].argmax(-1),
                                   runs["bf16"][0].argmax(-1)))
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(runs["bf16 int8"][1:], runs["bf16"][1:]))
    finite = all(bool(torch.isfinite(x).all()) for r in runs.values()
                 for x in r)
    ok = (same and first_equal and finite
          and shares["f32 int8 vs f32 prefill"] <= 1.0
          and shares["f32 int8 vs f32 decode"] <= 1.0
          and dist["bf16 int8 vs f32"] <= S3_BF16_RATIO * dist["bf16 vs f32"])
    log(f"serve S3 (b) {S3_ARCH} B={SERVE_BATCH} prompt={S3_PROMPT}, "
        f"{SERVE_NEW_TOKENS} decode steps on the bf16 cache's greedy "
        f"tokens: int8 vs fp cache, the largest |diff| over the reference's "
        f"allowance bar * (1 + |ref|) (bars {S3_BARS}; within at most 1): "
        + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
        + f"; bf16 int8 vs f32 {dist['bf16 int8 vs f32']:.3e}, bf16 vs "
        f"f32 {dist['bf16 vs f32']:.3e} of the largest logit (bar: at most "
        f"{S3_BF16_RATIO}x); first greedy token equal {first_equal}; decode "
        f"argmax agree {agree}/{SERVE_BATCH * SERVE_NEW_TOKENS}; (c) cache "
        f"bytes int8 {bytes_q8} vs bf16 {bytes_fp}: "
        f"{bytes_q8 / bytes_fp:.4f} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("serve S3: the int8 cache misses its bars, the "
                             "first greedy token or opt_pad_heads' bits")
    del runs
    torch.cuda.empty_cache()
    record = {"init": init, "generate": served[S3_PROMPT],
              "int8_vs_fp_share": shares, "dist_to_f32": dist,
              "first_token_equal": first_equal, "decode_argmax_agree": agree,
              "cache_bytes": {"bf16": bytes_fp, "int8": bytes_q8,
                              "ratio": bytes_q8 / bytes_fp},
              "timing": times, "pad_heads_bitwise": same,
              "seconds": time.perf_counter() - t_phase}
    log(f"serve S3: {record['seconds']:.1f} s")
    return {f"{S3_ARCH} int8 prompt {S3_PROMPT}":
            served[S3_PROMPT]["launches"]}, record


# --------------------------------------------------------------------------
# hymba-1.5b (S6), whisper-small and pixtral-12b (S7) at full width and
# depth, through K2 at shapes it had not had
# --------------------------------------------------------------------------
S67_PROMPTS = {"hymba-1.5b": (32, 2048), "whisper-small": (32, 448),
               "pixtral-12b": (32, 2048)}
# K2's shapes on the S6-S7 path (as S2_ATTN_CASES): hymba's local and
# global layers over 2,048 tokens + 128 meta tokens (groups of 5),
# whisper's encoder (non-causal over 1,500 frames, f32 by the promotion of
# its f32 frames) and decoder, pixtral over 1,024 patches + 2,048 tokens
# (groups of 4)
S67_ATTN_CASES = (
    ("hymba-1.5b local, prompt 2048 + 128 meta", "bfloat16", 4, 25, 5,
     2176, 64, True, 1024, None),
    ("hymba-1.5b global, prompt 2048 + 128 meta", "bfloat16", 4, 25, 5,
     2176, 64, True, None, None),
    ("whisper-small encoder, 1500 frames", "float32", 4, 12, 12, 1500, 64,
     False, None, None),
    ("whisper-small decoder, prompt 32", "bfloat16", 4, 12, 12, 32, 64,
     True, None, None),
    ("whisper-small decoder, prompt 448", "bfloat16", 4, 12, 12, 448, 64,
     True, None, None),
    ("pixtral-12b, 1024 patches + prompt 2048", "bfloat16", 4, 32, 8, 3072,
     128, True, None, None),
)
# hymba's selective scan and mamba branch at its prefill shape (B, S, D, N)
HYMBA_SCAN_SHAPE = (4, 2176, 1600, 16)


def time_hymba_scan(model, params) -> dict:
    """hymba's selective scan (plain PyTorch, as the reference's
    associative scan) and its whole mamba branch at the prefill's shape,
    on CUDA events: one layer's, and times n_layers for a prefill."""
    import torch

    from repro_torch.models import ssm
    from repro_torch.models.layers import layer_slice

    b, s, d, n = HYMBA_SCAN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(8)
    a = torch.rand((b, s, d, n), generator=gen, device="cuda")
    bx = torch.randn((b, s, d, n), generator=gen, device="cuda")
    h0 = torch.zeros((b, d, n), device="cuda")
    scan_ms = cuda_ms(lambda: ssm.selective_scan(a, bx, h0), 3, warmup=1)
    del a, bx
    x = torch.randn((b, s, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    p = layer_slice(params["blocks"]["mamba"], 0)
    mamba_ms = cuda_ms(lambda: ssm.mamba_apply(x, p, model.cfg), 3,
                       warmup=1)
    layers = model.cfg.n_layers
    row = {"shape": list(HYMBA_SCAN_SHAPE), "scan_ms": scan_ms,
           "mamba_ms": mamba_ms, "scan_ms_per_prefill": scan_ms * layers,
           "mamba_ms_per_prefill": mamba_ms * layers}
    log(f"serve S6-S7 hymba selective scan at {HYMBA_SCAN_SHAPE}: "
        f"{scan_ms:.3f} ms a layer, {scan_ms * layers:.1f} ms a prefill; "
        f"the mamba branch {mamba_ms:.3f} ms a layer, "
        f"{mamba_ms * layers:.1f} ms a prefill")
    torch.cuda.empty_cache()
    return row


def serve_s6_s7(attn_ops) -> tuple:
    """The "serve S6-S7" phase: (a) K2 at the new shapes
    (`check_attention_cases`); then hymba-1.5b, whisper-small and
    pixtral-12b at full width and depth in bf16 from seeded random
    weights, each freed before the next (init peak recorded): (b)
    `Engine.generate` at B = 4 with `S67_PROMPTS` (whisper with 1,500
    frames, pixtral with 1,024 patches) and 32 new tokens, K2 n_layers
    (+ n_enc_layers) launches a generate; (c) the kernel route against
    the plain route at the short prompt, prefill(S) + decode against
    prefill(S + 1) at both, at BF16_LOGIT_BAR; (d) prefill and decode ms,
    launches, device busy time and idle share, K2's device ms inside the
    prefill; hymba's scan timed; then (e) the reduced models on the card
    against the CPU. Returns (K2 launches by run, the record)."""
    import torch

    t_phase = time.perf_counter()
    seconds = {}

    def mark(part: str) -> None:
        torch.cuda.synchronize()
        seconds[part] = time.perf_counter() - t_phase - sum(seconds.values())

    record = {"attention": check_attention_cases("serve S6-S7 (a)",
                                                 S67_ATTN_CASES),
              "models": {},
              "seconds": seconds}
    mark("(a)")
    launches = {}
    for arch, prompts in S67_PROMPTS.items():
        model, params, init = build_served(arch)
        cfg = model.cfg
        per = cfg.n_layers + cfg.n_enc_layers
        served = run_serve_main_path(
            attn_ops, model, params, kernel="flash_attention",
            per_generate=per, prompts=prompts)
        routes = {**check_serve_routes(model, params, prompts[:1]),
                  **check_serve_routes(model, params, prompts[1:],
                                       plain=False)}
        times = serve_timing(model, params, "flash_attention", prompts)
        rows = {"init": init}
        for s in prompts:
            key = f"B={SERVE_BATCH} prompt {s}"
            rows[key] = {**served[s], **routes[s], **times[s]}
            launches[f"{arch} {key}"] = served[s]["launches"]
        if model.kind == "hymba":
            rows["scan"] = time_hymba_scan(model, params)
        record["models"][arch] = rows
        del model, params
        torch.cuda.empty_cache()
        mark(f"(b)-(d) {arch}")
    record["card_vs_cpu"] = check_s2_card_vs_cpu(
        attn_ops, [(a, {}) for a in S67_PROMPTS], phase="serve S6-S7 (e)")
    mark("(e)")
    log(f"serve S6-S7: seconds by part {json.dumps(seconds)}")
    return launches, record


# --------------------------------------------------------------------------
# MoE and MLA (S4, S5): llama4-maverick-400b-a17b and deepseek-v3-671b at
# full width with their depth cut, maverick's attention through K2
# --------------------------------------------------------------------------
# the layers kept of each: maverick's first (local dense, global MoE)
# pair of 48 layers (18.55 B parameters, 37.1 GB in bf16: two pairs would
# take 70.1 GB), deepseek-v3's three dense layers and one MoE layer of 61
# (14.39 B with its MTP head, 28.8 GB)
S45_LAYERS = {"llama4-maverick-400b-a17b": 2, "deepseek-v3-671b": 4}
# maverick also at B = 1 over 16,384 tokens, where its dense layers'
# 8,192 window masks keys in prefill and decode
S45_LONG_PROMPT = {"llama4-maverick-400b-a17b": 16384}
# K2's shapes on maverick's path (as S2_ATTN_CASES): 40 query heads over 8
# kv heads at head_dim 128; its dense layers pass the window, which bites
# only past 8,192 positions
S45_ATTN_CASES = (
    ("maverick dense (window 8192), prompt 2048", "bfloat16", 4, 40, 8,
     2048, 128, True, 8192, None),
    ("maverick MoE layer (global), prompt 2048", "bfloat16", 4, 40, 8,
     2048, 128, True, None, None),
    ("maverick dense (window 8192), B=1 prompt 16384", "bfloat16", 1, 40,
     8, 16384, 128, True, 8192, None),
)
# (e) the reference's decode-vs-prefill bars (atol, with rtol 1e-2;
# tests/test_decode_consistency.py), dropless: a grouped prefill and a
# one-token decode drop tokens differently by design
S45_DECODE_BARS = {"llama4-maverick-400b-a17b": 5e-3,
                   "deepseek-v3-671b": 2e-2}
S45_DROPLESS = 100.0
# (d) reduced f32 models, the card against the CPU, of the largest logit
S45_CPU_BAR = 1e-5


@contextlib.contextmanager
def recorded_routing(replay=None):
    """Records every MoE layer's routing (`models.moe.route`, which
    `moe_apply` looks up at each call) while the block runs: a list of
    ((dispatch (G, Tg, E, C) bool, combine, aux), top_k). With `replay`,
    such a list recorded before, each call returns the recorded routing
    of its turn instead of routing its own tokens."""
    from repro_torch.models import moe

    real, seen = moe.route, []

    def route(xg, p, cfg):
        out = real(xg, p, cfg) if replay is None else replay[len(seen)][0]
        seen.append((out, cfg.top_k))
        return out

    moe.route = route
    try:
        yield seen
    finally:
        moe.route = real


def _drop_shares(seen) -> list:
    """Each MoE layer's share of token-slots (tokens × top_k) that
    capacity dropped."""
    return [1.0 - d.sum().item() / (d.shape[0] * d.shape[1] * k)
            for (d, _, _), k in seen]


def check_s45_routes(model, params, prompts: tuple, batch: int,
                     plain: bool = True) -> dict:
    """(c) At each prompt length the bf16 prefill's logits are finite and
    each MoE layer's dropped share of token-slots is printed; with
    `plain`, the kernel route against the plain route (`impl="ref"`): a
    token whose chosen experts differ between the two routes in any MoE
    layer (a near-tie that the routes' bf16 roundings tip apart, or a
    slot that a flip upstream in its group took or freed) is counted as
    flipped, and the logits are held at BF16_LOGIT_BAR over the batch
    rows where no token flipped; and over every row, against the plain
    route given the kernel route's routing (its dispatch, combine weights
    and aux replayed), so the two differ by their attention alone."""
    import torch

    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import build_segments

    cfg = model.cfg
    ref_model = build_model(cfg, impl="ref") if plain else None
    n_moe = sum(seg.n_steps * sum(sub.kind == "moe" for sub in seg.subs)
                for seg in build_segments(cfg))

    def recorded_all(name, seen):
        # the patched `moe.route` saw each MoE layer once, or the shares,
        # flips and replay below would stand on nothing
        if len(seen) != n_moe:
            raise AssertionError(
                f"serve S4-S5 (c) {cfg.arch_id}: {name} recorded "
                f"{len(seen)} MoE routings, the model has {n_moe} MoE "
                "layers")

    out = {}
    for s in prompts:
        inputs = _serve_batch(cfg, s, seed=2, batch=batch)
        with recorded_routing() as seen:
            ker, _ = model.prefill(params, inputs, s + 1)
        recorded_all("the kernel route", seen)
        row = {"drop_share": _drop_shares(seen),
               "finite": bool(torch.isfinite(ker).all())}
        ok, msg = row["finite"], ""
        if plain:
            with recorded_routing() as seen_ref:
                ref, _ = ref_model.prefill(params, inputs, s + 1)
            recorded_all("the plain route", seen_ref)
            with recorded_routing(replay=seen) as seen_pinned:
                pinned, _ = ref_model.prefill(params, inputs, s + 1)
            recorded_all("the replayed plain route", seen_pinned)
            flipped = torch.zeros((batch, s), dtype=torch.bool,
                                  device=ker.device)
            for ((a, _, _), _), ((b, _, _), _) in zip(seen, seen_ref):
                flipped |= (a.any(-1) != b.any(-1)).any(-1).reshape(batch, s)
            rows = ~flipped.any(-1)
            row["flipped_tokens"] = int(flipped.sum())
            row["rows_held"] = int(rows.sum())
            row["routes_rel"] = _rel_to_max(ker[rows], ref[rows]) \
                if rows.any() else None
            row["routes_pinned_rel"] = _rel_to_max(ker, pinned)
            ok = ok and row["routes_pinned_rel"] <= BF16_LOGIT_BAR and (
                row["routes_rel"] is None
                or row["routes_rel"] <= BF16_LOGIT_BAR)
            rel = "none held" if row["routes_rel"] is None \
                else f"{row['routes_rel']:.3e}"
            msg = (f"; kernel vs plain route: {row['flipped_tokens']} of "
                   f"{batch * s} tokens routed differently, logits over the "
                   f"{row['rows_held']} rows without one max|diff|/max|logit|"
                   f" {rel}, over all rows with the kernel route's routing "
                   f"replayed {row['routes_pinned_rel']:.3e} (bar "
                   f"{BF16_LOGIT_BAR})")
        log(f"serve S4-S5 (c) {cfg.arch_id} B={batch} prompt={s}: logits "
            f"finite {row['finite']}; capacity dropped "
            + ", ".join(f"{x:.4f}" for x in row["drop_share"])
            + f" of each MoE layer's token-slots{msg} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"serve S4-S5 (c) {cfg.arch_id} prompt={s}")
        out[s] = row
    return out


def time_s45_layers(model, params, s: int = 2048) -> dict:
    """The prefill's sublayers alone at (B = 4, `s`) on bf16 standard-
    normal inputs, CUDA events: each kind of attention (K2 with and
    without the window, or MLA's plain prefill) and feed-forward (the
    dense MLP, the MoE layer with its routing), ms a call and a prefill's
    worth (times the layers that run it)."""
    import torch

    from repro_torch.models import attention, mla, moe
    from repro_torch.models.layers import layer_slice, mlp_apply
    from repro_torch.models.transformer import build_segments

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((SERVE_BATCH, s, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    pos = torch.arange(s, device="cuda")
    rows = {}
    for i, seg in enumerate(build_segments(cfg)):
        for j, sub in enumerate(seg.subs):
            sp = layer_slice(params["segments"][f"seg{i}"][f"sub{j}"], 0)
            if cfg.use_mla:
                name = "attention: MLA prefill (plain)"
                attn = lambda: mla.mla_apply(  # noqa: E731
                    x, sp["attn"], cfg, positions=pos)
            else:
                name = f"attention: K2, window {sub.window}"
                attn = lambda: attention.attn_apply(  # noqa: E731
                    x, sp["attn"], cfg, positions=pos, window=sub.window)
            if sub.kind == "moe":
                ffn_name = "MoE layer (routing, dispatch, experts, combine)"
                ffn = lambda: moe.moe_apply(x, sp["moe"], cfg)  # noqa: E731
            else:
                ffn_name = "dense MLP"
                ffn = lambda: mlp_apply(x, sp["mlp"], cfg)  # noqa: E731
            for key, fn in ((name, attn), (ffn_name, ffn)):
                if key not in rows:
                    rows[key] = {"ms": cuda_ms(fn, 3, warmup=1), "layers": 0}
                rows[key]["layers"] += seg.n_steps
    for row in rows.values():
        row["ms_per_prefill"] = row["ms"] * row["layers"]
    log(f"serve S4-S5 (b) {cfg.arch_id} sublayers at B={SERVE_BATCH}, "
        f"S={s}: " + "; ".join(f"{k} {r['ms']:.3f} ms x {r['layers']}"
                                for k, r in rows.items()))
    del x
    torch.cuda.empty_cache()
    return rows


def check_s45_card_vs_cpu(attn_ops) -> dict:
    """(d) Each reduced model in f32 from one CPU initialization: prefill
    past maverick's reduced window of 16 (S2_CPU_PROMPT tokens) and
    S2_CPU_STEPS decode steps on the card (K2's f32 kernel for maverick;
    MLA is plain PyTorch on both) against the CPU, logits within
    S45_CPU_BAR of the largest, with the configs' own capacity; (e) on
    the card, dropless (S45_DROPLESS), prefill(S) + decode against
    prefill(S + 1) at the reference's bars (`S45_DECODE_BARS`, rtol 1e-2)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model

    out = {}
    for arch in S45_LAYERS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        cpu_params = model.init_params(device="cpu")
        cuda_params = _tree_map(lambda x: x.cuda(), cpu_params)
        max_len = S2_CPU_PROMPT + S2_CPU_STEPS
        t = _serve_batch(cfg, max_len, seed=4, batch=2,
                         device="cpu")["tokens"]
        runs = {}
        attn_ops.launch_count = 0
        for dev, params in (("cuda", cuda_params), ("cpu", cpu_params)):
            td = t.to(dev)
            logits, cache = model.prefill(
                params, {"tokens": td[:, :S2_CPU_PROMPT]}, max_len)
            seq = [logits.cpu()]
            for i in range(S2_CPU_STEPS):
                pos = S2_CPU_PROMPT + i
                logits, cache = model.decode_step(params, cache, td[:, pos],
                                                  pos)
                seq.append(logits.cpu())
            runs[dev] = seq
            if dev == "cuda":
                launches = attn_ops.launch_count
        worst = max(_rel_to_max(a, b) for a, b in zip(runs["cuda"],
                                                      runs["cpu"]))
        dropless = build_model(cfg.with_(capacity_factor=S45_DROPLESS))
        td = t.cuda()
        _, cache = dropless.prefill(
            cuda_params, {"tokens": td[:, :S2_CPU_PROMPT]}, max_len)
        inc, _ = dropless.decode_step(cuda_params, cache,
                                      td[:, S2_CPU_PROMPT], S2_CPU_PROMPT)
        full, _ = dropless.prefill(
            cuda_params, {"tokens": td[:, :S2_CPU_PROMPT + 1]}, max_len)
        bar = S45_DECODE_BARS[arch]
        excess = ((inc - full).abs() - 1e-2 * full.abs()).max().item()
        expected = 0 if cfg.use_mla else cfg.n_layers
        ok = (worst <= S45_CPU_BAR and excess <= bar
              and launches == expected)
        log(f"serve S4-S5 (d)-(e) reduced {arch} f32: card vs CPU logits "
            f"over the prefill ({S2_CPU_PROMPT} tokens) and {S2_CPU_STEPS} "
            f"decode steps {worst:.3e} of the largest (bar {S45_CPU_BAR}); "
            f"K2 {launches} launches on the card (expected {expected}); "
            f"dropless prefill({S2_CPU_PROMPT}) + decode vs prefill("
            f"{S2_CPU_PROMPT + 1}): max(|diff| - 1e-2|ref|) {excess:.3e} "
            f"(bar {bar}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"serve S4-S5 (d)-(e) {arch}")
        out[arch] = {"card_vs_cpu": worst, "decode_excess": excess,
                     "launches": launches}
    return out


def serve_s4_s5(attn_ops) -> tuple:
    """The "serve S4-S5" phase: (a) K2 at maverick's shapes
    (`check_attention_cases`); then llama4-maverick-400b-a17b (2 of 48
    layers) and deepseek-v3-671b (4 of 61) at full width in bf16 from
    seeded random weights, each freed before the next (init peak
    recorded): (b) `Engine.generate` at B = 4 with 32- and 2048-token
    prompts and 32 new tokens (maverick also at B = 1 with 16,384), K2
    launches a generate: one a layer of maverick's prefill, none of
    deepseek-v3's (MLA is plain PyTorch); prefill and decode ms, launches,
    device busy time and idle share, K2's device ms; the sublayers alone
    (`time_s45_layers`); (c) `check_s45_routes` (maverick's kernel route
    against its plain route at B = 4); then (d)-(e)
    `check_s45_card_vs_cpu`.
    Returns (K2 launches by run, the record)."""
    import torch

    t_phase = time.perf_counter()
    seconds = {}

    def mark(part: str) -> None:
        torch.cuda.synchronize()
        seconds[part] = time.perf_counter() - t_phase - sum(seconds.values())

    record = {"attention": check_attention_cases("serve S4-S5 (a)",
                                                 S45_ATTN_CASES),
              "models": {}, "seconds": seconds}
    mark("(a)")
    launches = {}
    for arch, n_layers in S45_LAYERS.items():
        model, params, init = build_served(arch, n_layers=n_layers)
        cfg = model.cfg
        per = 0 if cfg.use_mla else cfg.n_layers
        runs = [(SERVE_PROMPTS, SERVE_BATCH)]
        if arch in S45_LONG_PROMPT:
            runs.append(((S45_LONG_PROMPT[arch],), 1))
        rows = {"init": init, "layers_kept": n_layers}
        for prompts, batch in runs:
            served = run_serve_main_path(
                attn_ops, model, params, kernel="flash_attention",
                per_generate=per, prompts=prompts, batch=batch)
            # deepseek-v3's path runs no kernel: its two routes are one
            routes = check_s45_routes(
                model, params, prompts, batch,
                plain=batch == SERVE_BATCH and not cfg.use_mla)
            times = serve_timing(model, params, "flash_attention", prompts,
                                 batch)
            for s in prompts:
                key = f"B={batch} prompt {s}"
                rows[key] = {**served[s], **routes[s], **times[s]}
                launches[f"{arch} {key}"] = served[s]["launches"]
        rows["sublayers"] = time_s45_layers(model, params)
        record["models"][arch] = rows
        del model, params
        torch.cuda.empty_cache()
        mark(f"(b)-(c) {arch}")
    record["card_vs_cpu"] = check_s45_card_vs_cpu(attn_ops)
    mark("(d)-(e)")
    log(f"serve S4-S5: seconds by part {json.dumps(seconds)}")
    return launches, record


# --------------------------------------------------------------------------
# training over the MAC (T1-T3): K2 with its log-sum-exp, the flash
# backward, and repro-100m trained at full width and depth
# --------------------------------------------------------------------------
TRAIN_ARCH = "repro-100m"
# the training launcher's defaults (src/repro/launch/train.py:37-48)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_NODES = 8, 256, 8
TRAIN_NOISE_STD, TRAIN_LR, TRAIN_GAMMA = 0.01, 0.05, 0.9
# 2 steps a route (cut from 4, then 3, to keep the script inside its
# 1,200 s time limit as the phases grew; the timing takes the best of 2)
TRAIN_STEPS = 2
# (aggregator, route): the fused gbma route, gbma through the transport,
# and receiver momentum through the transport
TRAIN_ROUTES = (("gbma", "auto"), ("gbma", "transport"),
                ("momentum", "transport"))
# the routes whose step (d) profiles: the fused route only (a transport
# step's profile cost ~20 s of profiler overhead on an H100; PERF.md keeps
# the transport profiles from an earlier run: 30,046 and 30,068 launches
# a step)
TRAIN_PROFILED = ("gbma fused",)
# K2 at repro-100m's training shape (B, H, S, d), f32, causal
TRAIN_ATTN_SHAPE = (8, 10, 256, 64)
TRAIN_LSE_BAR = (1e-5, 1e-6)  # atol + rtol * |lse|
# (b): flash_attention's gradients against full_attention's autograd, at
# tests/test_flash_vjp.py's bars, at the training shape and at the
# reference's GQA + window + softcap case with d = 32 (K2 takes head_dim
# 32, 64, 128, 256; the reference case has 16)
TRAIN_VJP_CASES = ((8, 10, 10, 256, 64, {}),
                   (1, 2, 1, 128, 32, {"window": 40, "softcap": 25.0}))
TRAIN_VJP_BARS = {"out": (2e-5, 1e-4), "grad": (5e-4, 5e-3)}
# the kernel route against the plain route after TRAIN_STEPS steps, and
# the card against the CPU on the reduced config: losses relative,
# parameters relative to each leaf's largest |p|
TRAIN_ROUTE_BAR = 1e-5


# per dtype: the kernel's output bar (atol, rtol), its training shape
# (B, H, S, d) and the label its lines carry
LSE_CASES = {"float32": ((5e-5, 1e-4), TRAIN_ATTN_SHAPE, "train (a) K2"),
             "bfloat16": ((3e-2, 0.0), (8, 16, 256, 128),
                          "train models (f) K2 bf16")}


def check_attention_lse(dtype_name: str = "float32") -> dict:
    """(a), and (f) in bf16: K2's kernel of `dtype_name` with `lse`
    against its plain version at the reference tests' cases and the
    training shape: `out` at the dtype's bar (f32: atol 5e-5 + rtol
    1e-4; bf16: atol 3e-2), `lse` within 1e-5 + 1e-6·|lse|; a launch
    without `lse` gives the bits of a launch with it there and at the
    dtype's serving shapes. Returns the max abs errors of out and lse."""
    import torch

    from repro_torch.kernels.attention.ops import multi_head_attention

    (atol, rtol), (tb, th, ts, td), label = LSE_CASES[dtype_name]
    dtype = getattr(torch, dtype_name)
    shapes = [*ATTN_TEST_SHAPES, (tb, th, th, ts, td, {})]
    worst = {"out": 0.0, "lse": 0.0}
    for i, (b, hq, hkv, s, d, kw) in enumerate(shapes):
        q, k, v = attn_inputs(b, hq, hkv, s, d, dtype,
                              (300 if dtype_name == "float32" else 400) + i)
        scale = d ** -0.5
        out, lse = multi_head_attention(q, k, v, scale=scale,
                                        return_lse=True, **kw)
        ref, ref_lse = multi_head_attention(q, k, v, scale=scale,
                                            impl="ref", return_lse=True,
                                            **kw)
        bare = multi_head_attention(q, k, v, scale=scale, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        lse_err = (lse - ref_lse).abs()
        ok = bool(torch.isfinite(out).all() and torch.isfinite(lse).all()
                  and (err <= atol + rtol * ref.float().abs()).all()
                  and (lse_err <= TRAIN_LSE_BAR[0]
                       + TRAIN_LSE_BAR[1] * ref_lse.abs()).all())
        same = torch.equal(bare, out)
        worst["out"] = max(worst["out"], err.max().item())
        worst["lse"] = max(worst["lse"], lse_err.max().item())
        log(f"{label} with lse q{(b, hq, s, d)} kv{(b, hkv, s, d)} "
            f"{kw}: out max_abs_err={err.max().item():.3e}, lse "
            f"max_abs_err={lse_err.max().item():.3e} (bar "
            f"{TRAIN_LSE_BAR[0]} + {TRAIN_LSE_BAR[1]}|lse|), without lse "
            f"== with lse bitwise: {same} {'ok' if ok and same else 'FAIL'}")
        if not (ok and same):
            raise AssertionError(f"K2 {dtype_name} with lse at "
                                 f"{(b, hq, hkv, s, d, kw)}")
    for b, h, s, d, dt in ATTN_SLICE_SHAPES:
        if dt != dtype_name:
            continue
        q, k, v = attn_inputs(b, h, h, s, d, dtype, s + d)
        bare = multi_head_attention(q, k, v, scale=d ** -0.5)
        out, _ = multi_head_attention(q, k, v, scale=d ** -0.5,
                                      return_lse=True)
        same = torch.equal(bare, out)
        log(f"{label} serving shape {(b, h, s, d)} {dtype_name}: without "
            f"lse == with lse bitwise: {same}")
        if not same:
            raise AssertionError("K2's lse launch changed the output bits")
    return worst


def check_flash_vjp() -> dict:
    """(b) `flash_attention` (K2's forward with lse, the flash backward)
    against autograd through `full_attention` on the card. Returns the
    max abs error of the gradients per case."""
    import torch

    from repro_torch.models.attention import full_attention
    from repro_torch.models.flash_vjp import flash_attention

    out_errs = {}
    for b, hq, hkv, s, d, kw in TRAIN_VJP_CASES:
        q, k, v = attn_inputs(b, hq, hkv, s, d, torch.float32, 41)
        t = torch.randn_like(q)
        runs = []
        for fn in (lambda *a: flash_attention(
                *a, scale=d ** -0.5, block_q=128, block_kv=256,
                impl="kernel", **kw),
                   lambda *a: full_attention(*a, scale=d ** -0.5, **kw)):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = fn(*leaves)
            (out * t).sum().backward()
            runs.append((out.detach(), [x.grad for x in leaves]))
        torch.cuda.synchronize()
        ok, errs = True, []
        for (a, b_), bar in [((runs[0][0], runs[1][0]),
                              TRAIN_VJP_BARS["out"])] + [
                ((x, y), TRAIN_VJP_BARS["grad"])
                for x, y in zip(runs[0][1], runs[1][1])]:
            err = (a - b_).abs()
            errs.append(err.max().item())
            ok = ok and bool(torch.isfinite(a).all()
                             and (err <= bar[0] + bar[1] * b_.abs()).all())
        log(f"train (b) flash_attention vs full_attention autograd "
            f"q{(b, hq, s, d)} kv{(b, hkv, s, d)} {kw}: max_abs_err out "
            f"{errs[0]:.3e}, dq {errs[1]:.3e}, dk {errs[2]:.3e}, dv "
            f"{errs[3]:.3e} (bars {TRAIN_VJP_BARS}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_attention's gradients disagree")
        out_errs[f"{(b, hq, hkv, s, d)} {kw}"] = max(errs[1:])
    return out_errs


def _train_parts(cfg, aggregator: str, route: str, impl: str,
                 rng_impl: str = "threefry2x32"):
    """(model, TrainConfig, optimizer, train step) as the launcher builds
    them at its defaults (`route` 'auto' for the fused aggregators,
    'transport' for the rest), with keys of kind `rng_impl`;
    `impl='ref'` takes the plain attention and, on the transport route,
    the plain OTA route."""
    from repro_torch.core import transport
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.gbma import GBMAConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim.gd import get_optimizer
    from repro_torch.training.train_step import (TrainConfig,
                                                 build_train_step)

    ch = ChannelConfig(fading="rayleigh", noise_std=TRAIN_NOISE_STD,
                       energy=1.0)
    tp = None
    if route == "transport":
        tp = transport.TransportConfig(
            n_nodes=TRAIN_NODES, channel=ch, gamma=TRAIN_GAMMA,
            stepsize=TRAIN_LR, ota_impl="ref" if impl == "ref" else "auto")
    tcfg = TrainConfig(aggregator=aggregator,
                       gbma=GBMAConfig(n_nodes=TRAIN_NODES, channel=ch),
                       route=route, transport=tp, rng_impl=rng_impl)
    model = build_model(cfg, impl=impl)
    opt = get_optimizer("momentum", TRAIN_LR)
    return model, tcfg, opt, build_train_step(model, tcfg, opt)


def train_seq(cfg) -> int:
    """The launcher's `--seq` a model trains at: TRAIN_SEQ tokens, after a
    VLM's patches (pixtral-12b: 1,024 + 256)."""
    return TRAIN_SEQ + cfg.n_patches


def _train_batches(cfg, steps: int) -> list:
    """The launcher's first `steps` batches (`launch.train.train_batches`:
    tokens, a VLM's zero patch embeddings, an encoder-decoder's zero f32
    frames) as host arrays."""
    from repro_torch.launch.train import train_batches

    it = train_batches(cfg, TRAIN_BATCH, train_seq(cfg))
    return [next(it) for _ in range(steps)]


def _on_card(batch: dict) -> dict:
    import torch

    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _train_run(cfg, aggregator, route, impl, params0, batches,
               rng_impl: str = "threefry2x32"):
    """`run_training` over `batches` from a copy of `params0`: (logged
    losses, final params, history, K2 and K1 launches of the run)."""
    import torch

    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ota import ops as ota_ops
    from repro_torch.training.loop import run_training

    _, _, _, step = _train_parts(cfg, aggregator, route, impl, rng_impl)
    params = tree_map(lambda p: p.clone(), params0)
    state = step.init_state(params)
    attn_ops.launch_count = ota_ops.launch_count = 0
    params, _, hist = run_training(step, params, state, iter(batches),
                                   len(batches), log_every=1)
    if tree_leaves(params0)[0].is_cuda:
        torch.cuda.synchronize()
    launches = (attn_ops.launch_count, ota_ops.launch_count)
    return [h["loss"] for h in hist], params, hist, launches


def train_step_split(cfg, aggregator, route, params, batch,
                     profile: bool) -> dict:
    """(d) One step of a route at full width, timed on the host clock
    (best of 2 whole and forward plus backward, best of 3 the other
    parts, each ending in a synchronize) whole and by part: the
    forward plus backward (`gbma_value_and_grad` with the node weights,
    or the per-node gradients), the edge noise (fused gbma) or the slot
    (`transport.aggregate`), the clip with the optimizer's update; the
    step's peak device memory over the resident parameters and
    optimizer state; the host synchronizations inside a step (torch's
    sync debug mode); and, with `profile`, a torch.profiler count of one
    step."""
    import warnings

    import torch

    from repro_torch.core import rng, transport
    from repro_torch.core.gbma import (gbma_value_and_grad, node_weights,
                                       perturb_gradients)
    from repro_torch.training.train_step import (_clip_and_metrics,
                                                 _node_grads_fn)

    model, tcfg, opt, step = _train_parts(cfg, aggregator, route, "auto")
    state = step.init_state(params)
    fused = tcfg.transport is None
    k_h, k_w = rng.split(rng.fold_in(rng.key(0, device="cuda"), 0))
    row = {"step_ms": _best_ms(lambda: step(params, state, batch, 0), 2)}
    if fused:
        vg = gbma_value_and_grad(
            lambda p, b: model.train_loss_per_example(p, b)[0])
        w = node_weights(k_h, tcfg.gbma, TRAIN_BATCH)
        row["forward_backward_ms"] = _best_ms(lambda: vg(params, batch, w),
                                              2)
        _, grads = vg(params, batch, w)
        row["noise_ms"] = _best_ms(
            lambda: perturb_gradients(grads, k_w, tcfg.gbma))
    else:
        grads_fn = _node_grads_fn(model, TRAIN_NODES)
        row["forward_backward_ms"] = _best_ms(
            lambda: grads_fn(params, batch), 2)
        _, node_g = grads_fn(params, batch)
        agg = state[1] if transport.has_state(aggregator) else None
        row["slot_ms"] = _best_ms(lambda: transport.aggregate(
            aggregator, node_g, k_w, tcfg.transport, agg))
        grads, _, _ = transport.aggregate(aggregator, node_g, k_w,
                                          tcfg.transport, agg)
        del node_g
    opt_state = state[0] if isinstance(state, tuple) else state

    def update():
        g, _ = _clip_and_metrics(grads, tcfg)
        return opt.update(g, opt_state, params)

    row["clip_and_optimizer_ms"] = _best_ms(update)
    del grads
    _, row["peak_mib_over_resident"] = _peak_mib(
        lambda: step(params, state, batch, 0))
    # operations that synchronize the host with the card inside a step
    # (torch's sync debug mode warns at each)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(params, state, batch, 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    row["host_syncs_in_step"] = len(syncs)
    if syncs:
        log(f"train (d) a step synchronizes the host: {syncs[:3]}")
    if not profile:
        return row
    prof = _profile_counts(lambda: step(params, state, batch, 0),
                           kernel="flash_attention")
    row["profile"] = {"launches": prof["launches"], "syncs": prof["syncs"],
                      "device_busy_ms": prof["device_us"] / 1e3,
                      "device_idle_share": 1.0 - prof["device_us"] / 1e3
                      / row["step_ms"],
                      "flash_attention_kernels": prof["kernel"],
                      "flash_attention_device_ms": prof["kernel_us"] / 1e3}
    return row


def time_train_attention(dtype_name: str = "float32") -> dict:
    """(d), and (f) in bf16: K2's kernel of `dtype_name` at its training
    shape: the bare launch with and without `lse`, the plain version
    with lse, SDPA, the bound; in f32 also the flash backward (plain
    PyTorch, `block_q` 128 x `block_kv` 256) per call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ops import multi_head_attention
    from repro_torch.models.flash_vjp import flash_backward

    _, shape, label = LSE_CASES[dtype_name]
    b, h, s, d = shape
    q, k, v = attn_inputs(b, h, h, s, d, getattr(torch, dtype_name), 7)
    scale = d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s), dtype=torch.float32, device="cuda")
    launch = dict(scale=scale, causal=True, window=None, softcap=None)
    row = {"shape": list(shape), "dtype": dtype_name,
           "lse_ms": cuda_ms(lambda: kernel.launch(q, k, v, out, lse=lse,
                                                   **launch), 200),
           "ms": cuda_ms(lambda: kernel.launch(q, k, v, out, **launch),
                         200),
           "plain_ms": cuda_ms(lambda: multi_head_attention(
               q, k, v, scale=scale, impl="ref", return_lse=True), 50),
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, scale=scale), 200)}
    bound, bound_by = attention_bound(b, h, s, d, dtype_name)
    # the lse launch also writes B·H·S f32 values
    lse_bytes_ms = (4 * b * h * d * q.element_size() * s + 4 * b * h * s) \
        / HBM_BYTES_PER_S * 1e3
    row["bound_ms"], row["bound_by"] = bound, bound_by
    row["lse_bound_ms"] = max(bound, lse_bytes_ms)
    backward = ""
    if dtype_name == "float32":
        o, ls = multi_head_attention(q, k, v, scale=scale, return_lse=True)
        do = torch.randn_like(o)
        row["backward_ms"] = cuda_ms(lambda: flash_backward(
            q, k, v, o, ls, do, scale=scale, causal=True, window=None,
            softcap=None, q_offset=0, block_q=128, block_kv=256), 20)
        backward = f"; flash backward {row['backward_ms']:.6f} ms per call"
    log(f"{label} at {shape} {dtype_name}: with lse {row['lse_ms']:.6f} "
        f"ms, without {row['ms']:.6f} ms, plain {row['plain_ms']:.6f} ms, "
        f"SDPA {row['library_ms']:.6f} ms, bound {bound:.6f} ms "
        f"({bound_by}; with lse {row['lse_bound_ms']:.6f}){backward}")
    return row


# (f): rbg keys (T6) and unsafe_rbg keys (T7) on the fused gbma route and
# through the transport (gbma), 2 steps each at full width
TRAIN_RBG_STEPS = 2
TRAIN_RBG_ROUTES = (("gbma", "auto"), ("gbma", "transport"))
TRAIN_RBG_IMPLS = ("rbg", "unsafe_rbg")


def train_rbg(cfg, params0, batches, impl: str = "rbg") -> tuple:
    """(f) `TrainConfig(rng_impl=impl)` (rbg or unsafe_rbg) at
    repro-100m's full width: 2 steps on each route of TRAIN_RBG_ROUTES,
    the kernel route against the plain route at TRAIN_ROUTE_BAR with K2's
    and K1's launches; the transport's full-D draw (the noise key of step
    0's slot, `split(fold_in(key(0, impl), 0))[1]`, D bits) on the card
    against the CPU, bit for bit; and that draw's normals timed with CUDA
    events beside the threefry key's. Returns (K2 launches by route, K1
    launches, the record)."""
    import torch

    from repro_torch.core import rng
    from repro_torch.core.tree import tree_leaves

    n_leaves = len(tree_leaves(params0))
    n_params = sum(p.numel() for p in tree_leaves(params0))
    k2_launches, k1_launches, record = {}, 0, {"routes": {}}
    steps = len(batches)
    for aggregator, route in TRAIN_RBG_ROUTES:
        name = f"{aggregator} {'fused' if route == 'auto' else route} {impl}"
        losses, params, hist, (k2, k1) = _train_run(
            cfg, aggregator, route, "auto", params0, batches, impl)
        ref_losses, ref_params, _, ref_counts = _train_run(
            cfg, aggregator, route, "ref", params0, batches, impl)
        transport_route = route == "transport"
        per_step = cfg.n_layers * (TRAIN_NODES if transport_route else 1)
        want = (steps * per_step, steps * n_leaves if transport_route else 0)
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, ref_losses))
        param_rel = _tree_rel_to_max(params, ref_params)
        ok = (all(math.isfinite(x) for x in losses) and (k2, k1) == want
              and ref_counts == (0, 0) and loss_rel <= TRAIN_ROUTE_BAR
              and param_rel <= TRAIN_ROUTE_BAR)
        log(f"train (f) {TRAIN_ARCH} {name}, {steps} steps: losses "
            f"{losses}; K2 {k2}, K1 {k1} launches, expected {want}; plain "
            f"route {ref_counts}; kernel vs plain route losses "
            f"{loss_rel:.3e} rel, params {param_rel:.3e} of each leaf's max "
            f"(bar {TRAIN_ROUTE_BAR}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train {impl} route {name}")
        k2_launches[name] = k2
        k1_launches += k1
        record["routes"][name] = {
            "losses": losses, "plain_losses": ref_losses,
            "loss_rel": loss_rel, "param_rel_to_max": param_rel,
            "k2_launches": k2, "k1_launches": k1}
        del params, ref_params
        torch.cuda.empty_cache()

    keys = {kind: rng.split(rng.fold_in(
        rng.key(0, device="cuda", impl=kind), 0))[1]
        for kind in (impl, "threefry2x32")}
    t0 = time.perf_counter()
    card = rng.random_bits(keys[impl], (n_params,))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = rng.random_bits(keys[impl].cpu(), (n_params,))
    cpu_s = time.perf_counter() - t0
    same = bool(torch.equal(card.cpu(), cpu))
    del card, cpu
    head = 1 << 20
    z_card = rng.normal(keys[impl], (head,)).cpu()
    z_cpu = rng.normal(keys[impl].cpu(), (head,))
    z_diff = (z_card - z_cpu).abs().max().item()
    torch.cuda.empty_cache()
    draw_ms = {kind: cuda_ms(lambda k=k: rng.normal(k, (n_params,)), 3,
                             warmup=1) for kind, k in keys.items()}
    record["draw"] = {"values": n_params, "bits_equal": same,
                      "bits_card_s": card_s, "bits_cpu_s": cpu_s,
                      "normal_head_max_abs_diff": z_diff,
                      "normal_ms": draw_ms}
    log(f"train (f) the transport's full-D {impl} draw ({n_params:,} "
        f"values): card bits == CPU bits: {same} (card {card_s:.3f} s, CPU "
        f"{cpu_s:.3f} s); first {head:,} normals card vs CPU max |diff| "
        f"{z_diff:.3e}; normals of the draw {draw_ms[impl]:.3f} ms ({impl}) "
        f"against {draw_ms['threefry2x32']:.3f} ms (threefry), CUDA events")
    if not same:
        raise AssertionError(f"the card's {impl} bits differ from the CPU's")
    return k2_launches, k1_launches, record


def run_train(attn_ops, ota_ops) -> tuple:
    """The training stack on the card:

    (a) K2 with its log-sum-exp against its plain version
        (`check_attention_lse`);
    (b) `flash_attention`'s gradients against `full_attention`'s
        autograd (`check_flash_vjp`);
    (c) the launcher at its defaults (`python -m repro_torch.launch.train
        --arch repro-100m --steps 2`), then repro-100m at full width and
        depth (112,248,960 parameters, f32), 2 steps at the launcher's
        defaults through `build_train_step` + `run_training` on three
        routes (fused gbma; gbma through the transport; receiver
        momentum through the transport): finite losses, `tx_energy` on
        the transport routes, K2 14 launches a forward (N forwards a
        step on the transport route), K1 11 a slot (one a leaf); the
        kernel route against the plain route (`impl='ref'`: plain
        attention and plain OTA) after the 2 steps;
    (d) each route's step timed whole (best of 2) and by part, its peak
        memory and a profile (`train_step_split`), and K2 at the
        training shape (`time_train_attention`);
    (e) the card against the CPU on the reduced repro-100m: 2 steps of
        each route in (c);
    (f) rbg and unsafe_rbg keys (`train_rbg`).

    Returns (K2 launches, K1 launches, the record)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch import train as train_launch
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    seconds = {}

    def mark(part: str) -> None:
        torch.cuda.synchronize()
        seconds[part] = time.perf_counter() - t_phase - sum(seconds.values())

    record = {"lse_errors": check_attention_lse(),
              "vjp_grad_errors": check_flash_vjp(), "seconds": seconds}
    mark("(a), (b)")
    cfg = get_config(TRAIN_ARCH)

    # (c) the launcher as a user runs it
    attn_ops.launch_count = ota_ops.launch_count = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train_launch.main(["--arch", TRAIN_ARCH, "--steps",
                           str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    launcher_s = time.perf_counter() - t0
    text = buf.getvalue()
    final = float(text.rsplit("final loss", 1)[1].split()[0])
    launches = {"launcher gbma": attn_ops.launch_count}
    log(f"train (c) launch.train --arch {TRAIN_ARCH} --steps {TRAIN_STEPS}: "
        f"{launcher_s:.2f} s, {attn_ops.launch_count} K2 launches, final "
        f"loss {final:.4f}; output: {text.strip().splitlines()}")
    if not math.isfinite(final) or attn_ops.launch_count != \
            TRAIN_STEPS * cfg.n_layers:
        raise AssertionError("the train launcher: loss or launches")

    params0 = build_model(cfg).init_params(device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params0))
    n_leaves = len(tree_leaves(params0))
    batches = _train_batches(cfg, TRAIN_STEPS)
    k1_launches = 0
    record["routes"] = {}
    for aggregator, route in TRAIN_ROUTES:
        name = f"{aggregator} {'fused' if route == 'auto' else route}"
        losses, params, hist, (k2, k1) = _train_run(
            cfg, aggregator, route, "auto", params0, batches)
        ref_losses, ref_params, _, ref_counts = _train_run(
            cfg, aggregator, route, "ref", params0, batches)
        transport_route = route == "transport"
        per_step = cfg.n_layers * (TRAIN_NODES if transport_route else 1)
        want = (TRAIN_STEPS * per_step,
                TRAIN_STEPS * n_leaves if transport_route else 0)
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, ref_losses))
        param_rel = _tree_rel_to_max(params, ref_params)
        tx_ok = not transport_route or all(
            math.isfinite(h["tx_energy"]) and h["tx_energy"] > 0
            for h in hist)
        ok = (all(math.isfinite(x) for x in losses) and tx_ok
              and (k2, k1) == want and ref_counts == (0, 0)
              and loss_rel <= TRAIN_ROUTE_BAR
              and param_rel <= TRAIN_ROUTE_BAR)
        log(f"train (c) {TRAIN_ARCH} ({n_params:,} parameters, "
            f"{n_leaves} leaves) {name}, {TRAIN_STEPS} steps: losses "
            f"{losses}, tx_energy "
            f"{[h.get('tx_energy') for h in hist]}; K2 {k2} launches "
            f"({per_step} a step), K1 {k1} ({n_leaves} a slot), expected "
            f"{want}; plain route {ref_counts}; kernel vs plain route "
            f"losses {loss_rel:.3e} rel, params {param_rel:.3e} of each "
            f"leaf's max (bar {TRAIN_ROUTE_BAR}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train route {name}")
        launches[name] = k2
        k1_launches += k1
        record["routes"][name] = {
            "losses": losses, "plain_losses": ref_losses,
            "loss_rel": loss_rel, "param_rel_to_max": param_rel,
            "k2_launches": k2, "k1_launches": k1,
            "tx_energy": [h.get("tx_energy") for h in hist]}
        del params, ref_params
        torch.cuda.empty_cache()
    mark("(c)")

    # (d) timings at full width
    batch = {"tokens": torch.from_numpy(batches[0]["tokens"]).cuda()}
    for aggregator, route in TRAIN_ROUTES:
        name = f"{aggregator} {'fused' if route == 'auto' else route}"
        row = train_step_split(cfg, aggregator, route, params0, batch,
                               profile=name in TRAIN_PROFILED)
        record["routes"][name]["timing"] = row
        log(f"train (d) {name} step at full width: {json.dumps(row)}")
        torch.cuda.empty_cache()
        mark(f"(d) {name}")
    record["attention"] = time_train_attention()
    mark("(d) K2")

    # (e) the card against the CPU on the reduced config
    small = cfg.reduced()
    cpu_params = build_model(small).init_params(device="cpu")
    cuda_params = tree_map(lambda p: p.cuda(), cpu_params)
    small_batches = _train_batches(small, TRAIN_STEPS)
    record["card_vs_cpu"] = {}
    for aggregator, route in TRAIN_ROUTES:
        name = f"{aggregator} {'fused' if route == 'auto' else route}"
        _, on_card, _, counts = _train_run(small, aggregator, route, "auto",
                                           cuda_params, small_batches)
        _, on_cpu, _, _ = _train_run(small, aggregator, route, "auto",
                                     cpu_params, small_batches)
        rel = _tree_rel_to_max(on_card, on_cpu)
        ok = rel <= TRAIN_ROUTE_BAR and counts[0] > 0
        log(f"train (e) reduced {TRAIN_ARCH} {name}, {TRAIN_STEPS} steps: "
            f"card vs CPU params {rel:.3e} of each leaf's max (bar "
            f"{TRAIN_ROUTE_BAR}); K2 {counts[0]}, K1 {counts[1]} launches "
            f"on the card {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train card vs CPU {name}")
        record["card_vs_cpu"][name] = rel
    mark("(e)")

    # (f) rbg and unsafe_rbg keys at full width
    for impl in TRAIN_RBG_IMPLS:
        rbg_k2, rbg_k1, record[impl] = train_rbg(
            cfg, params0, batches[:TRAIN_RBG_STEPS], impl)
        launches.update(rbg_k2)
        k1_launches += rbg_k1
        mark(f"(f) {impl}")
    record["launcher_s"] = launcher_s
    log(f"train: seconds by part {json.dumps(seconds)}")
    return launches, k1_launches, record


# --------------------------------------------------------------------------
# training olmo-1b in bf16 (T4) and rwkv6-7b (T5) over the MAC: K2's bf16
# kernel writing its log-sum-exp, K3 writing chunk checkpoints and the
# hand-written WKV backward kernel
# --------------------------------------------------------------------------
WKV_BWD_SOURCE = "src/repro_torch/kernels/wkv/csrc/wkv6_bwd.cu"
# the JAX package's WKV gradient: jax.vjp of the checkpointed scan (no
# backward Pallas kernel); the backward kernel replaces that
WKV_BWD_REPLACES = "src/repro/kernels/wkv/ref.py:39"  # wkv6_ref, via jax.vjp
MODEL_TRAIN_ARCHS = ("olmo-1b", "rwkv6-7b", "hymba-1.5b", "whisper-small",
                     "pixtral-12b")
# rwkv6-7b trains at full width with 4 of its 32 layers: at full depth its
# 7.53 B parameters (15.1 GB bf16), f32 momentum (30.1 GB), gradients and
# the largest leaf's f32 noise draw do not fit one 80 GB card beside the
# activations (the reference shards it, fsdp=True)
RWKV_TRAIN_LAYERS = 4
# pixtral-12b trains at full width with 4 of its 40 layers (2.43 B
# parameters, 1.34 B of them the embedding and unembedding): the
# transport route holds 8 nodes' gradients, f32 momentum and a full-D
# draw; at 4 layers its step peaked 57,921 MiB over 4,640 resident on an
# H100 (2 layers: 46,241 over 3,985), so 8 layers would not fit
PIXTRAL_TRAIN_LAYERS = 4
# steps a route in (g) (3 before the models trained with the per-layer
# recompute; the timing takes the better of the 2, the peak is step 2's)
MODEL_TRAIN_STEPS = 2
# (g)'s routes: every model takes the fused gbma route and gbma through
# the transport; olmo-1b and rwkv6-7b also receiver momentum through the
# transport (a bf16 model's gradients into the f32 carry)
MODEL_TRAIN_ROUTES = {arch: TRAIN_ROUTES if arch in ("olmo-1b", "rwkv6-7b")
                      else TRAIN_ROUTES[:2] for arch in MODEL_TRAIN_ARCHS}
# (f) K2 with lse at the new models' training shapes: (label, dtype, B,
# Hq, Hkv, S, d, causal, window), each against its plain version with
# lse and timed beside SDPA (hymba's 1,024 window does not bite at 384)
TRAIN_ATTN_CASES = (
    ("hymba local", "bfloat16", 8, 25, 5, 384, 64, True, 1024),
    ("hymba global", "bfloat16", 8, 25, 5, 384, 64, True, None),
    ("whisper encoder", "float32", 8, 12, 12, 1500, 64, False, None),
    ("whisper decoder", "bfloat16", 8, 12, 12, 256, 64, True, None),
    ("pixtral", "bfloat16", 8, 32, 8, 1280, 128, True, None),
)
# the WKV backward at rwkv6-7b's training shape (B, H, T, D) and at a
# transport node's (one example a node), then the reference tests' shapes
# and a length off the chunks
WKV_TRAIN_SHAPE = (8, 64, 256, 64)
WKV_NODE_SHAPE = (1, 64, 256, 64)
WKV_BWD_CASES = (*((s, "float32") for s in WKV_TEST_SHAPES),
                 (WKV_TRAIN_SHAPE, "float32"), (WKV_TRAIN_SHAPE, "bfloat16"),
                 (WKV_NODE_SHAPE, "bfloat16"), ((2, 8, 100, 64), "bfloat16"))
# the backward kernel against the plain backward: every gradient within
# 1e-4 of its largest magnitude, plus one bf16 rounding (2^-7·|g|) of the
# four the kernel writes in bf16 (du and ds0 are f32)
WKV_BWD_BAR = 1e-4
# (h) the kernel route against the plain route on the first batch at full
# width in bf16. The losses are held within 1e-2 relative. Each leaf's
# gradient is held by its distance to the f32 model's (the same bf16
# parameters upcast, through the plain route): the kernel route's at most
# MODEL_BF16_RATIO times the plain bf16 route's, as check_rwkv_routes
# holds serving. The reference's model-level bar
# (tests/test_flash_vjp.py:80-81: atol 2e-4 + rtol 1e-2 per element, in
# f32 on reduced olmo-1b) is printed, not held: in bf16 at full width the
# two routes differ by what bf16 rounds (the Hopper kernel rounds P to
# bf16 before PV, the one rounding the plain version does not make; the
# WKV kernel sums in another order before o is rounded), and an element
# of a gradient that cancels to near zero inherits the whole difference
# (olmo-1b read 16x that bar at its tightest element on an H100, each
# leaf within 1.21e-2 of its norm and 1.01e-2 of its largest |g|)
MODEL_GRAD_BAR = (2e-4, 1e-2)  # atol + rtol * |g|, printed
MODEL_BF16_RATIO = 2.0
MODEL_LOSS_RTOL = 1e-2


def model_train_cfg(arch: str):
    """The configuration a model trains at on the card (rwkv6-7b cut to
    RWKV_TRAIN_LAYERS layers, pixtral-12b to PIXTRAL_TRAIN_LAYERS,
    nothing else)."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    layers = {"rwkv6-7b": RWKV_TRAIN_LAYERS,
              "pixtral-12b": PIXTRAL_TRAIN_LAYERS}.get(arch)
    return cfg.with_(n_layers=layers) if layers else cfg


def launches_per_forward(cfg) -> dict:
    """K2's, K3's and the WKV backward's launches in one training forward
    and backward: one an attention layer (whisper's encoder and decoder;
    its cross-attention is plain) or RWKV layer, and under `cfg.remat`
    the backward runs each layer's forward again, so K2 and K3 launch
    twice a layer."""
    recompute = 2 if cfg.remat else 1
    if cfg.family == "ssm":
        return {"k2": 0, "k3": recompute * cfg.n_layers,
                "wkv_bwd": cfg.n_layers}
    attention = cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec"
                                else 0)
    return {"k2": recompute * attention, "k3": 0, "wkv_bwd": 0}


def step_model_flops(cfg) -> float:
    """`launch.analytic.model_flops` of one training step at the
    launcher's shape (B = TRAIN_BATCH, `train_seq` positions)."""
    from repro_torch.launch.analytic import model_flops
    from repro_torch.models.model import InputShape, build_model

    shape = InputShape("train", train_seq(cfg), TRAIN_BATCH, "train")
    return model_flops(build_model(cfg), shape, 1)


def check_train_attention_cases() -> list:
    """(f) K2 with lse at TRAIN_ATTN_CASES against its plain version with
    lse: `out` at the dtype's bar (`ATTN_BARS`), `lse` within 1e-5 +
    1e-6·|lse|; a non-causal case's control (the causal plain version)
    must miss the bar. Timed with CUDA events: the kernel with lse, the
    plain version with lse, SDPA (`enable_gqa` for groups), beside the
    bound (operations over the live pairs, or the bytes of q, k, v, o
    and lse). One row a case."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention.ops import multi_head_attention

    rows = []
    for label, dt, b, hq, hkv, s, d, causal, window in TRAIN_ATTN_CASES:
        atol, rtol = ATTN_BARS[dt]
        q, k, v = attn_inputs(b, hq, hkv, s, d, getattr(torch, dt), s + hq)
        kw = {"scale": d ** -0.5, "causal": causal, "window": window}
        out, lse = multi_head_attention(q, k, v, impl="kernel",
                                        return_lse=True, **kw)
        ref, ref_lse = multi_head_attention(q, k, v, impl="ref",
                                            return_lse=True, **kw)
        err = (out.float() - ref.float()).abs()
        lse_err = (lse - ref_lse).abs()
        ok = bool(torch.isfinite(out).all() and torch.isfinite(lse).all()
                  and (err <= atol + rtol * ref.float().abs()).all()
                  and (lse_err <= TRAIN_LSE_BAR[0]
                       + TRAIN_LSE_BAR[1] * ref_lse.abs()).all())
        control = None
        if not causal:
            ctl = multi_head_attention(q, k, v, impl="ref",
                                       **{**kw, "causal": True})
            control = (out.float() - ctl.float()).abs().max().item()
            ok = ok and control > atol
            del ctl
        gqa = {"enable_gqa": True} if hkv != hq else {}
        lib_out = F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=kw["scale"], **gqa)
        lib_err = (lib_out.float() - ref.float()).abs().max().item()
        row = {"case": label, "shape": [b, hq, s, d], "kv_heads": hkv,
               "dtype": dt, "causal": causal, "window": window,
               "max_abs_err": err.max().item(),
               "lse_max_abs_err": lse_err.max().item(),
               "causal_control_max_abs_err": control,
               "library_max_abs_err": lib_err}
        del out, lse, ref, ref_lse, err, lse_err, lib_out
        reps = 5 if dt == "float32" else 20
        row["ms"] = cuda_ms(lambda: multi_head_attention(
            q, k, v, impl="kernel", return_lse=True, **kw), reps)
        row["plain_ms"] = cuda_ms(lambda: multi_head_attention(
            q, k, v, impl="ref", return_lse=True, **kw), 2, warmup=1)
        row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=kw["scale"], **gqa), reps)
        bound, bound_by = attention_bound(b, hq, s, d, dt, hkv=hkv,
                                          window=window, causal=causal)
        lse_bytes_ms = 4 * b * hq * s / HBM_BYTES_PER_S * 1e3
        if bound_by == "bytes":
            bound += lse_bytes_ms
        row["bound_ms"], row["bound_by"] = bound, bound_by
        row["gflop"] = 4.0 * b * hq * d * live_pairs(s, window, causal) / 1e9
        ctl = "" if control is None else (
            f"; control: kernel vs the causal plain version {control:.3e} "
            "(must miss the bar)")
        log(f"train models (f) K2 {label} with lse q{(b, hq, s, d)} kv "
            f"heads {hkv} {dt} causal {causal} window {window}: out "
            f"max_abs_err {row['max_abs_err']:.3e} (atol {atol} + rtol "
            f"{rtol}), lse {row['lse_max_abs_err']:.3e} (bar "
            f"{TRAIN_LSE_BAR[0]} + {TRAIN_LSE_BAR[1]}|lse|){ctl}; SDPA vs "
            f"plain {lib_err:.3e}; kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms "
            f"({row['ms'] / row['library_ms']:.2f}x), bound {bound:.4f} ms "
            f"({bound_by}, {row['gflop']:.1f} GFLOP), "
            f"{bound / row['ms']:.1%} of it {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2 with lse at {label}")
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def wkv_bwd_bound(b, h, t, d, dtype_name) -> tuple:
    """(least ms, what bounds it) for one WKV6 backward: r, k, v, w and do
    read once and dr, dk, dv, dw written once (model dtype), u and du, s0,
    ds_fin and ds0 (f32) once each, against 13 flops for each (t, i, j)
    (the state recomputed, 3; the sums of dr, dk, dv and dw and the dS
    update, 2 each) and 8 for each (t, i), at the f32 rate outside the
    tensor cores."""
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = elt * 9 * b * h * t * d + 4 * (h * d + b * h * d) \
        + 4 * 3 * b * h * d * d
    flops = 13.0 * b * h * t * d * d + 8.0 * b * h * t * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _wkv_grads(args, do, ds_fin, use_kernel: bool) -> list:
    """The six WKV gradients of (o·do + S_T·ds_fin) on one route."""
    from repro_torch.kernels.wkv import ops as wkv_ops

    leaves = [x.clone().requires_grad_(True) for x in args]
    o, s_fin = wkv_ops._WKV6.apply(*leaves, use_kernel)
    ((o.float() * do.float()).sum() + (s_fin * ds_fin).sum()).backward()
    return [x.grad for x in leaves]


def check_wkv_backward() -> dict:
    """(f) The WKV backward kernel (behind K3 writing its checkpoints)
    against the plain backward at WKV_BWD_CASES, on the model's
    (B, T, H, D) views, with a nonzero s0 and cotangent of the final
    state: each gradient within WKV_BWD_BAR of its largest magnitude
    (plus one bf16 rounding of the bf16 ones). Returns per case the
    largest abs error and the largest relative to that magnitude."""
    import torch

    errs = {}
    for i, (shape, dt) in enumerate(WKV_BWD_CASES):
        dtype = getattr(torch, dt)
        args = wkv_inputs(*shape, dtype, 600 + i, layout="bthd")
        gen = torch.Generator(device="cuda").manual_seed(i)
        do = torch.randn(args[0].shape, generator=gen,
                         device="cuda").to(dtype)
        ds_fin = torch.randn(args[5].shape, generator=gen, device="cuda")
        ker = _wkv_grads(args, do, ds_fin, True)
        ref = _wkv_grads(args, do, ds_fin, False)
        torch.cuda.synchronize()
        ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
        ok, rel, err = True, [], 0.0
        for j, (a, b) in enumerate(zip(ker, ref)):
            a, b = a.float(), b.float()
            top = b.abs().max()
            bar = WKV_BWD_BAR * top + (ulp * b.abs() if j < 4 else 0.0)
            ok = ok and bool(torch.isfinite(a).all()
                             and ((a - b).abs() <= bar).all())
            rel.append(((a - b).abs().max() / top).item())
            err = max(err, (a - b).abs().max().item())
        errs[f"{list(shape)} {dt}"] = {"abs": err, "rel_to_max": max(rel)}
        log(f"train models (f) WKV backward kernel vs plain {list(shape)} "
            f"{dt}: max err / max |g| for dr dk dv dw du ds0 "
            f"{[f'{x:.2e}' for x in rel]} (bar {WKV_BWD_BAR}"
            f"{' + 2^-7|g|' if ulp else ''}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the WKV backward at {shape} {dt}")
    return errs


def time_wkv_backward() -> list:
    """(f) At rwkv6-7b's training shape and a transport node's, in bf16:
    the backward kernel (bare launch: its kernel and the second pass
    summing the row groups' dv partials) and the plain backward per call,
    against the bound; K3's forward with and without checkpoints. One row
    a shape."""
    import torch

    from repro_torch.kernels.wkv import kernel
    from repro_torch.kernels.wkv import ops as wkv_ops

    rows = []
    for b, h, t, d in (WKV_TRAIN_SHAPE, WKV_NODE_SHAPE):
        r, k, v, w, u, _ = wkv_inputs(b, h, t, d, torch.bfloat16, 8,
                                      layout="bthd")
        do = torch.randn(r.shape, device="cuda").to(torch.bfloat16)
        ckpt = torch.empty((b, h, kernel.n_ckpt(t), d, d), device="cuda")
        s_out = torch.empty((b, h, d, d), device="cuda")
        o = torch.empty((b, t, h, d), dtype=torch.bfloat16,
                        device="cuda").transpose(1, 2)
        grads = [torch.empty_like(o) for _ in range(4)]
        du = torch.empty((b, h, d), device="cuda")
        bound, bound_by = wkv_bwd_bound(b, h, t, d, "bfloat16")
        row = {"shape": [b, h, t, d], "dtype": "bfloat16",
               "forward_ms": cuda_ms(lambda: kernel.launch(
                   r, k, v, w, u, None, s_out, o), 50),
               "forward_ckpt_ms": cuda_ms(lambda: kernel.launch(
                   r, k, v, w, u, None, s_out, o, ckpt=ckpt), 50),
               "ms": cuda_ms(lambda: kernel.launch_backward(
                   r, k, v, w, do, u, ckpt, None, dr=grads[0], dk=grads[1],
                   dv=grads[2], dw=grads[3], du=du, ds0=None), 20),
               "plain_ms": cuda_ms(lambda: wkv_ops._plain_backward(
                   r, k, v, w, u, None, do, None), 2, warmup=1),
               "library_ms": None, "bound_ms": bound, "bound_by": bound_by}
        log(f"train models (f) WKV at {(b, h, t, d)} bf16: backward kernel "
            f"{row['ms']:.6f} ms, plain backward {row['plain_ms']:.3f} ms, "
            f"no library call, bound {bound:.6f} ms ({bound_by}), kernel at "
            f"{bound / row['ms']:.1%} of it; K3 forward "
            f"{row['forward_ms']:.6f} ms, with checkpoints "
            f"{row['forward_ckpt_ms']:.6f} ms")
        rows.append(row)
    return rows


def _reset_counts(*mods) -> None:
    for m in mods:
        m.launch_count = 0
        if hasattr(m, "backward_launch_count"):
            m.backward_launch_count = 0


def _counts(attn_ops, ota_ops, wkv_ops) -> dict:
    return {"k1": ota_ops.launch_count, "k2": attn_ops.launch_count,
            "k3": wkv_ops.launch_count,
            "wkv_bwd": wkv_ops.backward_launch_count}


@contextlib.contextmanager
def _step_parts(route: str):
    """Records a CUDA event where a training step's noise (fused route:
    `perturb_gradients`) or slot (transport route: `transport.aggregate`)
    begins and one where it ends, for the steps run inside, without
    synchronizing; yields the list of events."""
    import torch

    from repro_torch.training import train_step as ts

    owner, name = (ts.transport, "aggregate") if route == "transport" \
        else (ts, "perturb_gradients")
    inner = getattr(owner, name)
    events = []

    def timed(*args, **kwargs):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        out = inner(*args, **kwargs)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return out

    setattr(owner, name, timed)
    try:
        yield events
    finally:
        setattr(owner, name, inner)


def train_model_route(cfg, aggregator, route, params0, batches, mods):
    """(g) `MODEL_TRAIN_STEPS` steps of one route through `build_train_step`
    from a copy of `params0`, each step timed on the host clock (ending in
    a synchronize) with the kernels' launch counts (set to 0 just before
    the run); the peak device memory over the resident parameters and
    optimizer state during step 2 (the first allocates the momentum); the
    faster step's time and its parts, from CUDA events recorded in that
    step without a synchronize (`_step_parts`): the forward plus backward
    (with the fused route's node weights, or the per-node gradients), the
    edge noise (fused) or the slot, and the clip with the optimizer's
    update. Returns (losses, history, counts, step ms of each step, peak
    MiB, the faster step's parts ms)."""
    import torch

    from repro_torch.core.tree import tree_map

    _, _, _, step = _train_parts(cfg, aggregator, route, "auto")
    params = tree_map(lambda p: p.clone(), params0)
    state = step.init_state(params)
    step_ms, peak, hist, parts = [], 0.0, [], []
    mid = "slot_ms" if route == "transport" else "noise_ms"
    _reset_counts(*mods)
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        begin, end = (torch.cuda.Event(enable_timing=True) for _ in "be")
        with _step_parts(route) as marks:
            t0 = time.perf_counter()
            begin.record()
            params, state, metrics = step(params, state, batch, i)
            end.record()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        step_ms.append((t1 - t0) * 1e3)
        parts.append({"forward_backward_ms": begin.elapsed_time(marks[0]),
                      mid: marks[0].elapsed_time(marks[1]),
                      "clip_and_optimizer_ms": marks[1].elapsed_time(end)})
        if i == 1:
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        hist.append({k: float(v) for k, v in metrics.items()})
    counts = _counts(*mods)
    del params, state
    best = min(range(len(step_ms)), key=step_ms.__getitem__)
    return ([h["loss"] for h in hist], hist, counts, step_ms, peak,
            parts[best])


def model_grads(cfg, params, batch, impl: str) -> tuple:
    """(per-example losses, gradient leaves of the mean loss) of `params`
    on one route."""
    import torch

    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models.model import build_model

    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    losses, _ = build_model(cfg, impl=impl).train_loss_per_example(leaves,
                                                                   batch)
    torch.mean(losses).backward()
    return losses.detach(), [p.grad for p in tree_leaves(leaves)]


def check_model_routes(cfg, params, batch) -> dict:
    """(h) The kernel route against the plain route (`impl='ref'`: plain
    attention forward, or the plain WKV forward and backward) on the
    first batch at full width in bf16: the per-example losses within
    MODEL_LOSS_RTOL, and each leaf's gradient of the mean loss at most
    MODEL_BF16_RATIO times as far (in norm) from the f32 model's as the
    plain route's is; printed beside them, ||kernel - plain|| / ||plain||
    and the largest |kernel - plain| over the largest |g| per leaf, and
    the tightest element's reading of MODEL_GRAD_BAR. Returns them."""
    import torch

    from repro_torch.core.tree import tree_map

    kernel_loss, kernel = model_grads(cfg, params, batch, "auto")
    plain_loss, plain = model_grads(cfg, params, batch, "ref")
    f32 = model_grads(cfg.with_(dtype="float32"),
                      tree_map(lambda p: p.float(), params), batch, "ref")[1]
    torch.cuda.synchronize()
    loss_rel = ((kernel_loss - plain_loss).abs()
                / plain_loss.abs()).max().item()
    ok = loss_rel <= MODEL_LOSS_RTOL
    grad_ratio, rel_to_max, rel_norm, to_f32 = 0.0, [], [], []
    for a, b, c in zip(kernel, plain, f32):
        a, b, c = a.double(), b.double(), c.double()
        grad_ratio = max(grad_ratio, ((a - b).abs() / (
            MODEL_GRAD_BAR[0] + MODEL_GRAD_BAR[1] * b.abs())).max().item())
        rel_to_max.append(((a - b).abs().max()
                           / b.abs().max().clamp_min(1e-30)).item())
        norm = torch.linalg.vector_norm
        rel_norm.append((norm(a - b) / norm(b).clamp_min(1e-30)).item())
        d_kernel, d_plain = norm(a - c).item(), norm(b - c).item()
        to_f32.append(d_kernel / d_plain if d_plain > 0 else
                      (0.0 if d_kernel == 0 else math.inf))
        ok = ok and bool(torch.isfinite(a).all())
    ok = ok and max(to_f32) <= MODEL_BF16_RATIO
    log(f"train models (h) {cfg.arch_id} ({cfg.n_layers} layers) kernel vs "
        f"plain route on the first batch, bf16: losses {loss_rel:.3e} rel "
        f"(bar {MODEL_LOSS_RTOL}); per leaf, the kernel route's distance "
        f"to the f32 model over the plain route's "
        f"{[f'{x:.3f}' for x in to_f32]} (bar {MODEL_BF16_RATIO}); "
        f"printed: ||kernel - plain|| / ||plain|| "
        f"{[f'{x:.2e}' for x in rel_norm]}, max |kernel - plain| over the "
        f"leaf's largest |g| {[f'{x:.2e}' for x in rel_to_max]}, the "
        f"tightest element at {grad_ratio:.3f} of {MODEL_GRAD_BAR[0]} + "
        f"{MODEL_GRAD_BAR[1]}|g| {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{cfg.arch_id}: kernel vs plain route")
    return {"loss_rel": loss_rel, "grad_to_f32_ratio": to_f32,
            "grad_rel_norm": rel_norm, "grad_rel_to_max": rel_to_max,
            "grad_elementwise_at_bar": grad_ratio}


def run_train_models(attn_ops, ota_ops, wkv_ops) -> tuple:
    """Training olmo-1b (bf16, full width and depth), rwkv6-7b (bf16,
    full width, RWKV_TRAIN_LAYERS layers), hymba-1.5b (full width and
    depth, 128 meta tokens), whisper-small (full width and depth, over
    1,500 f32 frames) and pixtral-12b (full width, PIXTRAL_TRAIN_LAYERS
    layers, after 1,024 patches) over the MAC on the card, each layer
    recomputed in the backward (`cfg.remat`, the reference's default):

    (f) K2's bf16 kernel with `lse` against its plain version, and timed
        at olmo-1b's training shape; K2 with `lse` at the new models'
        training shapes (TRAIN_ATTN_CASES); the WKV backward kernel
        against the plain backward, and timed at rwkv6-7b's;
    (g) the launcher (`python -m repro_torch.launch.train --arch olmo-1b
        --steps 2`, then `--arch whisper-small`, whose batches carry
        frames), then each model MODEL_TRAIN_STEPS steps on the fused
        gbma route and through the transport with gbma (olmo-1b and
        rwkv6-7b also with receiver momentum) at the launcher's
        defaults: finite losses, the kernels' launches a step (K2 twice
        an attention layer a forward and backward, K3 twice and the
        backward once an rwkv6-7b layer, N of each a transport step; K1
        one a leaf a slot), ms per step (the better of the 2) with that
        step's parts and the step's model FLOPs
        (`launch.analytic`) as a share of the card's bf16 peak, peak
        memory over the resident parameters and state (no profile: one
        costs ~0.55 ms of profiler overhead a launch on an H100, and
        hymba-1.5b's fused step makes 52,478; PERF.md keeps each model's
        from an earlier run);
    (h) the kernel route against the plain route on the first batch;
    (i) the card against the CPU on the reduced (f32) models,
        MODEL_TRAIN_STEPS steps on the fused gbma route.

    Returns (launches by kernel over (g), the record)."""
    import gc

    import torch

    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.analysis import PEAK_FLOPS
    from repro_torch.models.model import build_model

    mods = (attn_ops, ota_ops, wkv_ops)
    t_phase = time.perf_counter()
    seconds = {}

    def mark(part: str) -> None:
        torch.cuda.synchronize()
        seconds[part] = time.perf_counter() - t_phase - sum(seconds.values())

    record = {"seconds": seconds,
              "lse_errors": check_attention_lse("bfloat16"),
              "lse_timing": time_train_attention("bfloat16"),
              "train_attention": check_train_attention_cases(),
              "wkv_backward_errors": check_wkv_backward(),
              "wkv_backward_timing": time_wkv_backward()}
    mark("(f)")

    # (g) the launcher as a user runs it, then the routes
    totals = {"k1": 0, "k2": 0, "k3": 0, "wkv_bwd": 0}
    for arch in ("olmo-1b", "whisper-small"):
        _reset_counts(*mods)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train_launch.main(["--arch", arch, "--steps", "2"])
        torch.cuda.synchronize()
        final = float(buf.getvalue().rsplit("final loss", 1)[1].split()[0])
        counts = _counts(*mods)
        want = 2 * launches_per_forward(model_train_cfg(arch))["k2"]
        log(f"train models (g) launch.train --arch {arch} --steps 2: "
            f"{time.perf_counter() - t0:.2f} s, final loss {final:.4f}, "
            f"launches {counts} (K2 expected {want}); output: "
            f"{buf.getvalue().strip().splitlines()}")
        if not math.isfinite(final) or counts["k2"] != want:
            raise AssertionError(f"the train launcher on {arch}")
        for key in totals:
            totals[key] += counts[key]
        gc.collect()
        torch.cuda.empty_cache()
        mark(f"(g) launcher {arch}")
    record["models"] = {}
    for arch in MODEL_TRAIN_ARCHS:
        cfg = model_train_cfg(arch)
        params0 = build_model(cfg).init_params(device="cuda")
        n_params = sum(p.numel() for p in tree_leaves(params0))
        n_leaves = len(tree_leaves(params0))
        batches = [_on_card(b)
                   for b in _train_batches(cfg, MODEL_TRAIN_STEPS)]
        per_forward = launches_per_forward(cfg)
        flops = step_model_flops(cfg)
        rec = record["models"][arch] = {
            "params": n_params, "leaves": n_leaves, "layers": cfg.n_layers,
            "seq": train_seq(cfg), "model_flops": flops,
            "resident_mib": sum(p.numel() * p.element_size() for p in
                                tree_leaves(params0)) / 2**20,
            "routes": {}}
        for aggregator, route in MODEL_TRAIN_ROUTES[arch]:
            name = f"{aggregator} {'fused' if route == 'auto' else route}"
            gc.collect()
            torch.cuda.empty_cache()
            log(f"train models (g) {arch} {name}: "
                f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB allocated "
                f"before the route")
            losses, hist, counts, step_ms, peak, row = train_model_route(
                cfg, aggregator, route, params0, batches, mods)
            transport_route = route == "transport"
            nodes = TRAIN_NODES if transport_route else 1
            want = {key: MODEL_TRAIN_STEPS * nodes * n for key, n in
                    per_forward.items()}
            want["k1"] = MODEL_TRAIN_STEPS * n_leaves if transport_route \
                else 0
            tx_ok = not transport_route or all(
                math.isfinite(h["tx_energy"]) and h["tx_energy"] > 0
                for h in hist)
            ok = all(math.isfinite(x) for x in losses) and tx_ok \
                and counts == want
            best = min(step_ms)
            row.update(step_ms=best, step_ms_all=step_ms,
                       peak_mib_over_resident=peak, losses=losses,
                       launches_per_step={k: v / MODEL_TRAIN_STEPS
                                          for k, v in counts.items()},
                       model_flops_share=flops / (best * 1e-3)
                       / PEAK_FLOPS,
                       tx_energy=[h.get("tx_energy") for h in hist])
            rec["routes"][name] = row
            log(f"train models (g) {arch} ({n_params:,} parameters, "
                f"{n_leaves} leaves, {cfg.n_layers} layers) {name}, "
                f"{MODEL_TRAIN_STEPS} steps: losses {losses}; launches "
                f"{counts} (expected {want}); step {best:.1f} ms, "
                f"model_flops {flops:.4e} a step, "
                f"{row['model_flops_share']:.2%} of "
                f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s; {json.dumps(row)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"train models {arch} {name}")
            for key in totals:
                totals[key] += counts[key]
            torch.cuda.empty_cache()
            mark(f"(g) {arch} {name}")
        rec["routes_check"] = check_model_routes(cfg, params0, batches[0])
        del params0
        torch.cuda.empty_cache()
        mark(f"(h) {arch}")

    # (i) the card against the CPU on the reduced models
    record["card_vs_cpu"] = {}
    for arch in MODEL_TRAIN_ARCHS:
        small = model_train_cfg(arch).reduced()
        cpu_params = build_model(small).init_params(device="cpu")
        cuda_params = tree_map(lambda p: p.cuda(), cpu_params)
        small_batches = _train_batches(small, MODEL_TRAIN_STEPS)
        # the fused route (K1's card against the CPU is "train" (e)'s)
        for aggregator, route in (("gbma", "auto"),):
            name = f"{aggregator} {'fused' if route == 'auto' else route}"
            _reset_counts(*mods)
            with contextlib.redirect_stdout(io.StringIO()):
                _, on_card, _, _ = _train_run(small, aggregator, route,
                                              "auto", cuda_params,
                                              small_batches)
                counts = _counts(*mods)
                _, on_cpu, _, _ = _train_run(small, aggregator, route,
                                             "auto", cpu_params,
                                             small_batches)
            rel = _tree_rel_to_max(on_card, on_cpu)
            used = min(counts["k3"], counts["wkv_bwd"]) \
                if small.family == "ssm" else counts["k2"]
            ok = rel <= TRAIN_ROUTE_BAR and used > 0
            log(f"train models (i) reduced {arch} {name}, {MODEL_TRAIN_STEPS} "
                f"steps: card vs CPU params {rel:.3e} of each leaf's max "
                f"(bar {TRAIN_ROUTE_BAR}); launches on the card {counts} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"train models card vs CPU {arch} "
                                     f"{name}")
            record["card_vs_cpu"][f"{arch} {name}"] = rel
    mark("(i)")
    log(f"train models: seconds by part {json.dumps(seconds)}")
    return totals, record


# ------------------------------------------------------------- mesh train
# M12a: olmo-1b at full width and depth in bf16 on a (data x model) mesh,
# 2 steps of the fused gbma route at "train models"' batch (B = 8, S =
# 256), channel and optimizer, the MAC's nodes the data ranks
MESH_TRAIN_ARCH = "olmo-1b"
MESH_TRAIN_SHAPE = (2, 2)
MESH_TRAIN_STEPS = 2


def _mesh_train_step(cfg, mesh):
    """(model, train step) as the launcher builds the fused gbma step,
    with n_nodes the mesh's data ranks (None: one device, 2 nodes); on a
    mesh built under `use_mesh`."""
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.gbma import GBMAConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim.gd import get_optimizer
    from repro_torch.sharding.specs import use_mesh
    from repro_torch.training.train_step import (TrainConfig,
                                                 build_train_step)

    nodes = mesh.shape["data"] if mesh is not None else MESH_TRAIN_SHAPE[0]
    ch = ChannelConfig(fading="rayleigh", noise_std=TRAIN_NOISE_STD,
                       energy=1.0)
    tcfg = TrainConfig(aggregator="gbma",
                       gbma=GBMAConfig(n_nodes=nodes, channel=ch))
    model = build_model(cfg)
    with use_mesh(mesh):
        step = build_train_step(model, tcfg,
                                get_optimizer("momentum", TRAIN_LR))
    return model, step


def _mesh_train_run(cfg, params0, batches, mesh, attn_ops) -> dict:
    """MESH_TRAIN_STEPS steps of the fused step from `params0` (laid out
    over `mesh` by the reference's rules, or on one device with `mesh`
    None), K2's launch count set to 0 just before and read just after.
    Each step timed on the host clock (ending in a synchronize of every
    card); the peak memory of each card during step 2 over what it held
    before it; each mesh entry's resident parameter and state bytes; the
    faster step's parts from CUDA events recorded in it on the current
    card (`_step_parts`: the forward and backward, the edge noise, the
    clip and the optimizer)."""
    import torch

    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.sharding.placement import Sharded, shard_params

    _, step = _mesh_train_step(cfg, mesh)
    if mesh is None:
        params, cards = tree_map(lambda p: p.clone(), params0), \
            [params0["embed"].device]
    else:
        params = shard_params(params0, cfg.fsdp, mesh)
        cards = sorted(set(mesh.devices), key=str)
    state = step.init_state(params)
    resident = None
    if mesh is not None:
        resident = [sum(leaf.shards[i].numel() * leaf.shards[i]
                        .element_size() for leaf in tree_leaves(
                            (params, state)) if isinstance(leaf, Sharded))
                    / 2**20 for i in range(mesh.size)]
    attn_ops.launch_count = 0
    losses, step_ms, base, parts = [], [], {}, []
    for i, batch in enumerate(batches):
        for c in cards:
            torch.cuda.synchronize(c)
        if i == 1:
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
                base[c] = torch.cuda.memory_allocated(c)
        begin, end = (torch.cuda.Event(enable_timing=True) for _ in "be")
        with _step_parts("fused") as marks:
            t0 = time.perf_counter()
            begin.record()
            params, state, metrics = step(params, state, batch, i)
            end.record()
            for c in cards:
                torch.cuda.synchronize(c)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        parts.append({"forward_backward_ms": begin.elapsed_time(marks[0]),
                      "noise_ms": marks[0].elapsed_time(marks[1]),
                      "clip_and_optimizer_ms": marks[1].elapsed_time(end)})
        losses.append(float(metrics["loss"]))
    peaks = {str(c): (torch.cuda.max_memory_allocated(c) - base[c]) / 2**20
             for c in cards}
    best = min(range(len(step_ms)), key=step_ms.__getitem__)
    return {"losses": losses, "params": params, "step_ms": step_ms,
            "parts": parts[best], "peak_mib_over_resident": peaks,
            "resident_mib": resident, "k2": attn_ops.launch_count}


def _leaf_distances(out, ref) -> list:
    """||out - ref|| per leaf, in f64 on the card."""
    from repro_torch.core.tree import tree_leaves

    return [_l2(o.double() - r.double())
            for o, r in zip(tree_leaves(out), tree_leaves(ref))]


def _l2(x) -> float:
    import torch

    return torch.linalg.vector_norm(x).item()


def run_mesh_train(attn_ops) -> tuple:
    """"mesh train" (M12a): olmo-1b at full width and depth in bf16, each
    layer recomputed (`cfg.remat`), trained MESH_TRAIN_STEPS steps on the
    fused gbma route on a (2, 2) ("data", "model") mesh of four entries
    of cuda:0, with the config's `fsdp=False` and with `fsdp=True`; where
    the machine shows two or more cards, also on (2, 2) over four distinct
    cards or (2, 1) over two, each bit for bit the run over entries of
    cuda:0 at the same shape. Each run is held to the unmeshed fused step
    at the same seed, nodes and batches by the bar "train models" (h)
    holds olmo-1b's routes to: the losses within MODEL_LOSS_RTOL, and
    each leaf of the final parameters at most MODEL_BF16_RATIO times as
    far (in norm) from the f32 model's (the same parameters upcast, the
    same steps) as the unmeshed bf16 step's. Every shard equals its
    block of `unshard`; K2 launches on each entry's heads, twice a
    layer a step (the forward and the recompute). Returns (K2 launches
    of the phase: the unmeshed bf16 and f32 runs and the mesh runs, the
    record)."""
    import gc

    import torch

    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.sharding.placement import unshard

    t_phase = time.perf_counter()
    cfg = model_train_cfg(MESH_TRAIN_ARCH)
    params0 = build_model(cfg).init_params(device="cuda")
    batches = [_on_card(b) for b in _train_batches(cfg, MESH_TRAIN_STEPS)]
    plain = _mesh_train_run(cfg, params0, batches, None, attn_ops)
    f32 = _mesh_train_run(cfg.with_(dtype="float32"),
                          tree_map(lambda p: p.float(), params0), batches,
                          None, attn_ops)
    d_plain = _leaf_distances(plain["params"], f32["params"])
    log(f"mesh train unmeshed {MESH_TRAIN_ARCH} fused gbma, "
        f"{MESH_TRAIN_STEPS} steps ({MESH_TRAIN_SHAPE[0]} nodes): bf16 "
        f"losses {plain['losses']}, step ms {plain['step_ms']}, the "
        f"faster's parts {json.dumps(plain['parts'])}, peak MiB over "
        f"resident {plain['peak_mib_over_resident']}, K2 {plain['k2']}; "
        f"f32 losses {f32['losses']}, step ms {f32['step_ms']}")
    per_step = cfg.n_layers * (2 if cfg.remat else 1)
    record = {"unmeshed": {k: plain[k] for k in (
        "losses", "step_ms", "parts", "peak_mib_over_resident", "k2")},
        "f32": {k: f32[k] for k in ("losses", "step_ms")}, "runs": {}}
    n_cards = torch.cuda.device_count()
    runs = [("(2, 2) cuda:0 x 4", MESH_TRAIN_SHAPE, ["cuda:0"] * 4, False),
            ("(2, 2) cuda:0 x 4 fsdp", MESH_TRAIN_SHAPE, ["cuda:0"] * 4,
             True)]
    if n_cards >= 4:
        runs.append(("(2, 2) 4 cards", MESH_TRAIN_SHAPE,
                     [f"cuda:{i}" for i in range(4)], False))
    elif n_cards >= 2:
        runs += [("(2, 1) cuda:0 x 2", (2, 1), ["cuda:0"] * 2, False),
                 ("(2, 1) 2 cards", (2, 1), ["cuda:0", "cuda:1"], False)]
    launches, finals = plain["k2"] + f32["k2"], {}
    for label, shape, devices, fsdp in runs:
        gc.collect()
        torch.cuda.empty_cache()
        mesh = make_mesh(shape, ("data", "model"), devices)
        mcfg = cfg.with_(fsdp=fsdp)
        run = _mesh_train_run(mcfg, params0, batches, mesh, attn_ops)
        launches += run["k2"]
        want = MESH_TRAIN_STEPS * per_step * mesh.size
        whole = unshard(run["params"])
        blocks_ok = all(
            torch.equal(s, full[leaf.box(i)])
            for leaf, full in zip(tree_leaves(run["params"]),
                                  tree_leaves(whole))
            for i, s in enumerate(leaf.shards))
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(run["losses"], plain["losses"]))
        ratios = [(dm / dp if dp > 0 else (0.0 if dm == 0 else math.inf))
                  for dm, dp in zip(_leaf_distances(whole, f32["params"]),
                                    d_plain)]
        moved = [_l2(a.double() - b.double()) / max(
            _l2(b.double() - c.double()), 1e-30) for a, b, c in zip(
                tree_leaves(whole), tree_leaves(plain["params"]),
                tree_leaves(params0))]
        same = None
        twin = {"(2, 2) 4 cards": "(2, 2) cuda:0 x 4",
                "(2, 1) 2 cards": "(2, 1) cuda:0 x 2"}.get(label)
        if twin is not None:
            same = all(torch.equal(s.to(t.device), t) for x, y in zip(
                tree_leaves(run["params"]), tree_leaves(finals[twin]))
                for s, t in zip(x.shards, y.shards))
        ok = (all(math.isfinite(x) for x in run["losses"])
              and loss_rel <= MODEL_LOSS_RTOL
              and max(ratios) <= MODEL_BF16_RATIO and blocks_ok
              and run["k2"] == want and same is not False)
        row = {"mesh": list(shape), "devices": devices, "fsdp": fsdp,
               "losses": run["losses"], "step_ms": run["step_ms"],
               "parts": run["parts"],
               "peak_mib_over_resident": run["peak_mib_over_resident"],
               "resident_mib_per_entry": run["resident_mib"],
               "k2": run["k2"], "k2_expected": want, "loss_rel": loss_rel,
               "to_f32_ratio": ratios, "rel_to_unmeshed_update": moved,
               "bits_equal_entries_of_cuda0": same}
        record["runs"][label] = row
        log(f"mesh train {label} {MESH_TRAIN_ARCH} ({cfg.n_layers} x "
            f"{cfg.d_model}, bf16, fsdp={fsdp}), {MESH_TRAIN_STEPS} steps: "
            f"losses {run['losses']} (unmeshed {plain['losses']}, "
            f"{loss_rel:.3e} rel, bar {MODEL_LOSS_RTOL}); per leaf, the "
            f"distance to the f32 model over the unmeshed step's "
            f"{[f'{x:.3f}' for x in ratios]} (bar {MODEL_BF16_RATIO}); "
            f"printed: ||mesh - unmeshed|| over ||unmeshed - start|| "
            f"{[f'{x:.2e}' for x in moved]}; every shard its block "
            f"{blocks_ok}; step ms {[f'{x:.1f}' for x in run['step_ms']]} "
            f"(unmeshed {[f'{x:.1f}' for x in plain['step_ms']]}), the "
            f"faster's parts {json.dumps(run['parts'])}; peak "
            f"MiB over resident by card "
            f"{ {k: round(v, 1) for k, v in run['peak_mib_over_resident'].items()} }"
            f", resident MiB by entry "
            f"{[round(x, 1) for x in run['resident_mib']]}; K2 "
            f"{run['k2']} (expected {want}: {MESH_TRAIN_STEPS} steps x "
            f"{cfg.n_layers} layers x 2 x {mesh.size} entries); bits "
            f"against entries of cuda:0 {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mesh train {label}")
        if n_cards >= 2 and label in ("(2, 2) cuda:0 x 4",
                                      "(2, 1) cuda:0 x 2"):
            finals[label] = run["params"]
        del run, whole
    finals.clear()
    del params0, plain, f32
    gc.collect()
    torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    log(f"mesh train: {record['seconds']:.1f} s")
    return launches, record


# ------------------------------------------------------------- mesh serve
# M12b: the dense decoder served on a (data x model) mesh of four entries
# of cuda:0 through `Model.prefill`, `Model.decode_step` and
# `Engine.generate` under `use_mesh`: olmo-1b at full width and depth in
# bf16 on (2, 2) (fsdp off at both prompts, on at the short one) and
# repro-100m in f32 on (1, 4), with `opt_pad_heads` off (heads
# replicated, the cache split on head_dim) and on (12 heads, 3 an
# entry); B = 4, 16 new tokens, decode teacher-forced on the unmeshed
# run's greedy tokens
MESH_SERVE_NEW_TOKENS = 16
MESH_SERVE_F32_BAR = 1e-4  # atol = rtol, tests/test_torch_serve.py's


def _mesh_serve_seq(model, params, prompt, fed, mesh, attn_ops) -> dict:
    """Prefill `prompt` (a cache of S + MESH_SERVE_NEW_TOKENS) and decode
    MESH_SERVE_NEW_TOKENS steps feeding `fed[i]` (None: this run's greedy
    token), under `use_mesh(mesh)` (None: unmeshed). K2's count is set to
    0 just before the prefill and read just after. Returns the logits of
    the prefill and each step (f32, the first entry's card), the tokens
    fed, the cache and K2's launches."""
    from repro_torch.sharding.specs import use_mesh

    s = prompt.shape[1]
    with use_mesh(mesh):
        attn_ops.launch_count = 0
        logits, cache = model.prefill(params, {"tokens": prompt},
                                      s + MESH_SERVE_NEW_TOKENS)
        k2 = attn_ops.launch_count
        seq, toks = [logits], []
        for i in range(MESH_SERVE_NEW_TOKENS):
            tok = logits.argmax(-1) if fed is None else fed[i]
            toks.append(tok)
            logits, cache = model.decode_step(params, cache, tok, s + i)
            seq.append(logits)
    return {"logits": seq, "fed": toks, "cache": cache, "k2": k2}


def _mesh_serve_timing(model, params, prompt, mesh, cards) -> dict:
    """Prefill ms and decode ms per step (host clock ending in a
    synchronize of every card, best of 2; the teacher-forced run before
    it warmed these shapes), and one profiled decode step and, at the
    longest prompt, one profiled prefill: launches, device busy time and
    the idle share against the timed wall."""
    import torch

    from repro_torch.sharding.specs import use_mesh

    s = prompt.shape[1]
    tok = prompt[:, -1]

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    def best(fn):
        times = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    with use_mesh(mesh):
        def prefill():
            return model.prefill(params, {"tokens": prompt},
                                 s + MESH_SERVE_NEW_TOKENS)

        _, cache = prefill()

        def decode():
            model.decode_step(params, cache, tok, s)

        row = {"prefill_ms": best(prefill), "decode_ms_per_step": best(decode)}
        profiled = [("decode", decode, row["decode_ms_per_step"])]
        if s == SERVE_PROMPTS[-1]:
            profiled.append(("prefill", prefill, row["prefill_ms"]))
        for name, fn, wall in profiled:
            p = _profile_counts(fn, kernel="flash_attention")
            busy = p["device_us"] / 1e3
            row[name] = {"launches": p["launches"], "device_busy_ms": busy,
                         "device_idle_share": 1.0 - busy / wall}
    return row


def _entry_mib(tree, i: int) -> float:
    """Mesh entry i's resident MiB of the `Sharded` leaves of `tree`."""
    from repro_torch.core.tree import tree_leaves

    return sum(x.shards[i].numel() * x.shards[i].element_size()
               for x in tree_leaves(tree)) / 2**20


def _mesh_serve_run(model, params0, prompt, fed, shape, devices, fsdp,
                    attn_ops) -> dict:
    """One mesh run: the parameters placed by the reference's rules, the
    teacher-forced sequence (`_mesh_serve_seq`) with the card's peak over
    what it held before the prefill, every cache shard held to its block
    of `unshard`, each entry's resident weight and cache MiB, and the
    timing (`_mesh_serve_timing`)."""
    import torch

    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.placement import shard_params, unshard

    mesh = make_mesh(shape, ("data", "model"), devices)
    cards = sorted(set(mesh.devices), key=str)
    params = shard_params(params0, fsdp, mesh)
    base = {}
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)
        base[c] = torch.cuda.memory_allocated(c)
    t0 = time.perf_counter()
    run = _mesh_serve_seq(model, params, prompt, fed, mesh, attn_ops)
    for c in cards:
        torch.cuda.synchronize(c)
    run["peak_mib_over_resident"] = {
        str(c): (torch.cuda.max_memory_allocated(c) - base[c]) / 2**20
        for c in cards}
    whole = unshard(run["cache"])
    run["blocks_ok"] = all(
        torch.equal(s, full[leaf.box(i)])
        for leaf, full in zip(tree_leaves(run["cache"]), tree_leaves(whole))
        for i, s in enumerate(leaf.shards))
    run["weights_mib"] = [_entry_mib(params, i) for i in range(mesh.size)]
    run["cache_mib"] = [_entry_mib(run["cache"], i)
                        for i in range(mesh.size)]
    run["k_spec"] = list(tree_leaves(run["cache"])[0].spec)
    del whole
    run["timing"] = _mesh_serve_timing(model, params, prompt, mesh, cards)
    run["mesh"], run["entries"] = mesh, mesh.size
    run["seconds"] = time.perf_counter() - t0
    return run


def _logit_distance(seq, ref) -> float:
    """||seq - ref|| over the prefill's and every step's logits, f64."""
    return math.sqrt(sum(_l2(a.double() - b.double()) ** 2
                         for a, b in zip(seq, ref)))


def _greedy_equal(seq, ref) -> tuple:
    """(whether the prefill's greedy tokens are equal, the count of equal
    greedy tokens over the prefill and every step, their number)."""
    a = [x.argmax(-1) for x in seq]
    b = [x.argmax(-1).to(y.device) for x, y in zip(ref, a)]
    return (_same(a[0], b[0]),
            sum(int((x == y).sum()) for x, y in zip(a, b)),
            sum(x.numel() for x in a))


def _same(a, b) -> bool:
    """Whether `a` and `b` (on any cards) hold the same bits."""
    import torch

    return torch.equal(a, b.to(a.device))


def run_mesh_serve(attn_ops) -> tuple:
    """"mesh serve" (M12b), the runs MESH_SERVE_* name above. olmo-1b:
    the unmeshed bf16 run (greedy) and the f32 model (the same weights
    upcast, fed the same tokens) are the references; each mesh run,
    teacher-forced on the unmeshed run's tokens, must be at most
    MODEL_BF16_RATIO times as far (in norm, over the prefill's and every
    step's logits) from the f32 model's logits as the unmeshed run is,
    with the prefill's greedy tokens equal (the count of equal greedy
    tokens printed); then `Engine.generate` under the (2, 2) mesh at the
    short prompt, its tokens against the unmeshed engine's. repro-100m
    (f32): every logit within atol 1e-4 + rtol 1e-4 of the unmeshed
    run's. Each run: K2 once a layer on each entry in the prefill, every
    cache shard its block of `unshard`, the times, launches and idle
    shares beside the unmeshed run's, each entry's resident MiB and the
    card's peak over resident. Where the machine shows two or more cards,
    the same run over distinct cards bit for bit the run over entries of
    cuda:0. Returns (K2 launches of the phase, the record)."""
    import gc

    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.sharding.placement import shard_params
    from repro_torch.sharding.specs import use_mesh

    t_phase = time.perf_counter()
    record = {"runs": {}, "unmeshed": {}}
    launches = 0
    n_cards = torch.cuda.device_count()
    cuda0 = [torch.device("cuda:0")]

    def idle(t: dict) -> str:
        return ", ".join(f"{k} {t[k]['device_idle_share']:.3f}"
                         for k in ("prefill", "decode") if k in t)

    def report(label, cfg, run, s, bars: dict, extra: str) -> bool:
        want = cfg.n_layers * run["entries"]
        t, u = run["timing"], record["unmeshed"][f"{cfg.arch_id} {s}"]
        ok = bars.pop("ok") and run["blocks_ok"] and run["k2"] == want
        row = {"arch": cfg.arch_id, "dtype": cfg.dtype, "prompt": s,
               "batch": SERVE_BATCH, "mesh": list(run["mesh"].shape.values()),
               "devices": [str(d) for d in run["mesh"].devices],
               "k_spec": run["k_spec"], "k2": run["k2"],
               "k2_expected": want, "blocks_ok": run["blocks_ok"],
               "timing": t, "unmeshed_timing": u,
               "weights_mib_per_entry": run["weights_mib"],
               "cache_mib_per_entry": run["cache_mib"],
               "peak_mib_over_resident": run["peak_mib_over_resident"],
               "seconds": run["seconds"], **bars}
        record["runs"][f"{label} {cfg.arch_id} {s}"] = row
        log(f"mesh serve {label} {cfg.arch_id} ({cfg.n_layers} x "
            f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.dtype}, pad "
            f"{cfg.opt_pad_heads}) B={SERVE_BATCH} prompt={s}: {extra}; "
            f"cache k spec {run['k_spec']}, every shard its block "
            f"{run['blocks_ok']}; K2 {run['k2']} a prefill (expected "
            f"{want}: {cfg.n_layers} layers x {run['entries']} entries); "
            f"prefill ms {t['prefill_ms']:.2f} (unmeshed "
            f"{u['prefill_ms']:.2f}), decode ms/step "
            f"{t['decode_ms_per_step']:.2f} (unmeshed "
            f"{u['decode_ms_per_step']:.2f}); launches per decode step "
            f"{t['decode']['launches']} (unmeshed "
            f"{u['decode']['launches']}); idle share {idle(t)} (unmeshed "
            f"{idle(u)}); resident MiB per "
            f"entry: weights {[round(x, 1) for x in run['weights_mib']]}, "
            f"cache {[round(x, 2) for x in run['cache_mib']]}; peak MiB "
            f"over resident "
            f"{ {k: round(v, 1) for k, v in run['peak_mib_over_resident'].items()} }"
            f"; {run['seconds']:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mesh serve {label} {cfg.arch_id} {s}")
        return ok

    # olmo-1b in bf16, the f32 model (the same weights upcast) beside it
    model, params0 = _serve_model("olmo-1b")
    cfg = model.cfg
    f32_model, f32_params = _serve_model(
        "olmo-1b", params=tree_map(lambda p: p.float(), params0),
        dtype="float32")
    olmo_runs = [("(2, 2) cuda:0 x 4", (2, 2), ["cuda:0"] * 4, False,
                  SERVE_PROMPTS),
                 ("(2, 2) cuda:0 x 4 fsdp", (2, 2), ["cuda:0"] * 4, True,
                  SERVE_PROMPTS[:1])]
    if n_cards >= 4:
        olmo_runs.append(("(2, 2) 4 cards", (2, 2),
                          [f"cuda:{i}" for i in range(4)], False,
                          SERVE_PROMPTS[:1]))
    elif n_cards >= 2:
        olmo_runs += [(f"{shape} {tag}", shape, devs, False,
                       SERVE_PROMPTS[:1])
                      for shape in ((2, 1), (1, 2))
                      for tag, devs in (("cuda:0 x 2", ["cuda:0"] * 2),
                                        ("2 cards", ["cuda:0", "cuda:1"]))]
    twins = {"(2, 2) 4 cards": "(2, 2) cuda:0 x 4",
             "(2, 1) 2 cards": "(2, 1) cuda:0 x 2",
             "(1, 2) 2 cards": "(1, 2) cuda:0 x 2"}
    for s in SERVE_PROMPTS:
        prompt = _prompt(cfg.vocab_size, s)
        plain = _mesh_serve_seq(model, params0, prompt, None, None,
                                attn_ops)
        f32 = _mesh_serve_seq(f32_model, f32_params, prompt, plain["fed"],
                              None, attn_ops)
        launches += plain["k2"] + f32["k2"]
        del plain["cache"], f32["cache"]
        d_plain = _logit_distance(plain["logits"], f32["logits"])
        record["unmeshed"][f"olmo-1b {s}"] = _mesh_serve_timing(
            model, params0, prompt, None, cuda0)
        finals = {}
        for label, shape, devices, fsdp, prompts in olmo_runs:
            if s not in prompts:
                continue
            gc.collect()
            torch.cuda.empty_cache()
            run = _mesh_serve_run(model, params0, prompt, plain["fed"],
                                  shape, devices, fsdp, attn_ops)
            launches += run["k2"]
            ratio = _logit_distance(run["logits"], f32["logits"]) / d_plain
            first, n_eq, n_tok = _greedy_equal(run["logits"],
                                               plain["logits"])
            same = None
            if label in twins:
                same = all(_same(a, b) for a, b in
                           zip(run["logits"], finals[twins[label]]))
            finals[label] = run["logits"]
            finite = all(bool(torch.isfinite(x).all())
                         for x in run["logits"])
            bars = {"to_f32_ratio": ratio, "first_tokens_equal": first,
                    "greedy_equal": n_eq, "greedy_total": n_tok,
                    "bits_equal_entries_of_cuda0": same,
                    "ok": (finite and ratio <= MODEL_BF16_RATIO and first
                           and same is not False)}
            report(label, cfg, run, s, bars,
                   f"logits' distance to the f32 model over the unmeshed "
                   f"run's {ratio:.4f} (bar {MODEL_BF16_RATIO}); prefill's "
                   f"greedy tokens equal {first}; {n_eq} of {n_tok} greedy "
                   f"tokens equal (teacher-forced); bits against entries "
                   f"of cuda:0 {same}")
            del run
        del plain, f32, finals

    # `Engine.generate` under the (2, 2) mesh at the short prompt
    s = SERVE_PROMPTS[0]
    prompt = _prompt(cfg.vocab_size, s)
    scfg = ServeConfig(max_new_tokens=MESH_SERVE_NEW_TOKENS)
    want_toks = Engine(model, params0, scfg).generate({"tokens": prompt})
    mesh = make_mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)
    placed = shard_params(params0, False, mesh)
    eng = Engine(model, placed, scfg)
    with use_mesh(mesh):
        Engine(model, placed, ServeConfig(max_new_tokens=2)).generate(
            {"tokens": prompt})  # warm-up
        torch.cuda.synchronize()
        attn_ops.launch_count = 0
        t0 = time.perf_counter()
        toks = eng.generate({"tokens": prompt})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2 = attn_ops.launch_count
    launches += k2
    n_eq = int((toks == want_toks).sum())
    ok = (toks.shape == (SERVE_BATCH, MESH_SERVE_NEW_TOKENS)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
          and torch.equal(toks[:, 0], want_toks[:, 0])
          and k2 == cfg.n_layers * mesh.size)
    record["generate"] = {"prompt": s, "wall_s": wall, "k2": k2,
                          "tokens_equal": n_eq, "tokens": toks.numel(),
                          "tok_per_s": toks.numel() / wall}
    log(f"mesh serve Engine.generate (2, 2) cuda:0 x 4 olmo-1b B="
        f"{SERVE_BATCH} prompt={s} new={MESH_SERVE_NEW_TOKENS}: wall "
        f"{wall:.3f} s ({toks.numel() / wall:.1f} tok/s), K2 {k2}, "
        f"{n_eq} of {toks.numel()} tokens equal the unmeshed engine's, "
        f"first tokens equal {torch.equal(toks[:, 0], want_toks[:, 0])} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("mesh serve Engine.generate")
    del model, params0, f32_model, f32_params, placed, eng
    gc.collect()
    torch.cuda.empty_cache()

    # repro-100m in f32 on (1, 4): heads replicated, or padded to 12
    model, params0 = _serve_model("repro-100m")
    cfg = model.cfg
    padded = build_model(cfg.with_(opt_pad_heads=True))
    for s in SERVE_PROMPTS:
        prompt = _prompt(cfg.vocab_size, s)
        plain = _mesh_serve_seq(model, params0, prompt, None, None,
                                attn_ops)
        launches += plain["k2"]
        del plain["cache"]
        record["unmeshed"][f"repro-100m {s}"] = _mesh_serve_timing(
            model, params0, prompt, None, cuda0)
        for label, m in (("(1, 4) cuda:0 x 4", model),
                         ("(1, 4) cuda:0 x 4 pad", padded)):
            run = _mesh_serve_run(m, params0, prompt, plain["fed"], (1, 4),
                                  ["cuda:0"] * 4, False, attn_ops)
            launches += run["k2"]
            share = max(_share(a, b, MESH_SERVE_F32_BAR)
                        for a, b in zip(run["logits"], plain["logits"]))
            first, n_eq, n_tok = _greedy_equal(run["logits"],
                                               plain["logits"])
            bars = {"f32_share_of_bar": share, "first_tokens_equal": first,
                    "greedy_equal": n_eq, "greedy_total": n_tok,
                    "ok": share <= 1.0 and first}
            report(label, m.cfg, run, s, bars,
                   f"largest logit difference at {share:.4f} of the f32 bar "
                   f"(atol {MESH_SERVE_F32_BAR} + rtol {MESH_SERVE_F32_BAR})"
                   f"; {n_eq} of {n_tok} greedy tokens equal")
            del run
        del plain
    del model, params0, padded
    gc.collect()
    torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    log(f"mesh serve: {record['seconds']:.1f} s")
    return launches, record


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
    ota_build, sass, f32_sass, wkv_build, wkv_bwd_build = build_kernels()
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
    mc_launches["large"], large_step_s, large_wall, large_res = \
        run_large_main_path(ops, "LARGE", mc, [ch], [beta], LARGE["steps"],
                            LARGE["seeds"], keep_curves=True,
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
    mc_launches["large sweep"], sweep_step_s, sweep_wall, sweep_res = \
        run_large_main_path(ops, f"LARGE sweep N={LARGE_SWEEP['n_grid']}",
                            mcs, chs, betas, LARGE_SWEEP["steps"],
                            LARGE_SWEEP["seeds"], keep_curves=True,
                            rng_plan="inscan")
    del mcs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mc, ch, beta = large_mrc_workload()
    mc_launches["large mrc"], mrc_step_s, _, _ = run_large_main_path(
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
    torch.cuda.empty_cache()
    placement_launches, placement_record = run_placement(
        ops, (large_wall, large_res), (sweep_wall, sweep_res))
    mc_launches.update(placement_launches)
    del large_res, sweep_res
    elapsed('placement')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    serve_mc_launches, serve_mc_record = run_serve_mc(ops)
    mc_launches.update(serve_mc_launches)
    elapsed('serve mc')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    transport_launches, transport_record = run_transport(ops)
    mc_launches.update(transport_launches)
    elapsed('transport')
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

    # training over the MAC: K2 with lse in every forward, K1 in every
    # transport slot
    train_launches, mc_launches["train"], train_record = run_train(
        attn_ops, ops)
    elapsed('train')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # training olmo-1b in bf16 and rwkv6-7b: K2 bf16 with lse in every
    # olmo-1b forward, K3 and the WKV backward in every rwkv6-7b layer, K1
    # in every transport slot
    model_launches, model_record = run_train_models(attn_ops, ops, wkv_ops)
    mc_launches["train models"] = model_launches["k1"]
    elapsed('train models')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # training olmo-1b on a (data x model) mesh of the card's entries: K2
    # on each entry's heads, twice a layer a step
    mesh_launches, mesh_record = run_mesh_train(attn_ops)
    elapsed('mesh train')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # serving olmo-1b and repro-100m on a (data x model) mesh of the
    # card's entries: K2 on each entry's (or padded) heads in the prefill
    mesh_serve_launches, mesh_serve_record = run_mesh_serve(attn_ops)
    elapsed('mesh serve')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # K3 and the RWKV6 serving path: one launch per layer in the prefill
    # and in each decode step
    wkv_errs = check_wkv_vs_plain()
    wkv_timings = time_wkv(wkv_errs)
    rwkv, rwkv_params, rwkv_init = build_served("rwkv6-7b")
    rwkv_served = run_serve_main_path(
        wkv_ops, rwkv, rwkv_params, kernel="wkv6",
        per_generate=rwkv.cfg.n_layers * (1 + SERVE_NEW_TOKENS))
    rwkv_routes = check_rwkv_routes(rwkv, rwkv_params)
    rwkv_times = serve_timing(rwkv, rwkv_params, "wkv6")
    elapsed('K3 and serving rwkv6-7b')
    del rwkv, rwkv_params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the window, softcap and qk-norm families (S2): K2's bf16 kernel at
    # head_dim 256 with windows and softcaps, n_layers launches a prefill
    s2_launches, s2_record = serve_s2(attn_ops)
    elapsed('serve S2')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the int8 cache and head padding (S3) on gemma-7b; hymba-1.5b,
    # whisper-small and pixtral-12b (S6, S7) through K2 at new shapes
    s3_launches, s3_record = serve_s3(attn_ops)
    elapsed('serve S3')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    s67_launches, s67_record = serve_s6_s7(attn_ops)
    elapsed('serve S6-S7')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # MoE and MLA (S4, S5): llama4-maverick (K2 in every layer's prefill)
    # and deepseek-v3 (MLA in plain PyTorch) at full width, depth cut
    s45_launches, s45_record = serve_s4_s5(attn_ops)
    elapsed('serve S4-S5')

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
        "placement": placement_record,
        "serve_mc": serve_mc_record, "transport": transport_record,
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
        "launches": sum(r["launches"] for r in served.values())
        + sum(train_launches.values()) + model_launches["k2"]
        + mesh_launches + mesh_serve_launches
        + sum(s2_launches.values()) + sum(s3_launches.values())
        + sum(s67_launches.values()) + sum(s45_launches.values()),
        "max_abs_err": max(attn_errs.values()), "tolerance": "f32 atol "
        "5e-05 + rtol 1e-04, bf16 atol 3e-02 at the slice's shapes; "
        "lse atol 1e-05 + rtol 1e-06",
        "tflops": attn_primary["tflops"],
        "ms": attn_primary["ms"], "plain_ms": attn_primary["plain_ms"],
        "bound_ms": attn_primary["bound_ms"],
        "bound_by": attn_primary["bound_by"],
        "library_ms": attn_primary["library_ms"],
        "launches_by_run": {f"olmo-1b prompt {s}": r["launches"]
                            for s, r in served.items()}
        | {"repro-100m prompt 2048 (route check)": repro_launches}
        | {f"train {name}": n for name, n in train_launches.items()}
        | {"train models (bf16, with lse, each layer recomputed)":
           model_launches["k2"]}
        | {"mesh train (olmo-1b unmeshed bf16 and f32, then on (2, 2), "
           "each entry's heads)": mesh_launches}
        | {"mesh serve (olmo-1b bf16 and f32, repro-100m unmeshed, then "
           "on (2, 2) and (1, 4), each entry's or padded heads)":
           mesh_serve_launches}
        | {f"serve S2 {run}": n for run, n in s2_launches.items()}
        | {f"serve S3 {run}": n for run, n in s3_launches.items()}
        | {f"serve S6-S7 {run}": n for run, n in s67_launches.items()}
        | {f"serve S4-S5 {run}": n for run, n in s45_launches.items()},
        "shapes": attn_timings + s2_record["attention"]
        + s67_record["attention"] + s45_record["attention"],
        "s2": s2_record, "s3": s3_record, "s6_s7": s67_record,
        "s4_s5": s45_record, "lse": train_record["attention"],
        "bf16_lse": model_record["lse_timing"],
        "bf16_lse_errors": model_record["lse_errors"],
        "train_shapes": model_record["train_attention"],
        "train": train_record, "train_models": model_record,
        "mesh_train": mesh_record, "mesh_serve": mesh_serve_record,
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
        "launches": sum(r["launches"] for r in rwkv_served.values())
        + model_launches["k3"],
        "max_abs_err": max(wkv_errs.values()), "tolerance": "bf16 o atol "
        f"{WKV_BF16_O_BAR[0]} + rtol {WKV_BF16_O_BAR[1]}, f32 state atol "
        f"{WKV_STATE_BAR[0]} + rtol {WKV_STATE_BAR[1]} at the slice's "
        "shapes",
        "ms": wkv_primary["ms"], "plain_ms": wkv_primary["plain_ms"],
        "bound_ms": wkv_primary["bound_ms"],
        "bound_by": wkv_primary["bound_by"], "library_ms": None,
        "launches_by_run": {f"rwkv6-7b prompt {s}": r["launches"]
                            for s, r in rwkv_served.items()}
        | {"train rwkv6-7b (4 layers, with checkpoints, recomputed)":
           model_launches["k3"]},
        "shapes": wkv_timings, "build": wkv_build,
        "serve": {"rwkv6-7b": {"init": rwkv_init} | {
            str(s): {**rwkv_served[s], **rwkv_routes[s], **rwkv_times[s]}
            for s in SERVE_PROMPTS}},
    }
    bwd = model_record["wkv_backward_timing"][0]
    wkv_bwd_entry = {
        "name": "wkv6_backward", "route": "cuda", "source": WKV_BWD_SOURCE,
        "replaces": WKV_BWD_REPLACES,
        "launches": model_launches["wkv_bwd"],
        "max_abs_err": max(e["abs"] for e in
                           model_record["wkv_backward_errors"].values()),
        "tolerance": f"each gradient within {WKV_BWD_BAR} of its largest "
        "magnitude, bf16 gradients plus 2^-7|g|",
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": None, "shape": bwd["shape"], "dtype": bwd["dtype"],
        "forward_ms": bwd["forward_ms"],
        "forward_ckpt_ms": bwd["forward_ckpt_ms"],
        "shapes": model_record["wkv_backward_timing"],
        "errors": model_record["wkv_backward_errors"],
        "build": wkv_bwd_build,
        "launches_by_run": {"train rwkv6-7b (4 layers)":
                            model_launches["wkv_bwd"]},
    }
    print(json.dumps({"kernels": [ota_entry, attn_entry, wkv_entry,
                                  wkv_bwd_entry]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
