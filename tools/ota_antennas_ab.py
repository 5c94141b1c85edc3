#!/usr/bin/env python3
"""The OTA kernel (K1) against the kernel before its antenna-axis redesign,
on one card: bits at every main-path launch, times in turns, and what
ptxas reports for each instantiation.

    python3 tools/ota_antennas_ab.py [--parent FILE] [--reps N]

FILE is `csrc/ota_aggregate.cu` as it was before the redesign (by default
`git show a45492d:src/repro_torch/kernels/ota/csrc/ota_aggregate.cu`,
which needs the repository's history): one block per (b, m, 32 columns).
Both sources are built with one nvcc each, started together; both take
the same C interface. Then:

1. ptxas's registers, spills and static shared memory for every
   instantiation of the new kernel (raises if the report is empty or
   lacks one), and the old kernel's registers;
2. bits: the new kernel against the old at every main-path launch of
   `chip_smoke.MAIN_SHAPES` and at M = 17, 20 and 64, with and without
   per-trajectory counts (a launch's own, or N everywhere), for each
   (gradient, output) dtype pair of f32 and bf16; at LARGE MRC each
   antenna against a single-antenna launch on its gains;
3. CUDA-event times in turns (old, new, old with counts, new with counts,
   and back), each the mean of `--reps` bare ctypes launches, at LARGE
   (1024, 4096, 24), the LARGE sweep (3072, 4096, 24) and fig3 (a) (12,
   500, 90), beside the byte bound and the einsum; then at LARGE MRC
   (1024, 16, 4096, 24) the old kernel, the new one, the plain version
   and the one-call yardstick `einsum("bmn,bnd->bmd") / N` in turns.

Prints one JSON line, with the card's name and power limit as nvidia-smi
gives them. A difference in bits raises.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARENT_REV = "a45492d"
PARENT_PATH = "src/repro_torch/kernels/ota/csrc/ota_aggregate.cu"
# (B, N, d, per-row counts or None): LARGE, the LARGE sweep, fig3 (a)
SHAPES = ((1024, 4096, 24, None), (3072, 4096, 24, (1024, 2048, 4096)),
          (12, 500, 90, (50, 160, 500)))
# antenna counts off the chunks of 4, 8 and 16, and past the largest
EXTRA_SHAPES = {"M=17": (32, 17, 500, 24, None),
                "M=20": (32, 20, 257, 90, (100, 257)),
                "M=64": (8, 64, 160, 90, None)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="the kernel source before the redesign")
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.ota import kernel
    from repro_torch.kernels.ota.ref import ota_edge_aggregate_ref

    if not torch.cuda.is_available():
        print("ota_antennas_ab: CUDA is not available", file=sys.stderr)
        return 2
    build_dir = Path(_build.BUILD_DIR)
    build_dir.mkdir(parents=True, exist_ok=True)
    old_src = build_dir / "ota_aggregate_before_redesign.cu"
    old_src.write_text(Path(args.parent).read_text() if args.parent else
                       subprocess.run(
                           ["git", "show", f"{PARENT_REV}:{PARENT_PATH}"],
                           cwd=ROOT, capture_output=True, text=True,
                           check=True).stdout)
    sources = {"old": (old_src, "ota_aggregate_before_redesign"),
               "new": (kernel.SOURCE, kernel.NAME)}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        infos = dict(zip(sources, pool.map(lambda a: _build.build(*a),
                                           sources.values())))
    ptxas = chip_smoke.ota_build_summary(infos["new"])
    old_ptxas = chip_smoke.ptxas_by_kernel(
        infos["old"].log, lambda m: m.split("ota_aggregate_kernelI")[1]
        .split("EEEv")[0] if "ota_aggregate_kernelI" in m else None)
    print(f"old kernel ptxas: {json.dumps(old_ptxas)}", flush=True)
    fns = {}
    for k, info in infos.items():
        fn = ctypes.CDLL(str(info.path)).ota_aggregate
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[k] = fn

    def bare(k, g, h, w, out, counts):
        """One bare ctypes launch of build `k`: gains (B, N) or (B, M, N),
        noise and out (B, d) or (B, M, d)."""
        b, n, d = g.shape
        m = h.shape[1] if h.dim() == 3 else 1
        code = fns[k](g.data_ptr(), h.data_ptr(), w.data_ptr(),
                      None if counts is None else counts.data_ptr(),
                      out.data_ptr(), b, m, n, d,
                      int(g.dtype == torch.bfloat16),
                      int(out.dtype == torch.bfloat16),
                      torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{k} kernel launch failed: {code}")

    # 2. bits against the old kernel at every main-path launch
    pairs = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16))
    launches = {**chip_smoke.main_shapes(), **EXTRA_SHAPES}
    checked = []
    for i, (name, (b, m, n, d, per_row)) in enumerate(launches.items()):
        counts = chip_smoke.trajectory_counts(b, n, per_row)
        for gdt, odt in pairs:
            g, h, w = chip_smoke.ota_inputs(b, n, d, gdt, 40 + i, 1.0,
                                            n_true=counts, m=m)
            full = torch.full((b,), float(n), device="cuda")
            for cnt in (None, counts if counts is not None else full):
                if counts is not None and cnt is None:
                    continue  # a padded launch always passes its counts
                outs = {k: torch.empty(w.shape, dtype=odt, device="cuda")
                        for k in fns}
                for k in fns:
                    bare(k, g, h, w, outs[k], cnt)
                torch.cuda.synchronize()
                if not torch.equal(outs["new"], outs["old"]):
                    raise AssertionError(
                        f"new kernel differs from the old at {name} "
                        f"{gdt}->{odt}, counts {cnt is not None}")
        checked.append(name)
    print(f"bits equal to the old kernel at {len(checked)} launches x "
          f"{len(pairs)} dtype pairs x (no counts, counts): {checked}",
          flush=True)
    b, m, n, d = 1024, 16, 4096, 24
    g, h, w = chip_smoke.ota_inputs(b, n, d, torch.float32, 6, 1.0, m=m)
    out = torch.empty((b, m, d), device="cuda")
    bare("new", g, h, w, out, None)
    for j in range(m):
        one = torch.empty((b, d), device="cuda")
        bare("new", g, h[:, j].contiguous(), w[:, j].contiguous(), one, None)
        torch.cuda.synchronize()
        if not torch.equal(out[:, j], one):
            raise AssertionError(f"antenna {j} of {(b, m, n, d)} differs "
                                 "from a single-antenna launch")
    print(f"each antenna of {(b, m, n, d)} == a single-antenna launch",
          flush=True)

    # 3. times in turns
    rows = []
    for b, n, d, per_row in SHAPES:
        counts = chip_smoke.trajectory_counts(b, n, per_row)
        if counts is None:
            counts = torch.full((b,), float(n), device="cuda")
        g, h, w = chip_smoke.ota_inputs(b, n, d, torch.float32, 5, 1.0,
                                        n_true=counts)
        names = ("old", "new", "old+counts", "new+counts")
        outs = {k: torch.empty((b, d), device="cuda") for k in names}
        calls = {k: (lambda k=k: bare(k.split("+")[0], g, h, w, outs[k],
                                      counts if "+" in k else None))
                 for k in names}
        times = {k: [] for k in names}
        for k in names + names[::-1]:
            times[k].append(chip_smoke.cuda_ms(calls[k], args.reps))
        lib = chip_smoke.cuda_ms(
            lambda: torch.einsum("bn,bnd->bd", h, g) / counts[:, None],
            args.reps)
        bound, by = chip_smoke.ota_bound(b, n, d)
        rows.append({"shape": [b, n, d], "counts": per_row, "ms": times,
                     "einsum_ms": lib, "bound_ms": bound, "bound_by": by})
        print(f"ota A/B {(b, n, d)}: {times}, einsum / counts {lib:.6f} ms "
              f"(bound {bound:.6f} ms, {by})", flush=True)

    b, m, n, d = 1024, 16, 4096, 24
    g, h, w = chip_smoke.ota_inputs(b, n, d, torch.float32, 6, 1.0, m=m)
    outs = {k: torch.empty((b, m, d), device="cuda") for k in fns}
    calls = {"old": lambda: bare("old", g, h, w, outs["old"], None),
             "new": lambda: bare("new", g, h, w, outs["new"], None),
             "plain": lambda: ota_edge_aggregate_ref(g, h, w,
                                                     noise_scale=1.0),
             "einsum": lambda: torch.einsum("bmn,bnd->bmd", h, g) / n}
    names = tuple(calls)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k].append(chip_smoke.cuda_ms(calls[k], 50))
    bound, by = chip_smoke.ota_bound(b, n, d, m=m)
    mrc = {"shape": [b, m, n, d], "ms": times, "bound_ms": bound,
           "bound_by": by}
    print(f"ota A/B LARGE MRC {(b, m, n, d)}: {times} (bound {bound:.6f} "
          f"ms, {by})", flush=True)
    print(json.dumps({"ota_antennas_ab": rows, "large_mrc": mrc,
                      "bits_equal_at": checked, "ptxas": ptxas,
                      "old_ptxas": old_ptxas,
                      "device": torch.cuda.get_device_name(0),
                      "smi": chip_smoke.smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
