#!/usr/bin/env python3
"""The OTA kernel (K1) before and after it took a per-trajectory count,
timed in turns on one card, with its bits held to the kernel before.

    python3 tools/ota_counts_ab.py [--parent FILE]

FILE is `csrc/ota_aggregate.cu` as it was before the count became a (B,)
tensor (by default `git show b2b28d1:src/repro_torch/kernels/ota/csrc/
ota_aggregate.cu`, which needs the repository's history). Both sources are
built with one nvcc each, started together. At LARGE (1024, 4096, 24),
the LARGE node-count sweep's (3072, 4096, 24) and fig3's (12, 500, 90)
launch, f32:

1. the new kernel without counts and with a count of N for every
   trajectory against the old kernel: equal bits;
2. CUDA-event times in turns (old, new, new with counts, einsum, and
   back: einsum, new with counts, new, old), each the mean of `--reps`
   launches, beside the byte bound.

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
PARENT_REV = "b2b28d1"
PARENT_PATH = "src/repro_torch/kernels/ota/csrc/ota_aggregate.cu"
SHAPES = ((1024, 4096, 24), (3072, 4096, 24), (12, 500, 90))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="the kernel source before the count tensor")
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.ota import kernel

    if not torch.cuda.is_available():
        print("ota_counts_ab: CUDA is not available", file=sys.stderr)
        return 2
    old_src = Path(_build.BUILD_DIR) / "ota_aggregate_parent.cu"
    old_src.parent.mkdir(parents=True, exist_ok=True)
    old_src.write_text(Path(args.parent).read_text() if args.parent else
                       subprocess.run(
                           ["git", "show", f"{PARENT_REV}:{PARENT_PATH}"],
                           cwd=ROOT, capture_output=True, text=True,
                           check=True).stdout)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(_build.build, old_src, "ota_aggregate_parent"),
                  pool.submit(kernel.build)]
        for b in builds:
            b.result()
    old = ctypes.CDLL(str(_build.build(old_src, "ota_aggregate_parent")
                          .path)).ota_aggregate
    old.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    old.restype = ctypes.c_int

    def old_launch(g, h, w, out):
        b, n, d = g.shape
        stream = torch.cuda.current_stream().cuda_stream
        code = old(g.data_ptr(), h.data_ptr(), w.data_ptr(), out.data_ptr(),
                   b, n, d, n, 0, 0, stream)
        if code:
            raise RuntimeError(f"old kernel launch failed: {code}")

    rows = []
    for b, n, d in SHAPES:
        g, h, w = chip_smoke.ota_inputs(b, n, d, torch.float32, 5, 1.0)
        counts = torch.full((b,), float(n), device="cuda")
        outs = {k: torch.empty((b, d), device="cuda")
                for k in ("old", "new", "new+counts")}
        fns = {"old": lambda: old_launch(g, h, w, outs["old"]),
               "new": lambda: kernel.launch(g, h, w, outs["new"]),
               "new+counts": lambda: kernel.launch(g, h, w,
                                                   outs["new+counts"],
                                                   counts),
               "einsum": lambda: torch.einsum("bn,bnd->bd", h, g)}
        for name in ("old", "new", "new+counts"):
            fns[name]()
        torch.cuda.synchronize()
        for name in ("new", "new+counts"):
            if not torch.equal(outs[name], outs["old"]):
                raise AssertionError(f"{name} differs from the old kernel "
                                     f"at {(b, n, d)}")
        order = ("old", "new", "new+counts", "einsum")
        times = {k: [] for k in order}
        for name in order + order[::-1]:
            times[name].append(chip_smoke.cuda_ms(fns[name], args.reps))
        bound, by = chip_smoke.ota_bound(b, n, d)
        rows.append({"shape": [b, n, d], "bits": "equal", "ms": times,
                     "bound_ms": bound, "bound_by": by})
        print(f"ota A/B {(b, n, d)}: {times} (bound {bound:.6f} ms, {by})",
              flush=True)
    print(json.dumps({"ota_counts_ab": rows, "device":
                      torch.cuda.get_device_name(0),
                      "smi": chip_smoke.smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
