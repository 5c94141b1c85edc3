#!/usr/bin/env python3
"""The OTA kernel (K1) before and after it took an antenna axis, timed in
turns on one card, with its bits held to the kernel before.

    python3 tools/ota_antennas_ab.py [--parent FILE]

FILE is `csrc/ota_aggregate.cu` as it was before the antenna axis (by
default `git show b19a10b:src/repro_torch/kernels/ota/csrc/
ota_aggregate.cu`, which needs the repository's history). Both sources
are built with one nvcc each, started together. At LARGE (1024, 4096,
24), the LARGE node-count sweep's (3072, 4096, 24) and fig3's (12, 500,
90) launch, f32:

1. the new kernel at M = 1 without and with per-trajectory counts against
   the old kernel's two instantiations: equal bits;
2. CUDA-event times in turns (old, new, old with counts, new with counts,
   and back), each the mean of `--reps` launches, beside the byte bound.
   Every launch is one bare ctypes call, so the Python wrapper's cost is
   the same on both sides (through `kernel.launch` the new kernel read a
   few µs slower at fig3's launch, which is launch-bound).

Then the antenna axis alone at LARGE MRC (B, M, N, d) = (1024, 16, 4096,
24): each antenna's bits against a single-antenna launch on its gains,
and in turns the kernel, its plain version and the one-call yardstick
`einsum("bmn,bnd->bmd") / N`, beside the byte bound (g read once).

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
PARENT_REV = "b19a10b"
PARENT_PATH = "src/repro_torch/kernels/ota/csrc/ota_aggregate.cu"
# (B, N, d, per-row counts or None): LARGE, the LARGE sweep, fig3 (a)
SHAPES = ((1024, 4096, 24, None), (3072, 4096, 24, (1024, 2048, 4096)),
          (12, 500, 90, (50, 160, 500)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="the kernel source before the antenna axis")
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
    old_src = build_dir / "ota_aggregate_before_antennas.cu"
    old_src.write_text(Path(args.parent).read_text() if args.parent else
                       subprocess.run(
                           ["git", "show", f"{PARENT_REV}:{PARENT_PATH}"],
                           cwd=ROOT, capture_output=True, text=True,
                           check=True).stdout)
    sources = {"old": (old_src, "ota_aggregate_before_antennas"),
               "new": (kernel.SOURCE, kernel.NAME)}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        infos = dict(zip(sources, pool.map(lambda a: _build.build(*a),
                                           sources.values())))
    fns = {}
    for k, info in infos.items():
        fn = ctypes.CDLL(str(info.path)).ota_aggregate
        n_ints = 5 if k == "old" else 6  # the old C interface has no M
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_ints \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[k] = fn

    def bare(k, g, h, w, out, counts):
        """One bare ctypes launch of build `k` (M from the gains)."""
        b, n, d = g.shape
        m = () if k == "old" else (h.shape[1] if h.dim() == 3 else 1,)
        code = fns[k](g.data_ptr(), h.data_ptr(), w.data_ptr(),
                      None if counts is None else counts.data_ptr(),
                      out.data_ptr(), b, *m, n, d, 0, 0,
                      torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{k} kernel launch failed: {code}")

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
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        for k in names:
            before = "old+counts" if "+" in k else "old"
            if not torch.equal(outs[k], outs[before]):
                raise AssertionError(f"{k} differs from {before} at "
                                     f"{(b, n, d)}")
        times = {k: [] for k in names}
        for k in names + names[::-1]:
            times[k].append(chip_smoke.cuda_ms(calls[k], args.reps))
        bound, by = chip_smoke.ota_bound(b, n, d)
        rows.append({"shape": [b, n, d], "counts": per_row, "bits": "equal",
                     "ms": times, "bound_ms": bound, "bound_by": by})
        print(f"ota antennas A/B {(b, n, d)}: {times} (bound {bound:.6f} "
              f"ms, {by})", flush=True)

    b, m, n, d = 1024, 16, 4096, 24
    g, _, _ = chip_smoke.ota_inputs(b, n, d, torch.float32, 6, 1.0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    h = torch.rand((b, m, n), generator=gen, device="cuda")
    w = torch.randn((b, m, d), generator=gen, device="cuda")
    out = torch.empty((b, m, d), device="cuda")
    bare("new", g, h, w, out, None)
    for j in (0, m - 1):
        one = torch.empty((b, d), device="cuda")
        bare("new", g, h[:, j].contiguous(), w[:, j].contiguous(), one, None)
        torch.cuda.synchronize()
        if not torch.equal(out[:, j], one):
            raise AssertionError(f"antenna {j} differs from a "
                                 "single-antenna launch")
    calls = {"kernel": lambda: bare("new", g, h, w, out, None),
             "plain": lambda: ota_edge_aggregate_ref(g, h, w,
                                                     noise_scale=1.0),
             "einsum": lambda: torch.einsum("bmn,bnd->bmd", h, g) / n}
    names = tuple(calls)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k].append(chip_smoke.cuda_ms(calls[k], 50))
    bound, by = chip_smoke.ota_bound(b, n, d, m=m)
    mrc = {"shape": [b, m, n, d], "bits": "each antenna equal", "ms": times,
           "bound_ms": bound, "bound_by": by}
    print(f"ota antenna axis {(b, m, n, d)}: {times} (bound {bound:.6f} "
          f"ms, {by})", flush=True)
    print(json.dumps({"ota_antennas_ab": rows, "large_mrc": mrc, "device":
                      torch.cuda.get_device_name(0),
                      "smi": chip_smoke.smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
