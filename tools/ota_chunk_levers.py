#!/usr/bin/env python3
"""K1's antenna-chunk levers at LARGE MRC, timed in turns on one card.

    python3 tools/ota_chunk_levers.py [--reps N]

K1 (`csrc/ota_aggregate.cu`) gives each block a chunk of 8 antennas at
most, so LARGE MRC's 16 antennas take two blocks per trajectory, each
reading g[b]. This builds variants that give one block all 16 antennas
(16 accumulators a column, or 32 a column pair), made from the source by
text edits (the anchors raise if the source moved), and prints for each:
ptxas's registers and spills for its 16- or 8-antenna instantiation, its
bits against the shipped kernel at (1024, 16, 4096, 24) and its CUDA-event
time in turns beside the shipped kernel's and the einsum's:

* `shipped`: chunks of 8, column pairs, 8 loads in flight, <= 80
  registers (8 blocks of 96 threads an SM);
* `chunk16`: one chunk of 16, column pairs, 4 loads in flight, <= 80
  registers;
* `chunk16_7blocks`: the same, <= 128 registers (7 blocks an SM);
* `chunk16_columns`: one chunk of 16, one column a thread (192 threads a
  block), <= 80 registers.

Prints one JSON line, with the card's name and power limit as nvidia-smi
gives them.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (1024, 16, 4096, 24)  # LARGE MRC: B, M, N, d

PAIRS_BRANCH = "  } else if (pairs) {\n"
TUNE = """  static constexpr int kMinBlocks =
      kChunk == 1 ? (sizeof(GT) == 4 ? 6 : 5) : 3;"""


def _chunk16(src: str, vec: int, min_blocks: int) -> str:
    """The source with M > 8 on one chunk of 16 antennas."""
    for anchor in (PAIRS_BRANCH, TUNE):
        if anchor not in src:
            raise RuntimeError(f"anchor moved: {anchor!r}")
    cond = "n_ant > 8 && pairs" if vec == 2 else "n_ant > 8"
    branch = (f"  }} else if ({cond}) {{\n"
              f"    launch_chunk<GT, OT, 16, {vec}>(g, h, w, n_true, out, "
              f"batch, n_ant, n_nodes, dim, stream);\n")
    tune = TUNE.replace(": 3;", f": kChunk == 16 ? {min_blocks} : 3;")
    return src.replace(PAIRS_BRANCH, branch + PAIRS_BRANCH).replace(
        TUNE, tune)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=100)
    args = parser.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.ota import kernel

    if not torch.cuda.is_available():
        print("ota_chunk_levers: CUDA is not available", file=sys.stderr)
        return 2
    src = kernel.SOURCE.read_text()
    variants = {"shipped": (src, 8, 2),
                "chunk16": (_chunk16(src, 2, 3), 16, 2),
                "chunk16_7blocks": (_chunk16(src, 2, 2), 16, 2),
                "chunk16_columns": (_chunk16(src, 1, 3), 16, 1)}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (text, _, _) in variants.items():
        path = _build.BUILD_DIR / f"ota_lever_{name}.cu"
        path.write_text(text)
        paths[name] = (path, f"ota_lever_{name}")
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        infos = dict(zip(paths, pool.map(lambda a: _build.build(*a),
                                         paths.values())))
    fns, ptxas = {}, {}
    for name, info in infos.items():
        _, chunk, vec = variants[name]
        pattern = re.compile(rf"ota_aggregate_kernelIffLb0ELi{chunk}ELi{vec}E")
        ptxas[name] = chip_smoke.ptxas_by_kernel(
            info.log, lambda m: "k" if pattern.search(m) else None).get("k")
        fn = ctypes.CDLL(str(info.path)).ota_aggregate
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    print(f"ptxas (f32, no counts): {json.dumps(ptxas)}", flush=True)

    b, m, n, d = SHAPE
    g, h, w = chip_smoke.ota_inputs(b, n, d, torch.float32, 6, 1.0, m=m)
    outs = {k: torch.empty((b, m, d), device="cuda") for k in fns}

    def call(name):
        code = fns[name](g.data_ptr(), h.data_ptr(), w.data_ptr(), None,
                         outs[name].data_ptr(), b, m, n, d, 0, 0,
                         torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{name} launch failed: {code}")

    for name in fns:
        call(name)
    torch.cuda.synchronize()
    bits = {k: torch.equal(outs[k], outs["shipped"]) for k in fns}
    calls = {k: (lambda k=k: call(k)) for k in fns}
    calls["einsum"] = lambda: torch.einsum("bmn,bnd->bmd", h, g) / n
    names = tuple(calls)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k].append(chip_smoke.cuda_ms(calls[k], args.reps))
    bound, by = chip_smoke.ota_bound(b, n, d, m=m)
    print(f"ota chunk levers {SHAPE}: {times} (bound {bound:.6f} ms, {by}); "
          f"bits equal to shipped: {bits}", flush=True)
    print(json.dumps({"ota_chunk_levers": {
        "shape": list(SHAPE), "ms": times, "ptxas": ptxas, "bits": bits,
        "bound_ms": bound, "bound_by": by},
        "device": torch.cuda.get_device_name(0),
        "smi": chip_smoke.smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
