#!/usr/bin/env python3
"""K3 with its training instantiation (chunk checkpoints) against the
kernel before it, on one card: bits and times in turns.

    python3 tools/wkv6_ckpt_ab.py [--parent FILE] [--reps N]

FILE is `csrc/wkv6.cu` as it was before the checkpoint output (by default
`git show e0f2972:src/repro_torch/kernels/wkv/csrc/wkv6.cu`, which needs
the repository's history; where there is none, write that file
beforehand and pass it). Both sources are built with one nvcc each,
started together; the old one is bound with its own C interface (no
checkpoint pointer). At rwkv6-7b's prefill (4, 64, 2048, 64), decode
step (4, 64, 1, 64) and training shape (8, 64, 256, 64), bf16 on the
model's (B, T, H, D) views: o and the final state of the old kernel, the
new one without checkpoints (the serving instantiation) and with them,
bit for bit (a difference raises); then CUDA-event times in turns (old,
new, new with checkpoints, and back), each the mean of `--reps` launches
(500 at the decode step).

Prints one JSON line, with the card's name and power limit as nvidia-smi
gives them.
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
PARENT_REV = "e0f2972"
PARENT_PATH = "src/repro_torch/kernels/wkv/csrc/wkv6.cu"
SHAPES = ((4, 64, 2048, 64), (4, 64, 1, 64), (8, 64, 256, 64))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="the kernel source before the checkpoints")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch

    import chip_smoke
    import wkv6_levers
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import kernel

    if not torch.cuda.is_available():
        print("wkv6_ckpt_ab: CUDA is not available", file=sys.stderr)
        return 2
    if args.parent:
        old_text = Path(args.parent).read_text()
    else:
        old_text = subprocess.run(
            ["git", "show", f"{PARENT_REV}:{PARENT_PATH}"], cwd=ROOT,
            capture_output=True, text=True, check=True).stdout
    old_src = _build.BUILD_DIR / "ckpt_ab" / "wkv6_parent.cu"
    old_src.parent.mkdir(parents=True, exist_ok=True)
    old_src.write_text(old_text)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        f_old = pool.submit(_build.build, old_src, old_src.stem)
        f_new = pool.submit(kernel.build)
        info_old, info_new = f_old.result(), f_new.result()
    # the levers tool binds a source older than the checkpoint pointer
    libs = {name: wkv6_levers.bind_library(ctypes.CDLL(str(info.path)))
            for name, info in (("old", info_old), ("new", info_new))}
    shipped = kernel._bound
    out = {"card": chip_smoke.smi_line()}
    try:
        for shape in SHAPES:
            b, h, t, d = shape
            r, k, v, w, u, s0 = chip_smoke.wkv_inputs(
                b, h, t, d, torch.bfloat16, 7, layout="bthd")
            o = torch.empty((b, t, h, d), dtype=torch.bfloat16,
                            device="cuda").transpose(1, 2)
            s_out = torch.empty_like(s0)
            ckpt = torch.empty((b, h, kernel.n_ckpt(t), d, d),
                               device="cuda")

            def run(name, with_ckpt=False):
                kernel._bound = libs[name]
                kernel.launch(r, k, v, w, u, s0, s_out, o,
                              ckpt=ckpt if with_ckpt else None)

            results = []
            for name, with_ckpt in (("old", False), ("new", False),
                                    ("new", True)):
                run(name, with_ckpt)
                torch.cuda.synchronize()
                results.append((o.clone(), s_out.clone()))
            same = all(torch.equal(results[0][i], x[i])
                       for x in results[1:] for i in (0, 1))
            if not same:
                raise AssertionError(f"bits differ at {shape}")
            calls = {"old": lambda: run("old"), "new": lambda: run("new"),
                     "new with checkpoints": lambda: run("new", True)}
            reps = args.reps if t > 1 else 500
            row = {name: [] for name in calls}
            for name in list(calls) + list(calls)[::-1]:
                row[name].append(chip_smoke.cuda_ms(calls[name], reps))
            out[str(shape)] = {"bits_equal": same, "ms": row}
            chip_smoke.log(f"K3 {shape} bf16: old == new == new with "
                           f"checkpoints bitwise: {same}; ms in turns "
                           f"{json.dumps(row)}")
    finally:
        kernel._bound = shipped
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
