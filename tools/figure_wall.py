#!/usr/bin/env python3
"""Wall time and OTA-kernel launches of one figure twin on the card, for
comparing two trees of the port in one call.

    python3 tools/figure_wall.py --src DIR [--figure fig3] [--reps 2]

Imports `repro_torch` from `DIR/src` (this checkout, or another one such
as the parent commit unpacked with `git archive` into `build/prev/`),
runs `repro_torch.figures.run_<figure>(device="cuda")` once to build and
warm up, then `--reps` times on the host clock, each ending in the rows'
device-to-host copy, with the kernel's launch count set to 0 before
each. Prints one JSON line with the card's name and power limit as
nvidia-smi gives them. Run it for two trees in turns (parent, change,
change, parent): host-bound walls compare only within one call.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", required=True,
                        help="checkout whose src/ holds repro_torch")
    parser.add_argument("--figure", default="fig3")
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    import torch

    from repro_torch import figures
    from repro_torch.kernels.ota import ops

    if not torch.cuda.is_available():
        print("figure_wall: CUDA is not available", file=sys.stderr)
        return 2
    run = getattr(figures, f"run_{args.figure}")
    run(device="cuda")
    walls, launches = [], []
    for _ in range(args.reps):
        ops.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = run(device="cuda")
        walls.append(time.perf_counter() - t0)
        launches.append(ops.launch_count)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"src": os.path.abspath(args.src),
                      "figure": args.figure, "wall_s": walls,
                      "ota_launches": launches, "rows": len(rows),
                      "smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
