#!/usr/bin/env python3
"""The per-layer recompute (`cfg.remat`) against no recompute, on one
card: a training step's time, its peak memory and its kernel launches,
in turns.

    python3 tools/remat_ab.py [--steps N] [--archs A,B,...]

For each model (by default olmo-1b at full width and depth, rwkv6-7b at
full width with 4 of its 32 layers, as chip_smoke's "train models" trains
them, and hymba-1.5b at full width with 4 of its 32 layers, whose 32
layers do not fit the card without the recompute), the fused gbma route
at the training launcher's defaults (B = 8, S = 256, N = 8, momentum, lr
0.05) runs `--steps` steps (3) from the same parameters with the
recompute off, on, on, off. Each run reports its step times (host clock,
each step ending in a synchronize; the better of the last 2), the peak
device memory over the resident parameters and state during step 2, and
K2's, K3's and the WKV backward's launches. The losses of the runs must
be equal bit for bit (the recompute changes no value).

Prints one JSON line, with the card's name and power limit as nvidia-smi
gives them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (arch, layers or None for the config's own)
DEFAULT_ARCHS = ("olmo-1b", "rwkv6-7b:4", "hymba-1.5b:4")


def run(cs, cfg, params0, batches, mods) -> dict:
    import torch

    from repro_torch.core.tree import tree_map

    _, _, _, step = cs._train_parts(cfg, "gbma", "auto", "auto")
    params = tree_map(lambda p: p.clone(), params0)
    state = step.init_state(params)
    cs._reset_counts(*mods)
    step_ms, losses, peak = [], [], 0.0
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch, i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        losses.append(float(metrics["loss"]))
    counts = cs._counts(*mods)
    del params, state
    torch.cuda.empty_cache()
    return {"remat": cfg.remat, "step_ms": min(step_ms[-2:]),
            "step_ms_all": step_ms, "peak_mib_over_resident": peak,
            "launches": counts, "losses": losses}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--archs", default=",".join(DEFAULT_ARCHS),
                    help="comma-separated arch[:layers]")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("remat_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ota import ops as ota_ops
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.models.model import build_model

    mods = (attn_ops, ota_ops, wkv_ops)
    out = {"device": cs.smi_line(), "steps": args.steps, "models": {}}
    for spec in args.archs.split(","):
        arch, _, layers = spec.partition(":")
        cfg = get_config(arch)
        if layers:
            cfg = cfg.with_(n_layers=int(layers))
        params0 = build_model(cfg).init_params(device="cuda")
        batches = [cs._on_card(b) for b in cs._train_batches(cfg,
                                                            args.steps)]
        runs = []
        for flag in (False, True, True, False):
            row = run(cs, cfg.with_(remat=flag), params0, batches, mods)
            cs.log(f"remat_ab {arch} ({cfg.n_layers} layers) remat {flag}: "
                   f"{json.dumps(row)}")
            runs.append(row)
        same = all(r["losses"] == runs[0]["losses"] for r in runs)
        out["models"][f"{arch} ({cfg.n_layers} layers)"] = {
            "runs": runs, "losses_equal": same}
        if not same:
            raise AssertionError(f"{arch}: the recompute changed the loss")
        del params0, batches
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
