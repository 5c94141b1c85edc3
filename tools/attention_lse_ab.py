#!/usr/bin/env python3
"""K2's f32 kernel with its row log-sum-exp against the kernel before it,
on one card: bits at every f32 launch chip_smoke makes, what ptxas
reports, and times in turns.

    python3 tools/attention_lse_ab.py [--parent FILE] [--reps N]

FILE is `csrc/flash_attention.cu` as it was before the `lse` output (by
default `git show 047af9d:src/repro_torch/kernels/attention/csrc/
flash_attention.cu`, which needs the repository's history; where there
is none, write that file beforehand and pass it). Both sources are built
with one nvcc each, started together; the old one is bound with its own
C interface (no `lse` argument). Then:

1. ptxas's registers and spills for every instantiation of both
   kernels, side by side;
2. bits: at the reference tests' seven cases in f32, the serving
   prefill (4, 10, 2048, 64), the training shape (8, 10, 256, 64) and
   on (B, S, H, d) views (16-byte copies) and views off 16 bytes
   (4-byte copies), the old kernel's output against the new kernel's
   without `lse` and with it, bit for bit (a difference raises);
3. CUDA-event times in turns (old, new, new with lse, and back), each
   the mean of `--reps` bare ctypes launches, at the serving prefill and
   the training shape.

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
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARENT_REV = "047af9d"
PARENT_PATH = "src/repro_torch/kernels/attention/csrc/flash_attention.cu"
TIMED = ((4, 10, 2048, 64), (8, 10, 256, 64))


def _key(mangled: str):
    m = re.search(r"flash_attention_kernelILi(\d+)ELb(\d)E", mangled)
    if not m:
        return None
    return f"d={m.group(1)} copy={16 if m.group(2) == '1' else 4}"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="the kernel source before the lse output")
    parser.add_argument("--reps", type=int, default=100)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import kernel

    if not torch.cuda.is_available():
        print("attention_lse_ab: CUDA is not available", file=sys.stderr)
        return 2
    if args.parent:
        old_text = Path(args.parent).read_text()
    else:
        old_text = subprocess.run(
            ["git", "show", f"{PARENT_REV}:{PARENT_PATH}"], cwd=ROOT,
            capture_output=True, text=True, check=True).stdout
    old_src = _build.BUILD_DIR / "lse_ab" / "flash_attention_parent.cu"
    old_src.parent.mkdir(parents=True, exist_ok=True)
    old_src.write_text(old_text)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        f_new = pool.submit(kernel.build)
        f_old = pool.submit(_build.build, old_src, old_src.stem)
        info_new, info_old = f_new.result(), f_old.result()
    ptxas = {"new": chip_smoke.ptxas_by_kernel(info_new.log, _key),
             "old": chip_smoke.ptxas_by_kernel(info_old.log, _key)}
    chip_smoke.log(f"ptxas per instantiation: {json.dumps(ptxas)}")
    if set(ptxas["new"]) != set(ptxas["old"]) or not ptxas["new"]:
        raise AssertionError("ptxas reports differ in instantiations")

    new_fn = kernel.bind_library(ctypes.CDLL(str(info_new.path)), False)[0]
    old_fn = getattr(ctypes.CDLL(str(info_old.path)), "flash_attention")
    old_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] \
        + [ctypes.c_int]
    old_fn.restype = ctypes.c_int

    def run(fn, q, k, v, out, kw, lse=None):
        strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                          for s in t.stride()[:3]))
        b, h, sq, d = q.shape
        extra = () if fn is old_fn else (
            None if lse is None else lse.data_ptr(),)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  ctypes.addressof(strides), b, h, h // k.shape[1], sq,
                  k.shape[2], d, d ** -0.5, kw.get("softcap") or 0.0,
                  int(kw.get("causal", True)), kw.get("window") or 0,
                  torch.cuda.current_stream().cuda_stream,
                  kernel.copy_bytes(q, k, v, out), *extra)
        if code:
            raise RuntimeError(f"launch failed: {code}")

    cases = [(f"test {i}", b, hq, hkv, s, d, kw) for i, (b, hq, hkv, s, d, kw)
             in enumerate(chip_smoke.ATTN_TEST_SHAPES)]
    cases += [("serving prefill", 4, 10, 10, 2048, 64, {}),
              ("training", 8, 10, 10, 256, 64, {})]
    bits = {}
    for label, b, hq, hkv, s, d, kw in cases:
        views = {"contiguous": chip_smoke.attn_inputs(
            b, hq, hkv, s, d, torch.float32, 500 + s)}
        if label == "training":
            gen = torch.Generator(device="cuda").manual_seed(6)
            for name, row, col in (("views", d, 0), ("views off 16 B",
                                                      d + 4, 1)):
                views[name] = tuple(
                    torch.randn((b, s, h, row), generator=gen,
                                device="cuda")[..., col:col + d]
                    .transpose(1, 2) for h in (hq, hkv, hkv))
        for vname, (q, k, v) in views.items():
            outs = []
            for fn, with_lse in ((old_fn, False), (new_fn, False),
                                 (new_fn, True)):
                out = torch.full((b, hq, s, d), float("nan"),
                                 device="cuda")
                lse = torch.empty((b * hq, s), device="cuda") \
                    if with_lse else None
                run(fn, q, k, v, out, kw, lse)
                outs.append(out)
            torch.cuda.synchronize()
            same = torch.equal(outs[0], outs[1]) and torch.equal(outs[0],
                                                                 outs[2])
            bits[f"{label} {vname}"] = same
            chip_smoke.log(f"{label} {vname} q{(b, hq, s, d)} kv"
                           f"{(b, hkv, s, d)} {kw} "
                           f"({kernel.copy_bytes(q, k, v)}-byte copies): "
                           f"old == new == new with lse bitwise: {same}")
            if not same:
                raise AssertionError(f"bits differ at {label} {vname}")

    times = {}
    for shape in TIMED:
        b, h, s, d = shape
        q, k, v = chip_smoke.attn_inputs(b, h, h, s, d, torch.float32, 7)
        out = torch.empty_like(q)
        lse = torch.empty((b * h, s), device="cuda")
        calls = {"old": lambda: run(old_fn, q, k, v, out, {}),
                 "new": lambda: run(new_fn, q, k, v, out, {}),
                 "new with lse": lambda: run(new_fn, q, k, v, out, {}, lse)}
        row = {name: [] for name in calls}
        for name in list(calls) + list(calls)[::-1]:
            row[name].append(chip_smoke.cuda_ms(calls[name], args.reps))
        times[str(shape)] = row
        chip_smoke.log(f"times at {shape}: {json.dumps(row)}")
    print(json.dumps({"card": chip_smoke.smi_line(), "ptxas": ptxas,
                      "bits": bits, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
