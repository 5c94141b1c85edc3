#!/usr/bin/env python3
"""One of K2's kernels with its row log-sum-exp against the kernel before
it, on one card: bits at every launch chip_smoke makes in its dtype,
what ptxas reports, and times in turns.

    python3 tools/attention_lse_ab.py [--kernel f32|bf16] [--parent FILE]
                                      [--reps N]

`--kernel f32` (the default): FILE is `csrc/flash_attention.cu` as it
was before the `lse` output (by default `git show 047af9d:src/
repro_torch/kernels/attention/csrc/flash_attention.cu`). `--kernel bf16`:
FILE is `csrc/flash_attention_sm90.cu` before its `lse` output (by
default `git show e0f2972:src/repro_torch/kernels/attention/csrc/
flash_attention_sm90.cu`). The defaults need the repository's history;
where there is none, write the file beforehand and pass it. Both sources
are built with one nvcc each, started together; the old one is bound
with its own C interface (no `lse` argument). Then:

1. ptxas's registers and spills for every instantiation of both
   kernels, side by side;
2. bits: at the reference tests' seven cases in the kernel's dtype, at
   the shapes its main paths give it (f32: repro-100m's serving prefill
   (4, 10, 2048, 64) and training shape (8, 10, 256, 64), also on
   (B, S, H, d) views (16-byte copies) and views off 16 bytes (4-byte
   copies); bf16: olmo-1b's 32- and 2048-token prefills (4, 16, 32, 128)
   and (4, 16, 2048, 128) and its training shape (8, 16, 256, 128), also
   on (B, S, H, d) views), the old kernel's output against the new
   kernel's without `lse` and with it, bit for bit (a difference
   raises);
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
CSRC = "src/repro_torch/kernels/attention/csrc/"
# per kernel: (parent revision, source, the launches chip_smoke makes
# beside the reference cases (label, b, hq, hkv, s, d), the timed shapes)
KERNELS = {
    "f32": ("047af9d", CSRC + "flash_attention.cu",
            (("serving prefill", 4, 10, 10, 2048, 64),
             ("training", 8, 10, 10, 256, 64)),
            ((4, 10, 2048, 64), (8, 10, 256, 64))),
    "bf16": ("e0f2972", CSRC + "flash_attention_sm90.cu",
             (("serving prefill 32", 4, 16, 16, 32, 128),
              ("serving prefill 2048", 4, 16, 16, 2048, 128),
              ("training", 8, 16, 16, 256, 128)),
             ((4, 16, 2048, 128), (8, 16, 256, 128))),
}


def _key(mangled: str):
    m = re.search(r"flash_attention_kernelILi(\d+)ELb(\d)E", mangled)
    if not m:
        return None
    return f"d={m.group(1)} copy={16 if m.group(2) == '1' else 4}"


def _key_sm90(mangled: str):
    m = re.search(r"flash_attention_sm90_kernelILi(\d+)ELb(\d)E", mangled)
    if not m:
        return None
    return f"d={m.group(1)} softcap={m.group(2)}"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", choices=tuple(KERNELS), default="f32")
    parser.add_argument("--parent", default=None,
                        help="the kernel source before the lse output")
    parser.add_argument("--reps", type=int, default=100)
    args = parser.parse_args()
    bf16 = args.kernel == "bf16"
    parent_rev, parent_path, main_shapes, timed = KERNELS[args.kernel]
    dtype_name = "bfloat16" if bf16 else "float32"
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
            ["git", "show", f"{parent_rev}:{parent_path}"], cwd=ROOT,
            capture_output=True, text=True, check=True).stdout
    name = kernel.SM90_NAME if bf16 else kernel.NAME
    old_src = _build.BUILD_DIR / "lse_ab" / f"{name}_parent.cu"
    old_src.parent.mkdir(parents=True, exist_ok=True)
    old_src.write_text(old_text)
    key = _key_sm90 if bf16 else _key
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        f_new = pool.submit(kernel.build_sm90 if bf16 else kernel.build)
        f_old = pool.submit(_build.build, old_src, old_src.stem)
        info_new, info_old = f_new.result(), f_old.result()
    ptxas = {"new": chip_smoke.ptxas_by_kernel(info_new.log, key),
             "old": chip_smoke.ptxas_by_kernel(info_old.log, key)}
    chip_smoke.log(f"ptxas per instantiation: {json.dumps(ptxas)}")
    if set(ptxas["new"]) != set(ptxas["old"]) or not ptxas["new"]:
        raise AssertionError("ptxas reports differ in instantiations")

    new_fn = kernel.bind_library(ctypes.CDLL(str(info_new.path)), bf16)[0]
    old_fn = getattr(ctypes.CDLL(str(info_old.path)), name)
    old_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] \
        + [ctypes.c_int] * (not bf16)
    old_fn.restype = ctypes.c_int

    def run(fn, q, k, v, out, kw, lse=None):
        strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                          for s in t.stride()[:3]))
        b, h, sq, d = q.shape
        extra = () if bf16 else (kernel.copy_bytes(q, k, v, out),)
        if fn is not old_fn:
            extra += (None if lse is None else lse.data_ptr(),)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  ctypes.addressof(strides), b, h, h // k.shape[1], sq,
                  k.shape[2], d, d ** -0.5, kw.get("softcap") or 0.0,
                  int(kw.get("causal", True)), kw.get("window") or 0,
                  torch.cuda.current_stream().cuda_stream, *extra)
        if code:
            raise RuntimeError(f"launch failed: {code}")

    dtype = getattr(torch, dtype_name)
    cases = [(f"test {i}", b, hq, hkv, s, d, kw) for i, (b, hq, hkv, s, d, kw)
             in enumerate(chip_smoke.ATTN_TEST_SHAPES)]
    cases += [(*shape, {}) for shape in main_shapes]
    bits = {}
    for label, b, hq, hkv, s, d, kw in cases:
        views = {"contiguous": chip_smoke.attn_inputs(
            b, hq, hkv, s, d, dtype, 500 + s)}
        if label == "training":
            gen = torch.Generator(device="cuda").manual_seed(6)
            offsets = (("views", d, 0),) if bf16 else (
                ("views", d, 0), ("views off 16 B", d + 4, 1))
            for vname, row, col in offsets:
                views[vname] = tuple(
                    torch.randn((b, s, h, row), generator=gen,
                                device="cuda")[..., col:col + d].to(dtype)
                    .transpose(1, 2) for h in (hq, hkv, hkv))
        for vname, (q, k, v) in views.items():
            outs = []
            for fn, with_lse in ((old_fn, False), (new_fn, False),
                                 (new_fn, True)):
                out = torch.full((b, hq, s, d), float("nan"),
                                 device="cuda").to(dtype)
                lse = torch.empty((b * hq, s), device="cuda") \
                    if with_lse else None
                run(fn, q, k, v, out, kw, lse)
                outs.append(out)
            torch.cuda.synchronize()
            same = torch.equal(outs[0], outs[1]) and torch.equal(outs[0],
                                                                 outs[2])
            bits[f"{label} {vname}"] = same
            copies = "TMA" if bf16 else \
                f"{kernel.copy_bytes(q, k, v)}-byte copies"
            chip_smoke.log(f"{label} {vname} {dtype_name} q{(b, hq, s, d)} "
                           f"kv{(b, hkv, s, d)} {kw} ({copies}): old == new "
                           f"== new with lse bitwise: {same}")
            if not same:
                raise AssertionError(f"bits differ at {label} {vname}")

    times = {}
    for shape in timed:
        b, h, s, d = shape
        q, k, v = chip_smoke.attn_inputs(b, h, h, s, d, dtype, 7)
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
    print(json.dumps({"card": chip_smoke.smi_line(), "kernel": args.kernel,
                      "ptxas": ptxas,
                      "bits": bits, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
