#!/usr/bin/env python3
"""The WKV backward kernel against the kernel before its redesign, on one
card: gradients against the plain backward, bits across launches, and
times in turns.

    python3 tools/wkv6_bwd_ab.py [--parent FILE] [--reps N]

FILE is `csrc/wkv6_bwd.cu` before the redesign (by default `git show
f7dbddb:src/repro_torch/kernels/wkv/csrc/wkv6_bwd.cu`, which needs the
repository's history; where there is none, write that file beforehand
and pass it). Two backward libraries are built with one nvcc each,
started together beside K3: the kernel as shipped (row groups across
blocks, each chunk's states on chip, dv's per-group partials summed by a
second pass) and the parent (one block a (batch, head), a chunk's states
in a device-memory scratch), which is bound with its own C interface (a
scratch pointer where the partials' is now). ptxas's registers, spills
and shared memory per instantiation are printed for each.

At rwkv6-7b's training shape (8, 64, 256, 64) and a transport node's
(1, 64, 256, 64), in bf16 and f32 on the model's (B, T, H, D) views, with
a nonzero initial state and cotangent of the final state: every gradient
of each kernel within 1e-4 of its largest magnitude of the plain
backward's (plus one bf16 rounding, 2^-7·|g|, of the four bf16 ones; a
miss raises); the bits differ between the two kernels by their summation
order, and each kernel's two launches give equal bits. Then CUDA-event
times in turns (parent, new, new, parent), each the mean of
`--reps` launches, with training's arguments (no initial state, no
cotangent of the final state, no ds0), beside the bound.

Prints one JSON line, with the card's name and power limit as nvidia-smi
gives them. Imports nothing of the JAX package.
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
PARENT_REV = "f7dbddb"
PARENT_PATH = "src/repro_torch/kernels/wkv/csrc/wkv6_bwd.cu"
SHAPES = ((8, 64, 256, 64), (1, 64, 256, 64))
DTYPES = ("bfloat16", "float32")
BAR = 1e-4


def parent_summary(info) -> dict:
    """The parent build's ptxas registers and spills per instantiation,
    keyed "<dtype> d=<head_dim>", with its shared memory."""
    import chip_smoke
    from repro_torch.kernels.wkv import kernel

    def key(mangled):
        m = re.search(r"wkv6_bwd_kernelI(13__nv_bfloat16|f)Li(\d+)EE",
                      mangled)
        if not m:
            return None
        return f"{'bf16' if m.group(1) != 'f' else 'f32'} d={m.group(2)}"

    out = chip_smoke.ptxas_by_kernel(info.log, key)
    fn = ctypes.CDLL(str(info.path)).wkv6_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    for dt in ("f32", "bf16"):
        for d in kernel.HEAD_DIMS:
            out.setdefault(f"{dt} d={d}", {})["smem_bytes"] = fn(d)
    return out


def bind_parent(lib: ctypes.CDLL):
    """The parent's launch: its scratch pointer where the partials' is
    now."""
    fn = lib.wkv6_backward
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="the backward kernel's source before the "
                        "redesign")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import kernel
    from repro_torch.kernels.wkv import ops as wkv_ops

    if not torch.cuda.is_available():
        print("wkv6_bwd_ab: CUDA is not available", file=sys.stderr)
        return 2
    if args.parent:
        parent_text = Path(args.parent).read_text()
    else:
        parent_text = subprocess.run(
            ["git", "show", f"{PARENT_REV}:{PARENT_PATH}"], cwd=ROOT,
            capture_output=True, text=True, check=True).stdout
    work = _build.BUILD_DIR / "bwd_ab"
    work.mkdir(parents=True, exist_ok=True)
    parent_src = work / "wkv6_bwd_parent.cu"
    parent_src.write_text(parent_text)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = {"forward": pool.submit(kernel.build),
                "new": pool.submit(kernel.build_backward),
                "parent": pool.submit(_build.build, parent_src,
                                      parent_src.stem)}
        infos = {name: f.result() for name, f in futs.items()}
    out = {"card": chip_smoke.smi_line(), "build": {
        "new": chip_smoke.wkv_bwd_build_summary(infos["new"]),
        "parent": parent_summary(infos["parent"])}}
    for name in ("new", "parent"):
        out["build"][name]["nvcc_s"] = infos[name].seconds
        chip_smoke.log(f"wkv6_bwd_ab build {name}: "
                       f"{json.dumps(out['build'][name])}")

    parent_fn = bind_parent(ctypes.CDLL(str(infos["parent"].path)))
    for shape in SHAPES:
        b, h, t, d = shape
        for dt in DTYPES:
            dtype = getattr(torch, dt)
            r, k, v, w, u, s0 = chip_smoke.wkv_inputs(
                b, h, t, d, dtype, 17, layout="bthd")
            gen = torch.Generator(device="cuda").manual_seed(5)
            do = torch.randn(r.shape, generator=gen, device="cuda").to(dtype)
            ds_fin = torch.randn(s0.shape, generator=gen, device="cuda")
            ckpt = torch.empty((b, h, kernel.n_ckpt(t), d, d), device="cuda")
            ckpt0 = torch.empty_like(ckpt)
            s_out = torch.empty_like(s0)
            o = torch.empty((b, t, h, d), dtype=dtype,
                            device="cuda").transpose(1, 2)
            kernel.launch(r, k, v, w, u, s0, s_out, o, ckpt=ckpt)
            kernel.launch(r, k, v, w, u, None, s_out, o, ckpt=ckpt0)
            grads = [torch.empty_like(o) for _ in range(4)]
            du = torch.empty((b, h, d), device="cuda")
            ds0 = torch.empty_like(s0)
            scratch = torch.empty((b * h * kernel.CKPT_STEPS * d * d,),
                                  device="cuda")
            strides = (ctypes.c_int64 * 27)(*(
                s for x in (r, k, v, w, do, *grads) for s in x.stride()[:3]))
            stream = torch.cuda.current_stream().cuda_stream

            def run(name, ck, fin, want_ds0):
                if name == "new":
                    kernel.launch_backward(
                        r, k, v, w, do, u, ck, fin, dr=grads[0],
                        dk=grads[1], dv=grads[2], dw=grads[3], du=du,
                        ds0=ds0 if want_ds0 else None)
                    return
                code = parent_fn(
                    r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    do.data_ptr(), u.data_ptr(), ck.data_ptr(),
                    None if fin is None else fin.data_ptr(),
                    scratch.data_ptr(), *(x.data_ptr() for x in grads),
                    du.data_ptr(), ds0.data_ptr() if want_ds0 else None,
                    ctypes.addressof(strides), b, h, t, d,
                    int(dtype == torch.bfloat16), stream)
                if code:
                    raise RuntimeError(f"parent launch: {code}")

            ref = wkv_ops._plain_backward(r, k, v, w, u, s0, do, ds_fin)
            ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
            row = {"errors": {}, "bits_repeat": {}}
            for name in ("new", "parent"):
                runs = []
                for _ in range(2):
                    run(name, ckpt, ds_fin, True)
                    torch.cuda.synchronize()
                    runs.append([x.clone() for x in (*grads, du, ds0)])
                row["bits_repeat"][name] = all(
                    torch.equal(a, c) for a, c in zip(*runs))
                rel = []
                for j, (a, c) in enumerate(zip(runs[0], ref)):
                    a, c = a.float(), c.float()
                    top = c.abs().max()
                    bar = BAR * top + (ulp * c.abs() if j < 4 else 0.0)
                    if not (torch.isfinite(a).all()
                            and ((a - c).abs() <= bar).all()):
                        raise AssertionError(
                            f"{name} at {shape} {dt}: gradient {j} "
                            f"off the plain backward by "
                            f"{float((a - c).abs().max())} (max |g| "
                            f"{float(top)})")
                    rel.append(float((a - c).abs().max() / top))
                row["errors"][name] = rel
            if not all(row["bits_repeat"].values()):
                raise AssertionError(f"bits differ between launches at "
                                     f"{shape} {dt}: "
                                     f"{row['bits_repeat']}")
            order = ("parent", "new")
            ms = {name: [] for name in order}
            for name in order + order[::-1]:
                ms[name].append(chip_smoke.cuda_ms(
                    lambda: run(name, ckpt0, None, False), args.reps))
            bound_ms, bound_by = chip_smoke.wkv_bwd_bound(b, h, t, d, dt)
            row.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by)
            out[f"{list(shape)} {dt}"] = row
            chip_smoke.log(f"wkv6_bwd_ab {list(shape)} {dt}: ms in turns "
                           f"{json.dumps(ms)}; bound {bound_ms:.6f} "
                           f"({bound_by}); max err / max |g| "
                           f"{json.dumps(row['errors'])}; bits repeat "
                           f"{row['bits_repeat']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
