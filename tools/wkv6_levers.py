#!/usr/bin/env python3
"""Settle the WKV6 kernel's numerics and time its design levers on one card.

    python3 tools/wkv6_levers.py [--parent FILE]

FILE is `csrc/wkv6.cu` as it was before the redesign (one block per
(batch, head), each chunk staged by a loop of scalar loads; by default
`git show 36ec962:src/repro_torch/kernels/wkv/csrc/wkv6.cu`, which needs
the repository's history). From it and from the shipped source the tool
builds, one nvcc each, all started together:

* `before`: the kernel before the redesign;
* `reorder`: the same with only the o-sum reordered: 4 partial
  accumulators over i mod 4, combined as (a0 + a1) + (a2 + a3), every
  operand and every FMA otherwise the same;
* the shipped kernel with its levers taken out of the source text, each
  variant keeping the levers before it: `ring` (r, k, v, w staged by
  cp.async while the previous chunk is computed; every row of r, k, w and
  u read from shared memory one row at a time; a rolled step loop),
  `ring+lds128` (the rows read 4 at a time as float4) and
  `ring+lds128+unroll` (a fixed-trip step loop unrolled by 2 on full
  chunks: the shipped kernel); and one with a lever put in,
  `ring+lds128+unroll+ureg` (u held in D registers, so 3 float4 loads
  serve 4 rows instead of 4; slower on an H100, so not shipped).

Then, on the card:

1. ptxas's registers and spills and the SASS's shared loads by width,
   FFMAs and FMULs of each variant's bf16, D = 64, 16-byte-copy kernel;
2. o and the final state of `before` against every lever variant, bit
   for bit, at chip_smoke.py's four f32 test shapes and rwkv6-7b's bf16
   prefill and decode shapes (the model's (B, T, H, D) views);
3. the variants timed with CUDA events in turns (before, ring, ...,
   shipped, shipped, ..., ring, before) at the prefill shape (4, 64,
   2048, 64) bf16, beside the bound, and the decode shape's device time
   per launch (torch.profiler) for `before` and the shipped kernel;
4. rwkv6-7b at full width and depth (chip_smoke's
   seeded weights) upcast to f32, chip_smoke.check_rwkv_routes's f32 leg
   at the 32-token prompt: the kernel route against the plain route,
   logits and state relative to their largest magnitude, through
   `before`, the shipped kernel and `reorder` (the bar is 1e-4); then the
   bf16 model's 2048-token prefill and decode step (chip_smoke.serve_timing)
   through `before` and the shipped kernel in turns.

Prints one JSON line, with the card's name and power limit as nvidia-smi
gives them. Any variant that disagrees raises.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARENT_REV = "36ec962"
PARENT_PATH = "src/repro_torch/kernels/wkv/csrc/wkv6.cu"

# the o-sum of the kernel before the redesign, as 4 partial sums over
# i mod 4
REORDER = [
    ("      float acc = 0.0f;\n",
     "      float acc4[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"),
    ("        acc = fmaf(s_r[c][i], fmaf(s_u[i], kv, s[i]), acc);\n",
     "        acc4[i % 4] = fmaf(s_r[c][i], fmaf(s_u[i], kv, s[i]), "
     "acc4[i % 4]);\n"),
    ("      store(o + (t0 + c) * p.o_st + j, acc);\n",
     "      store(o + (t0 + c) * p.o_st + j,\n"
     "            (acc4[0] + acc4[1]) + (acc4[2] + acc4[3]));\n"),
]
# (anchor in the shipped source, replacement) per lever taken out
_UNROLL = [("#pragma unroll 2\n      for (int c = 0; c < kChunk; ++c)",
            "#pragma unroll 1\n      for (int c = 0; c < n; ++c)")]
_LDS128 = [(
    "  for (int i = 0; i < D; i += 4) {\n"
    "    const float4 r4 = *reinterpret_cast<const float4*>(r + i);\n"
    "    const float4 k4 = *reinterpret_cast<const float4*>(k + i);\n"
    "    const float4 w4 = *reinterpret_cast<const float4*>(w + i);\n"
    "    const float4 u4 = *reinterpret_cast<const float4*>(u + i);\n"
    "    update(r4.x, k4.x, w4.x, u4.x, vj, s[i], acc);\n"
    "    update(r4.y, k4.y, w4.y, u4.y, vj, s[i + 1], acc);\n"
    "    update(r4.z, k4.z, w4.z, u4.z, vj, s[i + 2], acc);\n"
    "    update(r4.w, k4.w, w4.w, u4.w, vj, s[i + 3], acc);\n"
    "  }\n",
    "  for (int i = 0; i < D; ++i) {\n"
    "    update(r[i], k[i], w[i], u[i], vj, s[i], acc);\n"
    "  }\n")]
# and the lever put in on top of the shipped kernel: u held in D registers
_UREG = [
    ("  sm.u[j] = p.u[h * D + j];\n",
     "  sm.u[j] = p.u[h * D + j];\n  __syncthreads();\n  float ureg[D];\n"
     "#pragma unroll\n  for (int i = 0; i < D; ++i) ureg[i] = sm.u[i];\n"),
    ("                                      const float* w, const float* u,\n",
     "                                      const float* w,\n"
     "                                      const float (&u)[D],\n"),
    ("    const float4 u4 = *reinterpret_cast<const float4*>(u + i);\n",
     "    const float4 u4 = make_float4(u[i], u[i + 1], u[i + 2], "
     "u[i + 3]);\n"),
    ("step<D>(sm.r[c], sm.k[c], sm.w[c], sm.u, sm.v[c][j], s)",
     "step<D>(sm.r[c], sm.k[c], sm.w[c], ureg, sm.v[c][j], s)")]
LEVERS = {"ring": [*_UNROLL, *_LDS128],
          "ring+lds128": _UNROLL,
          "ring+lds128+unroll": [],
          "ring+lds128+unroll+ureg": _UREG}
SHIPPED = "ring+lds128+unroll"


def variant_source(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"lever anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def parent_source(path) -> str:
    if path:
        with open(path) as f:
            return f.read()
    return subprocess.run(["git", "show", f"{PARENT_REV}:{PARENT_PATH}"],
                          cwd=ROOT, capture_output=True, text=True,
                          check=True).stdout


def bind_library(lib) -> tuple:
    """`kernel.bind_library`, or for a source older than the checkpoint
    output (`before`, `reorder`) its own interface, called through a shim
    that drops the checkpoint pointer (always null here)."""
    from repro_torch.kernels.wkv import kernel

    if hasattr(lib, "wkv6_ckpt_steps"):
        return kernel.bind_library(lib)
    fn = lib.wkv6_forward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    err = lib.wkv6_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return (lambda *a: fn(*a[:-1])), err


def kernel_summary(info) -> dict:
    """ptxas's registers and spills and the SASS's shared loads by width,
    FFMAs and FMULs of the bf16, D = 64 kernel that stages by 16-byte
    copies (the one rwkv6-7b serves with; no checkpoints)."""
    import chip_smoke

    key = re.compile(r"wkv6_kernelI13__nv_bfloat16Li64E(?:Lb1E)?(?:Lb0E)?E")
    out = dict(chip_smoke.ptxas_by_kernel(
        info.log, lambda m: "k" if key.search(m) else None).get("k", {}))
    sass = chip_smoke._sass(info.path)
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        if key.search(fn.split("\n", 1)[0]):
            lds = re.findall(r"\bLDS((?:\.[A-Z0-9]+)*)\s", fn)
            out.update(
                lds128=sum("128" in x for x in lds),
                lds64=sum("64" in x for x in lds),
                lds32=sum("128" not in x and "64" not in x for x in lds),
                ffma=len(re.findall(r"\bFFMA\b", fn)),
                fmul=len(re.findall(r"\bFMUL\b", fn)))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="the kernel source before the redesign "
                        f"(default: git show {PARENT_REV}:{PARENT_PATH})")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import kernel

    if not torch.cuda.is_available():
        print("wkv6_levers: CUDA is not available", file=sys.stderr)
        return 2
    before = parent_source(args.parent)
    text = kernel.SOURCE.read_text()
    sources = {"before": before,
               "reorder": variant_source(before, REORDER)}
    sources.update({name: variant_source(text, edits)
                    for name, edits in LEVERS.items()})
    src_dir = _build.BUILD_DIR / "levers"
    src_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, source in sources.items():
        path = src_dir / f"wkv6_{name.replace('+', '_')}.cu"
        path.write_text(source)
        paths[name] = path
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        futs = {name: pool.submit(_build.build, path, path.stem)
                for name, path in paths.items()}
        infos = {name: f.result() for name, f in futs.items()}
    libs = {name: bind_library(ctypes.CDLL(str(info.path)))
            for name, info in infos.items()}
    shipped = kernel._bound

    def bind(name):
        kernel._bound = libs[name]

    result = {"card": chip_smoke.smi_line(),
              "kernels": {name: kernel_summary(infos[name])
                          for name in ("before", *LEVERS)}}
    print(f"wkv6 levers: kernels {json.dumps(result['kernels'])}",
          flush=True)

    # 2. bits: every lever variant against the kernel before the redesign
    def run(name, r, k, v, w, u, s0):
        bind(name)
        o = torch.empty((r.shape[0], r.shape[2], r.shape[1], r.shape[3]),
                        dtype=r.dtype, device="cuda").transpose(1, 2)
        s_out = torch.empty_like(s0)
        kernel.launch(r, k, v, w, u, s0, s_out, o)
        torch.cuda.synchronize()
        return o, s_out

    cases = [(shape, torch.float32, "bhtd", 200 + i)
             for i, shape in enumerate(chip_smoke.WKV_TEST_SHAPES)]
    cases += [(shape, torch.bfloat16, "bthd", 300 + shape[2])
              for shape in chip_smoke.WKV_SLICE_SHAPES]
    bits = {}
    for shape, dtype, layout, seed in cases:
        args_ = chip_smoke.wkv_inputs(*shape, dtype, seed, layout=layout)
        ref_o, ref_s = run("before", *args_)
        for name in LEVERS:
            o, s = run(name, *args_)
            same = torch.equal(o, ref_o) and torch.equal(s, ref_s)
            bits[f"{name} {list(shape)} {str(dtype)[6:]}"] = same
            if not same:
                raise AssertionError(f"{name} differs from the kernel before "
                                     f"the redesign at {shape} {dtype}")
    result["bits_equal_before"] = bits
    print(f"wkv6 levers: o and state equal the kernel before the redesign "
          f"bit for bit in {len(bits)} of {len(bits)} cases", flush=True)

    # 3. times in turns at the prefill shape; decode device time
    b, h, t, d = chip_smoke.WKV_SLICE_SHAPES[0]
    r, k, v, w, u, s0 = chip_smoke.wkv_inputs(b, h, t, d, torch.bfloat16, 7,
                                              layout="bthd")
    o = torch.empty((b, t, h, d), dtype=torch.bfloat16,
                    device="cuda").transpose(1, 2)
    s_out = torch.empty_like(s0)
    order = ["before", *LEVERS, *list(LEVERS)[::-1], "before"]
    times = {name: [] for name in ("before", *LEVERS)}
    for name in order:
        bind(name)
        times[name].append(chip_smoke.cuda_ms(
            lambda: kernel.launch(r, k, v, w, u, s0, s_out, o), 20))
    bound, bound_by = chip_smoke.wkv_bound(b, h, t, d, "bfloat16")
    result["prefill_shape"] = [b, h, t, d]
    result["ms"] = times
    result["bound_ms"], result["bound_by"] = bound, bound_by
    print(f"wkv6 levers: ms in turns {json.dumps(times)}, bound {bound:.6f} "
          f"ms ({bound_by})", flush=True)
    b, h, t, d = chip_smoke.WKV_SLICE_SHAPES[1]
    dr, dk, dv, dw, du, ds0 = chip_smoke.wkv_inputs(b, h, t, d,
                                                    torch.bfloat16, 8,
                                                    layout="bthd")
    do = torch.empty((b, t, h, d), dtype=torch.bfloat16,
                     device="cuda").transpose(1, 2)
    decode_us = {}
    for name in ("before", SHIPPED, SHIPPED, "before"):
        bind(name)

        def launches():
            for _ in range(200):
                kernel.launch(dr, dk, dv, dw, du, ds0, ds0, do)

        launches()
        prof = chip_smoke._profile_counts(launches, kernel="wkv6")
        decode_us.setdefault(name, []).append(
            prof["kernel_us"] / prof["kernel"])
    result["decode_device_us_per_launch"] = decode_us
    print(f"wkv6 levers: decode device us per launch {json.dumps(decode_us)}",
          flush=True)

    # 4. the whole model: the f32 route gap, then the bf16 prefill
    from repro_torch.models.model import build_model

    model, params = chip_smoke._serve_model("rwkv6-7b")
    cfg = model.cfg
    params32 = chip_smoke._tree_map(lambda x: x.float(), params)
    s = chip_smoke.SERVE_PROMPTS[0]
    tokens = chip_smoke._prompt(cfg.vocab_size, s + 1, seed=2)
    head = {"tokens": tokens[:, :s]}
    cfg32 = cfg.with_(dtype="float32")
    p_logits, p_state = build_model(cfg32, "ref").prefill(params32, head)
    f32 = build_model(cfg32, "auto")
    gaps = {}
    for name in ("before", SHIPPED, "reorder"):
        bind(name)
        logits, state = f32.prefill(params32, head)
        gaps[name] = {
            "f32_routes_rel": chip_smoke._rel_to_max(logits, p_logits),
            "f32_routes_state_rel": chip_smoke._rel_to_max(
                state["wkv"], p_state["wkv"])}
    result["f32_route_gap"] = gaps
    result["f32_route_bar"] = chip_smoke.RWKV_F32_ROUTE_BAR
    print(f"wkv6 levers: rwkv6-7b f32 route gap at prompt {s} "
          f"{json.dumps(gaps)} (bar {chip_smoke.RWKV_F32_ROUTE_BAR})",
          flush=True)
    del params32, p_state, state, f32
    torch.cuda.empty_cache()
    serve = {}
    for name in ("before", SHIPPED, SHIPPED, "before"):
        bind(name)
        serve.setdefault(name, []).append(chip_smoke.serve_timing(
            model, params, "wkv6", prompts=(2048,))[2048])
    result["rwkv6_7b_2048"] = serve
    kernel._bound = shipped
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
