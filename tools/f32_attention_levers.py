#!/usr/bin/env python3
"""Time the design levers of the f32 flash-attention kernel on one card.

    python3 tools/f32_attention_levers.py

`src/repro_torch/kernels/attention/csrc/flash_attention.cu` is built
five times, each variant with one lever fewer than the next, by taking
the levers out of its source text:

* `tiles`: register tiles fed by 128-bit shared loads; each K and V tile
  waited for where its copy is issued (nothing overlaps them),
  exponentials as expf of the scaled difference;
* `tiles+ring`: K and V through the 2-stage cp.async ring (V_t lands
  while S_t is computed, K_{t+1} while P_t V_t is);
* `tiles+ring+exp2`: exp2 with the scale folded into one FMA;
* `tiles+ring+exp2+cap`: the softcap tested once per tile (a template
  flag of the softmax), not at every logit;
* `tiles+ring+exp2+cap+edge`: the kernel as shipped (the masks computed
  only on the tiles that the causal diagonal, the window's edge or the
  end of the keys crosses).

Each variant is held to the plain version at repro-100m's prefill shape
(4, 10, 2048, 64) f32 (atol 5e-5 + rtol 1e-4), then all are timed with
CUDA events in turns (a, b, c, d, e, e, d, c, b, a) beside SDPA and the
bound. The levers interact: each variant keeps every lever before it.
Prints one JSON line, with the card's name and power limit as nvidia-smi
gives them. The kernel before the redesign is not in the source any more:
PERF.md quotes its times.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4, 10, 2048, 64)

# (anchor in the shipped source, replacement) per lever taken out: without
# the ring each copy is waited for where it is issued
_RING = [(line, line + "    cp_async_wait_all();\n") for line in (
    "    cp_async_commit();    // V_t lands during S and the softmax\n",
    "    cp_async_commit();    // K_{t+1} lands during PV\n")]
_LN2 = "0.6931471805599453f"
_EXP2 = [
    ("const float alpha = exp2f((m[i] - m_new) * c);",
     f"const float alpha = expf((m[i] - m_new) * (c * {_LN2}));"),
    ("const float pj = exp2f(fmaf(s[i][j], cr, -mc));",
     f"const float pj = expf((s[i][j] - m_new) * (cr * {_LN2}));"),
]
# the softcap tested at every logit: only the uncapped instantiations run,
# each testing p.softcap itself
_CAP = [("      if (kCap) x = p.softcap * tanhf(x * p.scale / p.softcap);",
         "      if (p.softcap > 0.0f) {\n"
         "        x = p.softcap * tanhf(x * p.scale / p.softcap);\n"
         "      }"),
        ("    if (p.softcap > 0.0f) {\n      if (edge) {",
         "    if (false) {\n      if (edge) {")]
# every tile masked, as if each were crossed by a mask's edge
_EDGE = [("    const bool edge = k0 + kBlockK > p.skv ||",
          "    const bool edge = true || k0 + kBlockK > p.skv ||")]
VARIANTS = {"tiles": [*_RING, *_EXP2, *_CAP, *_EDGE],
            "tiles+ring": [*_EXP2, *_CAP, *_EDGE],
            "tiles+ring+exp2": [*_CAP, *_EDGE],
            "tiles+ring+exp2+cap": _EDGE,
            "tiles+ring+exp2+cap+edge": []}


def variant_source(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"lever anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.attention.ops import multi_head_attention

    if not torch.cuda.is_available():
        print("f32_attention_levers: CUDA is not available", file=sys.stderr)
        return 2
    text = kernel.SOURCE.read_text()
    src_dir = _build.BUILD_DIR / "levers"
    src_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        path = src_dir / f"flash_attention_{name.replace('+', '_')}.cu"
        path.write_text(variant_source(text, edits))
        paths[name] = path
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        futs = {name: pool.submit(_build.build, path, path.stem)
                for name, path in paths.items()}
        libs = {name: f.result().path for name, f in futs.items()}
    bound = {name: kernel.bind_library(ctypes.CDLL(str(path)), False)
             for name, path in libs.items()}
    shipped = kernel._libs.get(kernel.NAME)

    def bind(name):
        # the launcher's f32 entry points, taken from a variant's library
        kernel._libs[kernel.NAME] = bound[name]

    b, h, s, d = SHAPE
    q, k, v = chip_smoke.attn_inputs(b, h, h, s, d, torch.float32, 7)
    out = torch.empty_like(q)
    scale = d ** -0.5
    ref = multi_head_attention(q, k, v, scale=scale, impl="ref")
    result = {"card": chip_smoke.smi_line(), "shape": list(SHAPE),
              "variants": {}}
    for name in VARIANTS:
        bind(name)
        ker = multi_head_attention(q, k, v, scale=scale, impl="kernel")
        torch.cuda.synchronize()
        err = (ker - ref).abs()
        ok = bool((err <= 5e-5 + 1e-4 * ref.abs()).all())
        result["variants"][name] = {"lib": libs[name].name, "ms": [],
                                    "max_abs_err": err.max().item()}
        if not ok:
            raise AssertionError(f"lever variant {name} disagrees with the "
                                 "plain version")
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for name in order:
        bind(name)
        result["variants"][name]["ms"].append(chip_smoke.cuda_ms(
            lambda: kernel.launch(q, k, v, out, scale=scale, causal=True,
                                  window=None, softcap=None), 20))
    result["sdpa_ms"] = chip_smoke.cuda_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               scale=scale), 20)
    result["bound_ms"], result["bound_by"] = chip_smoke.attention_bound(
        b, h, s, d, "float32")
    kernel._libs.pop(kernel.NAME, None)
    if shipped is not None:
        kernel._libs[kernel.NAME] = shipped
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
