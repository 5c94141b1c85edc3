"""PyTorch/CUDA port of the GBMA reproduction (`repro`), for NVIDIA Hopper.

The package mirrors `repro`'s layout so each module has an obvious
counterpart (`repro_torch.core.mc.engine` <-> `repro.core.mc.engine`, ...).
It imports `torch` and numpy only — never `jax`, never `repro` — and
keeps its own copies of the pure-Python pieces it needs.

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; see `repro_torch._device`. The slice ported so far is the
GBMA Monte Carlo main path: `core.mc.engine.run_mc` through the
hand-written CUDA OTA-aggregation kernel (`kernels.ota`) to the fig2/fig3
rows (`figures`).
"""
from repro_torch._device import resolve_device, set_float32_precision

__all__ = ["resolve_device", "set_float32_precision"]
