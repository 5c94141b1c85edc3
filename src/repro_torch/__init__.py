"""PyTorch/CUDA port of the GBMA reproduction (`repro`), for NVIDIA Hopper.

The package mirrors `repro`'s layout so each module has an obvious
counterpart (`repro_torch.core.mc.engine` <-> `repro.core.mc.engine`, ...).
It imports `torch` and numpy only — never `jax`, never `repro` — and
keeps its own copies of the pure-Python pieces it needs.

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; see `repro_torch._device`. Ported so far: the GBMA Monte
Carlo engine (`core.mc.engine.run_mc`: node-count sweeps, mixed
algorithm rows, fdm, power control, participation) through the
hand-written CUDA OTA-aggregation kernel (`kernels.ota`) to the rows of
Figs. 2, 3, 4, 6 and ablations (a), (b), (c), (e), (g) (`figures`); and
serving olmo-1b, repro-100m and rwkv6-7b (`serving`, `kernels.attention`,
`kernels.wkv`).
"""
from repro_torch._device import resolve_device, set_float32_precision

__all__ = ["resolve_device", "set_float32_precision"]
