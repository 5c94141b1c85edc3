"""Roofline terms of a measured step (port of `repro.launch.analysis`'s
`RooflineTerms`), with the H100's rates in place of the reference's TPU
v5e ones.

The reference fills `hlo_flops`, `hlo_bytes` and `coll_bytes` from a
compiled XLA module (`cost_stats`, `collective_bytes`, `memory_stats`
parse XLA artifacts and are not ported: the port has no HLO). Here the
caller supplies them: the FLOPs and bytes it measured or counted for the
step, and the bytes its collectives moved. `model_flops` is the analytic
count (`launch.analytic.model_flops`).
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM (a card): dense bf16 tensor-core rate, HBM3 rate,
# NVLink 4 rate a direction (NVIDIA data sheet)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s a direction


@dataclasses.dataclass
class RooflineTerms:
    hlo_flops: float  # a device: measured or counted by the caller
    hlo_bytes: float  # a device
    coll_bytes: float  # a device
    model_flops: float  # analytic, a device
    chips: int

    @property
    def compute_s(self) -> float:
        return max(self.hlo_flops, self.model_flops) / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        h = max(self.hlo_flops, self.model_flops)
        return self.model_flops / h if h else 0.0

    def as_dict(self) -> dict:
        return {
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
        }
