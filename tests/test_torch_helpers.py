"""Shared helpers of the PyTorch port's parity tests (no tests here).

The JAX reference is exact only under the ORIGINAL threefry layout
(ROADMAP §3, R1), which the installed JAX does not default to. Every
parity test therefore computes its JAX values inside
`jax_original_layout()` — scoped, never set globally, because a global
flag would leak into other test files on the same xdist worker. Inputs
cross between the packages as numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def jax_original_layout():
    """Context manager: `jax.random` in the original threefry layout."""
    import jax

    return jax.threefry_partitionable(False)


def rel_err(a, b) -> float:
    """max |a − b| / |b| (with a floor that keeps exact zeros at 0)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def port_problem(jax_problem, device: str = "cpu"):
    """The port's problem on the reference problem's exact data arrays."""
    from repro_torch.core.mc.problems import problem_from_arrays

    return problem_from_arrays(
        jax_problem.kind,
        {k: np.asarray(v) for k, v in jax_problem.data.items()},
        jax_problem.n_nodes, jax_problem.dim, device=device)


def port_pc(pc):
    """The reference's ProblemConstants as the port's dataclass."""
    from repro_torch.core.theory import ProblemConstants

    return ProblemConstants(**dataclasses.asdict(pc))


def port_channel(cfg):
    """The reference's ChannelConfig as the port's dataclass."""
    from repro_torch.core.channel import ChannelConfig

    return ChannelConfig(**dataclasses.asdict(cfg))
