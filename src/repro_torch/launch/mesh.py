"""Device meshes for the mesh path of training (port of
`repro.launch.mesh`).

A `Mesh` is a shape, its axis names and its devices in row-major order:
entry `i` sits at the coordinates `coords(i)`, the last axis fastest, as
in the reference's `jax.make_mesh`. One process controls every entry
(the reference's single program over its mesh), and the device list
may name one device more than once: `["cuda:0"] * 4` runs a `(2, 2)`
mesh on one card, `["cpu"] * 4` on the CPU, with the code, collectives
and bits of four cards (`_device.mesh_devices` resolves the list).

Functions, not module constants, so importing this module touches no
device.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch._device import MeshLike, mesh_devices


class Mesh:
    """`shape` sizes over `axis_names`, on `devices` (row-major).
    `.shape[axis]` is an axis's size, `.size` the number of entries."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[torch.device]):
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{tuple(axis_names)} differ in length")
        if len(devices) != math.prod(shape):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                             f"devices, got {len(devices)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)

    def coords(self, i: int) -> dict:
        """Entry `i`'s coordinate on each axis."""
        out = {}
        for name in reversed(self.axis_names):
            i, out[name] = divmod(i, self.shape[name])
        return {name: out[name] for name in self.axis_names}


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: MeshLike = None) -> Mesh:
    """A mesh of `shape` over `devices`: the cards from `devices` on (None:
    the card), or a sequence's first entries, which may repeat a device
    (`_device.mesh_devices`)."""
    return Mesh(shape, axis_names, mesh_devices(devices, *shape))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: MeshLike = None) -> Mesh:
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model") with `multi_pod`.
    Raises the reference's `RuntimeError` when fewer devices are given
    or visible."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    try:
        return make_mesh(shape, axes, devices)
    except ValueError:
        have = (len(devices) if isinstance(devices, (list, tuple))
                else torch.cuda.device_count())
        raise RuntimeError(
            f"mesh needs {n} devices but only {have} present; pass a "
            "device list, which may name a device more than once") \
            from None


def make_host_mesh(device: MeshLike = None) -> Mesh:
    """The degenerate (1, 1) ("data", "model") mesh on one device (None:
    the card)."""
    return make_mesh((1, 1), ("data", "model"), device)
