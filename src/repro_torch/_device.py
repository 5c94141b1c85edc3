"""Device resolution and float32 precision for the PyTorch port.

Entry points take an explicit `device`. `None` means the CUDA card: the
port is written for an H100, and a run that silently fell back to the
CPU would report CPU numbers under a GPU's name. Without a CUDA device
the caller has to ask for the CPU by passing `device="cpu"` (the tests
do).

Float32 precision: the JAX reference runs its tests with
`jax_default_matmul_precision="highest"` (tests/conftest.py), so the
port's f32 matrix products must run in full f32 on the card too. TF32 is
switched off for cuBLAS and cuDNN when this module is imported; TF32
keeps about three decimal digits, far outside the parity tolerances.

Meshes: the Monte Carlo engine places a sweep's rows and seeds over a
`(rows × mc)` mesh of devices (`mesh_devices`), laid out row-major as
the reference's `make_mesh((row_shards, mc), ("rows", "mc"))`; the
training step's `("data", "model")` meshes (`launch.mesh.make_mesh`)
take their devices from the same function. A call's
`device` may be one device (`None`: the card), which stands for the
first visible cards from it on (on the CPU: entries of the CPU), or a
sequence of devices, which may name one device more than once: the
counterpart of the reference's forced host devices, so that one card
(or the CPU) runs a placed sweep block by block.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

DeviceLike = Union[str, torch.device, None]
MeshLike = Union[str, torch.device, None, Sequence[Union[str, torch.device]]]


def set_float32_precision() -> None:
    """Full-f32 matmuls and convolutions on CUDA (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


set_float32_precision()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> the CUDA card; raises when CUDA is absent instead of
    carrying on on the CPU. Any explicit device is taken as given (a
    CUDA device still needs CUDA)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev



def _is_sequence(device: MeshLike) -> bool:
    return isinstance(device, (list, tuple))


def primary_device(device: MeshLike = None) -> torch.device:
    """The device a call's data lives on: the first entry of a sequence,
    else `resolve_device(device)`."""
    if _is_sequence(device):
        if not device:
            raise ValueError("an empty device sequence names no device")
        return resolve_device(device[0])
    return resolve_device(device)


def visible_device_count(device: MeshLike = None) -> int:
    """How many devices a call may place over: the length of a sequence,
    the visible cards from a CUDA device's index on (`None` is the card;
    0 without CUDA), 1 on the CPU."""
    if _is_sequence(device):
        return len(device)
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        return max(torch.cuda.device_count() - (dev.index or 0), 0)
    return 1


def mesh_devices(device: MeshLike, *shape: int) -> list:
    """The devices of a mesh of `shape` (any number of axes; an axis of
    size 0 counts as 1, as a sweep's `n_shards=0`), row-major: for the
    Monte Carlo engine's `(row_shards, n_shards)` mesh, entry `r · mc + m`
    holds row block r's seed block m. A sequence gives its first
    entries; a CUDA device the cards from its index on (raising when too
    few are visible, or CUDA is absent); the CPU repeats itself. A mesh
    of one entry is `[primary_device(device)]`."""
    dims = [max(int(s), 1) for s in shape]
    size = math.prod(dims)
    label = " x ".join(str(d) for d in dims)
    if size == 1:
        return [primary_device(device)]
    if _is_sequence(device):
        if len(device) < size:
            raise ValueError(f"a ({label}) mesh needs {size} devices, the "
                             f"sequence names {len(device)}")
        return [resolve_device(d) for d in device[:size]]
    dev = primary_device(device)
    if dev.type != "cuda":
        return [dev] * size
    start = dev.index or 0
    if start + size > torch.cuda.device_count():
        raise ValueError(
            f"a ({label}) mesh from cuda:{start} needs {size} cards, "
            f"{torch.cuda.device_count()} are visible; pass a device list, "
            "which may name a card more than once")
    return [torch.device("cuda", start + i) for i in range(size)]
