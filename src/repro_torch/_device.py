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
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


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

