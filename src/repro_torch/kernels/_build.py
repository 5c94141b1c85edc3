"""Build hand-written CUDA sources into shared libraries and load them.

Each `csrc/*.cu` file exports a plain C interface. At first use it is
compiled with `nvcc` for Hopper (`sm_90a`) into `build/repro_torch/` at
the root of the checkout (listed in `.gitignore`), named by the hash of
the source and the flags, so an edited source rebuilds and an unchanged
one is reused. The library is loaded with `ctypes`; wrappers pass tensor
pointers and the current stream as `c_void_p`.

Nothing here runs at import time: the CPU tests import every module, and
a CPU-only installation has no `nvcc`. `copy_bytes` picks how a kernel
stages the strided views it is given.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_lock = threading.Lock()
_libs: dict = {}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """One built library: its path, the seconds `nvcc` took (0.0 when an
    up-to-date build was reused) and the compiler's messages (`ptxas -v`:
    registers, shared memory and spills per kernel)."""

    path: Path
    seconds: float
    log: str


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "repro_torch are compiled at first use on a machine with the CUDA "
        "toolkit")


def build(source: Path, name: str) -> BuildInfo:
    """Compile `source` to `BUILD_DIR/<name>-<hash>.so` unless that file
    exists. The output is written to a temporary name and renamed, so
    concurrent builders never load a half-written library."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{source}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return BuildInfo(out, seconds, (proc.stdout + proc.stderr).strip())


def load(source: Path, name: str) -> ctypes.CDLL:
    """Build if needed and load the library once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(source, name).path))
            _libs[name] = lib
        return lib


def copy_bytes(*tensors) -> int:
    """How a kernel that stages these (B, H, S, D) views by `cp.async`
    copies them: 16 (bytes per copy) when every base address is 16-byte
    aligned and every (batch, head, seq) stride of a dimension longer
    than 1 spans whole 16 bytes, else the element size (one element per
    copy). Both widths run the same kernel and give the same bits."""
    elt = tensors[0].element_size()
    for t in tensors:
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(st * elt % 16 for st in strides):
            return elt
    return 16
