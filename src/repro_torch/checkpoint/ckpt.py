"""Numpy checkpoints of nested tensors and arrays (port of
`repro.checkpoint.ckpt`).

A tree is a nest of dicts, lists and tuples whose leaves are torch
tensors or numpy arrays (None is an empty subtree). Its leaves are
stored in an .npz under their '/'-joined paths (dict keys sorted, list
and tuple positions as indices): the reference's format, so either
package reads the other's files. A bf16 leaf is stored as f32 (npz has
no bf16); `restore` casts every leaf back to its template's dtype and
device.

Crash safety, as in the reference:

* **Atomic writes** — `save` writes a temp file, fsyncs it (and, where
  the filesystem allows, its directory) and `os.replace`s it into place,
  so a crash mid-write never leaves a half-written file under the final
  name.
* **Content hash** — every file carries a sha256 of its own leaves
  (dtype/shape headers + raw bytes) under the reserved `__sha256__`
  key; `peek` and `restore` verify it and raise `CheckpointCorrupt` on a
  torn, truncated or bit-flipped file. Files without the hash still
  load, unverified.
* **Keep-last-2 rotation** — `save` moves the previous file to
  `<path>.prev` first, so one good checkpoint survives a crash during
  the newest write; the resume path of
  `repro_torch.core.mc.exec.run_chunked` falls back to it.
"""
from __future__ import annotations

import hashlib
import os
from typing import Any

import numpy as np
import torch

Tree = Any

# reserved leaf: the file's own content sha256 as a (32,) uint8 array
_SHA_KEY = "__sha256__"
# keep-last-2 rotation: the previous file survives under this suffix
PREV_SUFFIX = ".prev"


class CheckpointCorrupt(Exception):
    """A checkpoint file that cannot be trusted: unreadable archive
    (zero-length, truncated, torn write), content-hash mismatch (bit
    flip), or no file at all. Carries the `path` and a `reason`."""

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(f"corrupt checkpoint at {path}: {reason}")


def _leaves(tree: Tree, prefix: tuple = ()):
    """(path, leaf) pairs in the reference's order: dict keys sorted,
    sequences by position."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # npz cannot round-trip ml_dtypes
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: Tree) -> dict:
    return {key: _as_numpy(leaf) for key, leaf in _leaves(tree)}


def _content_sha(flat: dict) -> np.ndarray:
    """sha256 over the file's leaves (sorted keys; dtype/shape headers +
    raw bytes), as a (32,) uint8 array npz can round-trip."""
    h = hashlib.sha256()
    for key in sorted(flat):
        if key == _SHA_KEY:
            continue
        arr = np.asarray(flat[key])
        h.update(f"{key}:{arr.dtype.str}:{arr.shape};".encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return np.frombuffer(h.digest(), np.uint8)


def save(path: str, tree: Tree) -> None:
    """Atomically write `tree` to `path` with its content sha256, the
    previous file rotated to `path + '.prev'`."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    flat = _flatten(tree)
    flat[_SHA_KEY] = _content_sha(flat)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        os.replace(path, path + PREV_SUFFIX)
    os.replace(tmp, path)
    try:  # directory fsync makes the replace itself durable; not every
        # filesystem lets a directory be opened
        dfd = os.open(parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def _load_verified(path: str) -> dict:
    """{flat key: array} of a checkpoint, sha-verified; raises
    `CheckpointCorrupt` on a missing, zero-length, unreadable or
    hash-mismatched file."""
    if not os.path.exists(path):
        raise CheckpointCorrupt(path, "file does not exist")
    if os.path.getsize(path) == 0:
        raise CheckpointCorrupt(path, "zero-length file")
    try:
        with np.load(path, allow_pickle=False) as data:
            flat = dict(data.items())
    except Exception as e:  # BadZipFile / EOFError / zlib error / OSError
        raise CheckpointCorrupt(
            path, f"unreadable archive (truncated or torn write): "
                  f"{type(e).__name__}: {e}") from e
    sha = flat.pop(_SHA_KEY, None)
    if sha is not None and not np.array_equal(
            np.asarray(sha, np.uint8).ravel(), _content_sha(flat)):
        raise CheckpointCorrupt(
            path, "content sha256 mismatch (bit flip or partial write)")
    return flat


def peek(path: str) -> dict:
    """The raw {flat key: numpy array} view of a checkpoint, no template
    needed (the resume path reads its fingerprint and cursor this way),
    sha-verified: raises `CheckpointCorrupt` on a bad file."""
    return _load_verified(path)


def restore(path: str, template: Tree) -> Tree:
    """The tree saved at `path`, in the structure of `template`: each
    leaf checked against the template leaf's shape and cast to its dtype
    (and, for a tensor, its device)."""
    flat = _load_verified(path)

    def build(t, prefix: tuple):
        if isinstance(t, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [build(v, prefix + (str(i),)) for i, v in enumerate(t)]
            return out if isinstance(t, list) else type(t)(out)
        if t is None:
            return None
        key = "/".join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{arr.shape} vs {tuple(t.shape)}")
        if isinstance(t, torch.Tensor):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                dtype=t.dtype, device=t.device)
        return np.asarray(arr).astype(t.dtype)

    return build(template, ())
