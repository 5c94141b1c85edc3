"""Host-side training loop: data feeding, the step, metrics, checkpoints
(port of `repro.training.loop`)."""
from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A host batch leaf on `device`. To the card it goes through pinned
    memory without blocking: a pageable copy would synchronize the host
    with the card once a step."""
    t = torch.from_numpy(np.asarray(x)) if not isinstance(
        x, torch.Tensor) else x
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def run_training(
    train_step: Callable,
    params,
    opt_state,
    batches: Iterable,
    steps: int,
    *,
    log_every: int = 10,
    checkpoint_fn: Optional[Callable] = None,
    checkpoint_every: int = 0,
    donate: bool = True,
):
    """Runs `steps` iterations; returns (params, opt_state, history).

    Batches (trees of numpy arrays or tensors) are moved to the
    parameters' device. A step's metrics stay on the device and are read
    on the host only at log steps (every `log_every` steps and the last),
    so the other steps issue no synchronization. `donate` is accepted for
    the reference's signature and means nothing here: eager updates
    already return new tensors and free the old ones."""
    del donate
    device = tree_leaves(params)[0].device
    history = []
    t0 = time.time()
    it = iter(batches)
    for step in range(steps):
        batch = tree_map(lambda x: _to_device(x, device), next(it))
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                step)
        if log_every and (step % log_every == 0 or step == steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.time() - t0
            history.append(m)
            extras = ""
            if m.get("clip_frac", 0.0) > 0.0:
                extras += " clipped"
            if "tx_energy" in m:
                extras += f" tx {m['tx_energy']:.3g}"
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f}{extras} "
                  f"({m['wall_s']:.1f}s)", flush=True)
        if checkpoint_fn and checkpoint_every and step and \
                step % checkpoint_every == 0:
            checkpoint_fn(params, opt_state, step)
    return params, opt_state, history
