"""Problem registry for the Monte Carlo engine (port of
`repro.core.mc.problems`).

An engine problem kind registers a row-based gradient map and risk metric.
The port always uses the row formulation, batched over trajectories: a
row function takes the stacked data dict (every leaf with a leading `(C,)`
sweep-row axis, plus the validity `mask (C, N)`) and parameters
`theta (C, S, d)` — S seeds per row — and returns per-node gradients
`(C, S, N, d)` or risks `(C, S)`. The reference's closure path computes
the same arithmetic (its mask is exactly 1), so nothing is lost.

Rows of different node counts stack into one batch: per-node leaves pad
to N_max with their registered pad constants and `mask` marks the valid
node rows, as in the reference's `MCProblemBatch.stack`.

Built-in: `quadratic` (Eq. 27). `localization` and `logistic` wait
(ROADMAP P5).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """One registered problem kind: `grad_row(data, theta)` ->
    `(C, S, N, d)` with exactly-zero rows where `mask` is 0, and
    `risk_row(data, theta)` -> `(C, S)`. `pad_values` maps each per-node
    data field (node axis first) to its pad constant, chosen so padded
    rows stay finite before the mask zeroes them."""

    kind: str
    grad_row: Callable
    risk_row: Callable
    pad_values: dict


PROBLEMS: dict = {}  # kind -> ProblemSpec, insertion-ordered


def register_problem(kind: str, grad_row: Callable, risk_row: Callable,
                     pad_values: dict, *,
                     overwrite: bool = False) -> ProblemSpec:
    """Register a problem kind so `MCProblem`s of that kind stack into an
    engine batch, padded to the batch's largest node count. Returns the
    spec."""
    if kind in PROBLEMS and not overwrite:
        raise ValueError(f"problem kind {kind!r} is already registered "
                         "(pass overwrite=True to replace it)")
    spec = ProblemSpec(kind=kind, grad_row=grad_row, risk_row=risk_row,
                       pad_values=dict(pad_values))
    PROBLEMS[kind] = spec
    return spec


@dataclasses.dataclass(frozen=True)
class MCProblem:
    """One problem instance: its registered `kind`, its data tensors
    (per-node leaves lead with the node axis), node count and dimension."""

    kind: str
    data: dict
    n_nodes: int
    dim: int


@dataclasses.dataclass(frozen=True)
class MCProblemBatch:
    """C problems stacked along a leading sweep-row axis, per-node leaves
    padded to `n_max`; `data['mask']` `(C, n_max)` marks the valid node
    rows and `n_nodes` holds each row's true count."""

    kind: str
    grad_fn: Callable
    risk_fn: Callable
    data: dict
    n_nodes: tuple
    dim: int
    n_max: int

    @classmethod
    def stack(cls, problems: Sequence[MCProblem]) -> "MCProblemBatch":
        kinds = {p.kind for p in problems}
        if len(kinds) != 1:
            raise ValueError(f"MCProblemBatch.stack needs problems of one "
                             f"kind, got kinds={sorted(kinds)}")
        kind = problems[0].kind
        if kind not in PROBLEMS:
            raise ValueError(
                f"problem kind {kind!r} is not registered; call "
                "register_problem(kind, grad_row, risk_row, pad_values)")
        dims = {p.dim for p in problems}
        if len(dims) != 1:
            raise ValueError(f"problems must share dim, got {sorted(dims)}")
        spec = PROBLEMS[kind]
        n_nodes = tuple(p.n_nodes for p in problems)
        n_max = max(n_nodes)
        data = {}
        for name in problems[0].data:
            rows = []
            for p in problems:
                leaf = p.data[name]
                if name in spec.pad_values and p.n_nodes < n_max:
                    pad = leaf.new_full((n_max - p.n_nodes,)
                                        + tuple(leaf.shape[1:]),
                                        spec.pad_values[name])
                    leaf = torch.cat([leaf, pad])
                rows.append(leaf)
            try:
                data[name] = torch.stack(rows)
            except RuntimeError as e:
                raise ValueError(
                    f"data field {name!r} does not stack across the batch "
                    f"(shapes {[tuple(r.shape) for r in rows]}); non-node "
                    "dims must match row-for-row") from e
        mask = torch.zeros((len(problems), n_max), dtype=torch.float32)
        for i, n in enumerate(n_nodes):
            mask[i, :n] = 1.0
        data["mask"] = mask.to(data[next(iter(data))].device)
        return cls(kind=kind, grad_fn=spec.grad_row, risk_fn=spec.risk_row,
                   data=data, n_nodes=n_nodes, dim=problems[0].dim,
                   n_max=n_max)

    def __len__(self) -> int:
        return len(self.n_nodes)

    def to(self, device: torch.device) -> "MCProblemBatch":
        """The same batch with every data leaf on `device`."""
        return dataclasses.replace(
            self, data={k: v.to(device) for k, v in self.data.items()})


# --------------------------------------------------------------------------
# quadratic (regularized least squares, Eq. 27)
# --------------------------------------------------------------------------
def _quadratic_grad_row(row: dict, theta: torch.Tensor) -> torch.Tensor:
    """g_n = (x_nᵀθ − y_n) x_n + λθ per node, for every (row, seed):
    `theta (C, S, d)` -> `(C, S, N, d)`, masked."""
    resid = torch.einsum("cnf,csf->csn", row["X"], theta) \
        - row["y"][:, None, :]
    g = resid[..., None] * row["X"][:, None]
    g.add_(row["lam"][:, None, None, None] * theta[:, :, None, :])
    return g.mul_(row["mask"][:, None, :, None])


def _quadratic_risk_row(row: dict, theta: torch.Tensor) -> torch.Tensor:
    """Excess risk 0.5 (θ−θ*)ᵀ H (θ−θ*): `theta (C, S, d)` -> `(C, S)`."""
    diff = theta - row["theta_star"][:, None, :]
    h_diff = torch.einsum("cij,csj->csi", row["H"], diff)
    return (0.5 * diff * h_diff).sum(dim=-1)


def _to_tensors(arrays: dict, device: torch.device) -> dict:
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()}


def quadratic_mc_problem(X: np.ndarray, y: np.ndarray, lam: float,
                         theta_star: np.ndarray,
                         device: DeviceLike = None) -> MCProblem:
    """Regularized least squares (Eq. 27), one sample per node.

    The excess risk uses the exact quadratic form around the minimizer:
    F(θ) - F* = 0.5 (θ-θ*)ᵀ (A + λI) (θ-θ*) with A = XᵀX/N, built in f64
    on the host and stored in f32 — the reference's arrays exactly.
    """
    n, d = X.shape
    H64 = X.T.astype(np.float64) @ X.astype(np.float64) / n \
        + lam * np.eye(d)
    arrays = {"X": X, "y": y, "H": H64, "theta_star": theta_star,
              "lam": np.float32(lam)}
    return MCProblem(kind="quadratic",
                     data=_to_tensors(arrays, resolve_device(device)),
                     n_nodes=n, dim=d)


def problem_from_arrays(kind: str, arrays: dict, n_nodes: int, dim: int,
                        device: DeviceLike = None) -> MCProblem:
    """Build the port's problem from another implementation's data arrays
    — e.g. `{k: np.asarray(v) for k, v in jax_problem.data.items()}` — so
    both compute on identical inputs (including the f64-built `H`)."""
    if kind not in PROBLEMS:
        raise NotImplementedError(
            f"problem kind {kind!r} is not ported yet (ROADMAP P5: "
            "localization and logistic)")
    return MCProblem(kind=kind,
                     data=_to_tensors(arrays, resolve_device(device)),
                     n_nodes=int(n_nodes), dim=int(dim))


register_problem("quadratic", _quadratic_grad_row, _quadratic_risk_row,
                 {"X": 0.0, "y": 0.0})
