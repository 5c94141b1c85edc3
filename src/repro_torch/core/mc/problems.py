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

A stochastic kind also registers its minibatch gradient in two parts, as
the reference's index/gradient split: `sample_indices_row(data, keys,
b_max)` draws `(B, N_max, b_max)` per-node sample indices from the step's
data keys `(B, 2)`, and `stochastic_grad_from_idx(data, theta, idx,
b_count)` averages the gradient over the first `b_count[c]` index lanes
of each row (`idx (C, S, N_max, b_max)`, `b_count (C,)` int). The sample
axis is axis 1 of the per-node field `sample_axis_field`.

Built-in: `quadratic` (Eq. 27), `localization` (§VI-B, Fig. 5) and the
stochastic `logistic` (federated logistic regression on a non-iid
partition, Fig. 8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import rng
from repro_torch.data.federated import partition_noniid, partition_rows


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
    sample_axis_field: Optional[str] = None
    sample_indices_row: Optional[Callable] = None
    stochastic_grad_from_idx: Optional[Callable] = None


PROBLEMS: dict = {}  # kind -> ProblemSpec, insertion-ordered


def register_problem(kind: str, grad_row: Callable, risk_row: Callable,
                     pad_values: dict, *,
                     sample_axis_field: Optional[str] = None,
                     sample_indices_row: Optional[Callable] = None,
                     stochastic_grad_from_idx: Optional[Callable] = None,
                     overwrite: bool = False) -> ProblemSpec:
    """Register a problem kind so `MCProblem`s of that kind stack into an
    engine batch, padded to the batch's largest node count; the three
    stochastic arguments (given together) make it minibatch-capable.
    Returns the spec."""
    if kind in PROBLEMS and not overwrite:
        raise ValueError(f"problem kind {kind!r} is already registered "
                         "(pass overwrite=True to replace it)")
    stochastic = (sample_axis_field, sample_indices_row,
                  stochastic_grad_from_idx)
    if any(v is None for v in stochastic) \
            and any(v is not None for v in stochastic):
        raise ValueError("sample_axis_field, sample_indices_row and "
                         "stochastic_grad_from_idx must be given together")
    spec = ProblemSpec(kind=kind, grad_row=grad_row, risk_row=risk_row,
                       pad_values=dict(pad_values),
                       sample_axis_field=sample_axis_field,
                       sample_indices_row=sample_indices_row,
                       stochastic_grad_from_idx=stochastic_grad_from_idx)
    PROBLEMS[kind] = spec
    return spec


@dataclasses.dataclass(frozen=True)
class MCProblem:
    """One problem instance: its registered `kind`, its data tensors
    (per-node leaves lead with the node axis), node count and dimension.
    `stochastic` lets `run_mc(batch_frac=...)` draw minibatches."""

    kind: str
    data: dict
    n_nodes: int
    dim: int
    stochastic: bool = False


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
    stochastic: bool = False

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
                   n_max=n_max,
                   stochastic=any(p.stochastic for p in problems))

    def __len__(self) -> int:
        return len(self.n_nodes)

    @property
    def spec(self) -> ProblemSpec:
        return PROBLEMS[self.kind]

    def to(self, device: torch.device) -> "MCProblemBatch":
        """The same batch with every data leaf on `device`."""
        return dataclasses.replace(
            self, data={k: v.to(device) for k, v in self.data.items()})


# --------------------------------------------------------------------------
# quadratic (regularized least squares, Eq. 27)
# --------------------------------------------------------------------------
def _quadratic_grad_row(row: dict, theta: torch.Tensor) -> torch.Tensor:
    """g_n = (x_nᵀθ − y_n) x_n + λθ per node, for every (row, seed):
    `theta (C, S, d)` -> `(C, S, N, d)`, masked.

    Each dot product is a product and a sum over one axis, never a matrix
    product: a GEMM's summation order follows the batch's shape (the
    CPU's small-matrix loop against BLAS, a card's tile choice), and a
    trajectory's bits must not depend on how many others share its call
    (a placed call's blocks hold fewer)."""
    # the products laid out (C, S, d, N): the sum over d runs along an
    # outer axis, one output per lane on the card
    x_t = row["X"].transpose(1, 2).contiguous()
    resid = (x_t[:, None] * theta[:, :, :, None]).sum(dim=2) \
        - row["y"][:, None, :]
    g = resid[..., None] * row["X"][:, None]
    g.add_(row["lam"][:, None, None, None] * theta[:, :, None, :])
    return g.mul_(row["mask"][:, None, :, None])


def _quadratic_risk_row(row: dict, theta: torch.Tensor) -> torch.Tensor:
    """Excess risk 0.5 (θ−θ*)ᵀ H (θ−θ*): `theta (C, S, d)` -> `(C, S)`."""
    diff = theta - row["theta_star"][:, None, :]
    # a sum over the last axis, not a GEMM (`_quadratic_grad_row`)
    h_diff = (row["H"][:, None] * diff[:, :, None, :]).sum(dim=-1)
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


# --------------------------------------------------------------------------
# localization (paper §VI-B)
# --------------------------------------------------------------------------
def _localization_grad_row(row: dict, theta: torch.Tensor) -> torch.Tensor:
    """g_n = 4A (x_n − A/d²) / d⁴ · (θ − r_n), d² = ‖θ − r_n‖², per node
    and (row, seed): `theta (C, S, 2)` -> `(C, S, N, 2)`, masked."""
    diff = theta[:, :, None, :] - row["r"][:, None]
    d2 = (diff * diff).sum(dim=-1)
    a = row["signal_a"][:, None, None]
    resid = row["x"][:, None, :] - a / d2
    g = (4.0 * a * resid / d2**2)[..., None] * diff
    return g * row["mask"][:, None, :, None]


def _localization_risk_row(row: dict, theta: torch.Tensor) -> torch.Tensor:
    """Squared position error ‖θ − src‖²: `(C, S, 2)` -> `(C, S)`."""
    diff = theta - row["src"][:, None, :]
    return (diff * diff).sum(dim=-1)


def localization_mc_problem(r: np.ndarray, x: np.ndarray, src: np.ndarray,
                            signal_a: float,
                            device: DeviceLike = None) -> MCProblem:
    """Source localization of paper §VI-B (sensor positions `r (N, 2)`,
    measurements `x (N,)`); risk = squared position error."""
    arrays = {"r": r, "x": x, "src": src, "signal_a": np.float32(signal_a)}
    return MCProblem(kind="localization",
                     data=_to_tensors(arrays, resolve_device(device)),
                     n_nodes=int(r.shape[0]), dim=2)


# --------------------------------------------------------------------------
# logistic (federated logistic regression, stochastic-capable: Fig. 8)
# --------------------------------------------------------------------------
def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + e^{-x}) from ops whose CPU vector and scalar loops agree
    bit for bit (`torch.sigmoid`'s do not), so an element's value never
    depends on where the batch puts it (`_quadratic_grad_row`)."""
    return torch.reciprocal(1.0 + torch.exp(-x))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) = max(x, 0) + log1p(e^{-|x|}), from ops whose CPU
    vector and scalar loops agree (`torch.logaddexp`'s do not)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _logistic_margin(row: dict, theta: torch.Tensor) -> torch.Tensor:
    """y_i <x_i, θ> per (row, seed, node, local sample); sums over the
    last axis, not GEMMs (`_quadratic_grad_row`)."""
    return row["yn"][:, None] * (
        row["Xn"][:, None] * theta[:, :, None, None, :]).sum(dim=-1)


def _logistic_grad_row(row: dict, theta: torch.Tensor) -> torch.Tensor:
    """Full-batch per-node gradient of the regularized logistic loss:
    g_n = (1/k) Σ_i −σ(−m_i) y_i x_i + λθ, masked."""
    k = row["Xn"].shape[2]
    coef = -_sigmoid(-_logistic_margin(row, theta)) * row["yn"][:, None]
    g = (coef[..., None] * row["Xn"][:, None]).sum(dim=3) / float(k)
    g = g + row["lam"][:, None, None, None] * theta[:, :, None, :]
    return g * row["mask"][:, None, :, None]


def _logistic_sample_idx_row(row: dict, keys: torch.Tensor,
                             b_max: int) -> torch.Tensor:
    """The minibatch index draw of one step: `(B, N_max, b_max)` int64
    with-replacement local sample indices from the data keys `(B, 2)`.

    Entry (n, j) draws a SCALAR `randint` from `fold_in(fold_in(key, j),
    n)`, as the reference does, so every entry is the same whatever the
    call's b_max and N_max."""
    n_max, k = row["Xn"].shape[1], row["Xn"].shape[2]
    lanes = torch.arange(b_max, device=keys.device)
    nodes = torch.arange(n_max, device=keys.device)
    lane_keys = rng.fold_in(keys[:, None, :], lanes)          # (B, b, 2)
    node_keys = rng.fold_in(lane_keys[:, :, None, :], nodes)  # (B, b, n, 2)
    return rng.randint(node_keys, (), 0, k).transpose(1, 2)


def _logistic_sgrad_from_idx_row(row: dict, theta: torch.Tensor,
                                 idx: torch.Tensor,
                                 b_count: torch.Tensor) -> torch.Tensor:
    """Minibatch logistic gradient over drawn indices `idx (C, S, N,
    b_max)`: the first `b_count[c]` lanes of row c averaged, + λθ,
    masked."""
    c, s, n, b = idx.shape
    xn = row["Xn"]
    f = xn.shape[-1]
    xs = torch.gather(xn[:, None].expand(c, s, n, xn.shape[2], f), 3,
                      idx[..., None].expand(c, s, n, b, f))
    ys = torch.gather(row["yn"][:, None].expand(c, s, n, xn.shape[2]), 3,
                      idx)
    lane = (torch.arange(b, device=idx.device)
            < b_count[:, None]).to(torch.float32)[:, None, None, :]
    m = ys * (xs * theta[:, :, None, None, :]).sum(dim=-1)
    coef = -_sigmoid(-m) * ys * lane
    g = (coef[..., None] * xs).sum(dim=3) \
        / b_count.to(torch.float32)[:, None, None, None]
    g = g + row["lam"][:, None, None, None] * theta[:, :, None, :]
    return g * row["mask"][:, None, :, None]


def _logistic_risk_row(row: dict, theta: torch.Tensor) -> torch.Tensor:
    """Excess risk F(θ) − F* of the GLOBAL objective: the masked mean of
    log(1 + e^{−m}) over the row's N·k samples plus the L2 term, minus
    the host-side f64 Newton F* stored in the data. The samples' sum is
    taken in f64 and rounded once to f32: F ≈ 0.5 carries that one
    rounding, where an f32 sum in PyTorch's order sat an ulp of F from
    XLA's more often (ROADMAP §3, F8)."""
    loss = _softplus(-_logistic_margin(row, theta))
    w = row["mask"][:, None, :, None]
    n_samples = row["mask"].sum(dim=1) * row["Xn"].shape[2]
    f = (loss * w).sum(dim=(2, 3), dtype=torch.float64).to(torch.float32) \
        / n_samples[:, None] \
        + 0.5 * row["lam"][:, None] * (theta * theta).sum(dim=-1)
    return f - row["f_star"][:, None]


def _logistic_solve(X: np.ndarray, y: np.ndarray, lam: float,
                    iters: int = 60) -> tuple:
    """Host-side f64 Newton solve of the regularized logistic objective;
    returns (theta_star, f_star)."""
    n, d = X.shape
    theta = np.zeros(d, np.float64)
    for _ in range(iters):
        m = y * (X @ theta)
        s = 1.0 / (1.0 + np.exp(m))  # σ(−m)
        grad = -(X.T @ (s * y)) / n + lam * theta
        w = s * (1.0 - s)
        H = (X.T * w) @ X / n + lam * np.eye(d)
        step = np.linalg.solve(H, grad)
        theta = theta - step
        if np.linalg.norm(step) < 1e-12:
            break
    f_star = float(np.mean(np.logaddexp(0.0, -y * (X @ theta)))
                   + 0.5 * lam * np.sum(theta**2))
    return theta, f_star


def logistic_mc_problem(X: np.ndarray, y: np.ndarray, n_nodes: int,
                        lam: float = 0.1, *, noniid: bool = True,
                        device: DeviceLike = None) -> MCProblem:
    """Federated logistic regression: the global batch (labels ±1) split
    into `n_nodes` equal shards, label-sorted first when `noniid` (each
    node's local distribution skewed). The risk is the global excess
    objective F(θ) − F*, F* from a host-side f64 Newton solve. The kind is
    stochastic: `run_mc(batch_frac=...)` draws per-slot local
    minibatches."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    if not np.all(np.abs(y) == 1.0):
        raise ValueError("logistic labels must be ±1")
    parts = (partition_noniid(X, y, n_nodes) if noniid
             else partition_rows(X, y, n_nodes))
    k = parts[0][0].shape[0]
    if any(px.shape[0] != k for px, _ in parts):
        raise ValueError(
            f"samples ({X.shape[0]}) must split evenly over {n_nodes} nodes")
    theta_star, f_star = _logistic_solve(X, y, lam)
    arrays = {"Xn": np.stack([px for px, _ in parts]),
              "yn": np.stack([py for _, py in parts]),
              "lam": np.float32(lam), "f_star": np.float32(f_star),
              "theta_star": theta_star}
    return MCProblem(kind="logistic",
                     data=_to_tensors(arrays, resolve_device(device)),
                     n_nodes=int(n_nodes), dim=int(X.shape[1]),
                     stochastic=True)


def problem_from_arrays(kind: str, arrays: dict, n_nodes: int, dim: int,
                        device: DeviceLike = None) -> MCProblem:
    """Build the port's problem from another implementation's data arrays
    — e.g. `{k: np.asarray(v) for k, v in jax_problem.data.items()}` — so
    both compute on identical inputs (including the f64-built `H`). A
    kind with a minibatch gradient gives a stochastic problem."""
    if kind not in PROBLEMS:
        raise ValueError(f"problem kind {kind!r} is not registered")
    return MCProblem(kind=kind,
                     data=_to_tensors(arrays, resolve_device(device)),
                     n_nodes=int(n_nodes), dim=int(dim),
                     stochastic=PROBLEMS[kind].sample_indices_row
                     is not None)


# Localization sensor positions pad far from the search region, so the
# padded rows' 1/d² terms stay finite before the mask zeroes them (a
# padded sensor at the source would give 0·inf = NaN).
register_problem("quadratic", _quadratic_grad_row, _quadratic_risk_row,
                 {"X": 0.0, "y": 0.0})
register_problem("localization", _localization_grad_row,
                 _localization_risk_row, {"r": 1.0e6, "x": 0.0})
register_problem("logistic", _logistic_grad_row, _logistic_risk_row,
                 {"Xn": 0.0, "yn": 0.0}, sample_axis_field="Xn",
                 sample_indices_row=_logistic_sample_idx_row,
                 stochastic_grad_from_idx=_logistic_sgrad_from_idx_row)
