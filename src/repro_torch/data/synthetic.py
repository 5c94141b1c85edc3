"""Synthetic data generators (numpy copy of `repro.data.synthetic`).

Token streams with power-law unigram statistics and Markov structure for
language-model training (no corpora are needed: the training launcher's
data). An MSD-like regression set matching the paper's federated experiment: 90
audio-feature covariates, a "release year" linear target + noise, one
sample per node (paper §VI-A). Statistics (feature scale, year range) match
the UCI YearPredictionMSD layout so the regularized least-squares objective
(27) has comparable conditioning. Also the binary classification set of
the federated logistic experiment (Fig. 8) and the source-localization
field of paper §VI-B (Fig. 5). The same seed gives the same arrays as the
reference generators.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenDatasetConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticTokens:
    """Deterministic, seekable synthetic token batches (B, S+1) int32,
    numpy arrays equal to the reference's for the same config."""

    def __init__(self, cfg: TokenDatasetConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # power-law unigram distribution over a shuffled vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        probs /= probs.sum()
        self._probs = probs[rng.permutation(v)]
        # cheap Markov structure: each token biases the next toward t+1 mod v
        self._carry = 0.3

    def batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len + 1
        iid = rng.choice(cfg.vocab_size, size=(b, s), p=self._probs)
        out = iid.copy()
        stay = rng.random((b, s)) < self._carry
        for t in range(1, s):
            out[:, t] = np.where(stay[:, t],
                                 (out[:, t - 1] + 1) % cfg.vocab_size,
                                 iid[:, t])
        return out.astype(np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def msd_like_regression(n_samples: int, dim: int = 90, seed: int = 0,
                        noise_std: float = 0.1):
    """(X, y, theta_true): standardized features, linear target like the
    Million-Song year-prediction task of paper §VI-A."""
    rng = np.random.default_rng(seed)
    # anisotropic covariance: audio features are correlated
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    scales = np.exp(rng.uniform(-1.0, 1.0, size=dim))
    X = rng.standard_normal((n_samples, dim)) * scales[None]
    X = X @ q.T
    X /= X.std(axis=0, keepdims=True)
    theta = rng.standard_normal(dim) / np.sqrt(dim)
    y = X @ theta + noise_std * rng.standard_normal(n_samples)
    return X.astype(np.float64), y.astype(np.float64), theta


def logistic_classification(n_samples: int, dim: int = 16, seed: int = 0,
                            margin: float = 1.0, flip_frac: float = 0.05):
    """(X, y in {-1, +1}, theta_true): linearly separable-ish binary
    classification for the federated logistic-regression experiment
    (Fig. 8). Features share the correlated covariance of
    `msd_like_regression`; labels follow a ground-truth halfspace whose
    norm `margin` sets the logit scale, and a small label-flip fraction
    keeps the Bayes risk nonzero (a finite regularized optimum)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    scales = np.exp(rng.uniform(-1.0, 1.0, size=dim))
    X = rng.standard_normal((n_samples, dim)) * scales[None]
    X = X @ q.T
    X /= X.std(axis=0, keepdims=True)
    theta = rng.standard_normal(dim) / np.sqrt(dim) * margin
    y = np.sign(X @ theta + 1e-12)
    flip = rng.random(n_samples) < flip_frac
    y = np.where(flip, -y, y)
    return X.astype(np.float64), y.astype(np.float64), theta


def localization_field(n_sensors: int, field: float = 100.0,
                       source=(60.0, 60.0), signal_a: float = 100.0,
                       snr_db: float = -10.0, min_radius: float = 8.0,
                       seed: int = 0):
    """Source-localization sensing setup of paper §VI-B: N sensors at known
    positions on a field x field m^2 area (>= min_radius from the source),
    far-field magnitude measurements x_n = A/||theta-r_n||^2 + v_n.
    Returns (r, x, src, noise_std)."""
    rng = np.random.default_rng(seed)
    src = np.asarray(source, np.float64)
    pts = []
    while len(pts) < n_sensors:
        cand = rng.uniform(0.0, field, size=(n_sensors, 2))
        keep = np.linalg.norm(cand - src[None], axis=1) >= min_radius
        pts.extend(cand[keep].tolist())
    r = np.asarray(pts[:n_sensors], np.float64)
    s = signal_a / np.sum((src[None] - r) ** 2, axis=1)
    sig_pow = np.mean(s**2)
    noise_std = np.sqrt(sig_pow / (10.0 ** (snr_db / 10.0)))
    x = s + noise_std * rng.standard_normal(n_sensors)
    return r, x, src, noise_std
