"""Synthetic data generators (numpy copy of `repro.data.synthetic`).

An MSD-like regression set matching the paper's federated experiment: 90
audio-feature covariates, a "release year" linear target + noise, one
sample per node (paper §VI-A). Statistics (feature scale, year range) match
the UCI YearPredictionMSD layout so the regularized least-squares objective
(27) has comparable conditioning. The same seed gives the same arrays as
the reference generator.
"""
from __future__ import annotations

import numpy as np


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
