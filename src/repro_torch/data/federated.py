"""Federated partitioning: map a global batch onto GBMA nodes (numpy copy
of `repro.data.federated`).

The paper's setting assigns each sample (or local dataset) to one node;
the node computes its local gradient g_n and transmits over the MAC. The
global batch is partitioned into `n_nodes` contiguous example groups, one
per node.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FederatedSpec:
    n_nodes: int
    global_batch: int

    def __post_init__(self):
        if self.global_batch % self.n_nodes:
            raise ValueError(
                f"global_batch {self.global_batch} must divide into "
                f"{self.n_nodes} nodes")

    @property
    def examples_per_node(self) -> int:
        return self.global_batch // self.n_nodes

    def node_of_example(self) -> np.ndarray:
        return np.repeat(np.arange(self.n_nodes), self.examples_per_node)


def partition_rows(X: np.ndarray, y: np.ndarray, n_nodes: int) -> list:
    """Row-partition a dataset across nodes (paper §VI-A: one sample per
    device). Returns a list of (X_n, y_n)."""
    idx = np.array_split(np.arange(X.shape[0]), n_nodes)
    return [(X[i], y[i]) for i in idx]


def partition_noniid(X: np.ndarray, y: np.ndarray, n_nodes: int) -> list:
    """Label-skewed (non-iid) partition: sort the examples by target value
    (stable, so ties keep dataset order) and hand out contiguous shards,
    so each node sees a narrow slice of the label distribution (federated
    SGD over wireless channels, Amiri & Gündüz arXiv:1907.09769). Returns
    a list of (X_n, y_n)."""
    order = np.argsort(y, kind="stable")
    return partition_rows(X[order], y[order], n_nodes)
