"""Contiguous partitioning, as the JAX package's ``shard/mesh.py`` has it
(only the numpy function the tiled row parts use)."""

from __future__ import annotations

import numpy as np


def balanced_contiguous_partition(weights: np.ndarray, parts: int) -> np.ndarray:
    """Boundaries of a contiguous partition of ``weights`` into ``parts``
    with about equal weight each.

    Returns int64[parts + 1] boundaries over ``len(weights)`` items,
    monotone even where weights are zero."""
    n = len(weights)
    total = float(weights.sum())
    cum = np.concatenate([[0.0], np.cumsum(weights, dtype=np.float64)])
    targets = np.linspace(0, total, parts + 1)
    bounds = np.searchsorted(cum, targets[1:-1], side="left")
    bounds = np.concatenate([[0], bounds, [n]]).astype(np.int64)
    return np.maximum.accumulate(bounds)
