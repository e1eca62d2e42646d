"""Synthetic sparse operand generators: Erdős–Rényi, R-MAT and banded.

Deterministic given a seed, and bit-identical to the JAX package's
generators (``formats/generators.py``) for the same arguments: both draw
from ``numpy.random.default_rng`` in the same order.
"""

from __future__ import annotations

import numpy as np

from outerspace_tpu_torch.formats.coo import COO, INDEX_DTYPE, VALUE_DTYPE


def erdos_renyi(
    n_rows: int,
    n_cols: int,
    density: float,
    seed: int = 0,
    values: str = "uniform",
) -> COO:
    """ER random matrix with ~``density * n_rows * n_cols`` distinct nnz."""
    rng = np.random.default_rng(seed)
    target = int(round(density * n_rows * n_cols))
    target = min(target, n_rows * n_cols)
    total = n_rows * n_cols
    if total <= 1 << 24:
        lin = rng.choice(total, size=target, replace=False)
    else:
        # Oversample + dedup for huge index spaces (choice without
        # replacement would materialise the full range); iterate until
        # the requested nnz is reached.
        lin = np.unique(rng.integers(0, total, size=int(target * 1.2) + 16))
        while lin.shape[0] < target:
            extra = rng.integers(0, total, size=target - lin.shape[0] + 16)
            lin = np.unique(np.concatenate([lin, extra]))
        lin = rng.permutation(lin)[:target]
    rows = (lin // n_cols).astype(INDEX_DTYPE)
    cols = (lin % n_cols).astype(INDEX_DTYPE)
    vals = _gen_values(rng, rows.shape[0], values)
    return COO((n_rows, n_cols), rows, cols, vals)


def rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    values: str = "uniform",
) -> COO:
    """R-MAT (Graph500-style) power-law square matrix, 2**scale per side.

    Recursive quadrant sampling with probabilities (a, b, c, d=1-a-b-c);
    duplicate edges are summed away.
    """
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    ab = a + b
    c_norm = c / max(1.0 - ab, 1e-12)
    a_norm = a / max(ab, 1e-12)
    for bit in range(scale):
        r_bit = rng.random(m) > ab
        c_bit = np.where(
            r_bit,
            rng.random(m) > c_norm,
            rng.random(m) > a_norm,
        )
        rows |= r_bit.astype(np.int64) << bit
        cols |= c_bit.astype(np.int64) << bit
    vals = _gen_values(rng, m, values)
    coo = COO(
        (n, n),
        rows.astype(INDEX_DTYPE),
        cols.astype(INDEX_DTYPE),
        vals,
    )
    return coo.deduplicated()


def banded(n: int, bandwidth: int, seed: int = 0) -> COO:
    """n × n band matrix: every entry within ``bandwidth`` of the
    diagonal, ordered by diagonal offset, uniform values in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    for off in range(-bandwidth, bandwidth + 1):
        r = np.arange(max(0, -off), min(n, n - off))
        rows_l.append(r)
        cols_l.append(r + off)
    rows = np.concatenate(rows_l).astype(INDEX_DTYPE)
    cols = np.concatenate(cols_l).astype(INDEX_DTYPE)
    vals = _gen_values(rng, rows.shape[0], "uniform")
    return COO((n, n), rows, cols, vals)


def _gen_values(rng, n: int, kind: str) -> np.ndarray:
    if kind == "ones":
        return np.ones(n, dtype=VALUE_DTYPE)
    if kind == "uniform":
        return (rng.random(n, dtype=np.float32) + 0.5).astype(VALUE_DTYPE)
    if kind == "normal":
        return rng.standard_normal(n, dtype=np.float32).astype(VALUE_DTYPE)
    raise ValueError(f"unknown value kind {kind!r}")
