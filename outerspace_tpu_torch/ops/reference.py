"""The host reference of the outer-product SpGEMM and the oracles the
port is checked with (numpy / scipy only, as the JAX package's
``ops/reference.py``).

``spgemm_tasks`` runs the algorithm's two phases eagerly on the host: a
multiply phase pairing each element of column k of A with row k of B
(one partial row of C each), and a merge phase that per output row
concatenates its partial rows, sorts them by column and sums equal
columns (in float64). It returns C with the task lists and the
multiply-phase FLOP count, which the command line prints
(:func:`spgemm_flops`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from outerspace_tpu_torch.formats.coo import COO, INDEX_DTYPE, VALUE_DTYPE
from outerspace_tpu_torch.formats.csr import CSC, CSR


@dataclasses.dataclass
class MultiplyTask:
    """One outer-product pairing: a single element of column ``k`` of A
    scaled against all of row ``k`` of B, producing one partial row of C."""

    k: int  # outer-product index (column of A / row of B)
    out_row: int  # row of C this partial row belongs to
    a_val: float
    b_cols: np.ndarray  # column ids of the partial row
    b_vals: np.ndarray  # values of row k of B (unscaled)

    @property
    def flops(self) -> int:
        return int(self.b_cols.shape[0])


@dataclasses.dataclass
class MergeTask:
    """Accumulation of all partial rows landing in one output row."""

    out_row: int
    input_sizes: list[int]
    output_nnz: int

    @property
    def ways(self) -> int:
        return len(self.input_sizes)


@dataclasses.dataclass
class SpGEMMResult:
    c: CSR
    multiply_tasks: list[MultiplyTask]
    merge_tasks: list[MergeTask]
    flops: int  # multiply-phase FLOPs = Σ nnz(colA_i)·nnz(rowB_i)


def spgemm_tasks(a_csc: CSC, b_csr: CSR, with_tasks: bool = True) -> SpGEMMResult:
    """Run both phases and return C, the multiply and merge task lists
    (empty without ``with_tasks``) and the multiply-phase FLOP count."""
    if a_csc.shape[1] != b_csr.shape[0]:
        raise ValueError(f"inner dimensions differ: {a_csc.shape} @ {b_csr.shape}")
    m, n = a_csc.shape[0], b_csr.shape[1]

    # multiply phase: each element of column k of A scales row k of B
    partial_rows: dict[int, list[tuple[np.ndarray, np.ndarray]]] = {}
    multiply_tasks: list[MultiplyTask] = []
    flops = 0
    for k in range(a_csc.shape[1]):
        a_lo, a_hi = a_csc.indptr[k], a_csc.indptr[k + 1]
        b_lo, b_hi = b_csr.indptr[k], b_csr.indptr[k + 1]
        if a_lo == a_hi or b_lo == b_hi:
            continue
        b_cols, b_vals = b_csr.indices[b_lo:b_hi], b_csr.data[b_lo:b_hi]
        flops += int((a_hi - a_lo) * (b_hi - b_lo))
        for r, av in zip(a_csc.indices[a_lo:a_hi], a_csc.data[a_lo:a_hi]):
            partial_rows.setdefault(int(r), []).append((b_cols, av * b_vals))
            if with_tasks:
                multiply_tasks.append(MultiplyTask(k, int(r), float(av), b_cols, b_vals))

    # merge phase: per output row, concatenate, sort by column, sum
    merge_tasks: list[MergeTask] = []
    out_indptr = np.zeros(m + 1, dtype=np.int64)
    out_cols: list[np.ndarray] = []
    out_vals: list[np.ndarray] = []
    for r in sorted(partial_rows):
        parts = partial_rows[r]
        cols = np.concatenate([p[0] for p in parts])
        vals = np.concatenate([p[1] for p in parts])
        order = np.argsort(cols, kind="stable")
        cols, vals = cols[order], vals[order]
        new = np.ones(cols.shape[0], dtype=bool)
        new[1:] = cols[1:] != cols[:-1]
        seg = np.cumsum(new) - 1
        acc = np.zeros(int(seg[-1]) + 1, dtype=np.float64)
        np.add.at(acc, seg, vals.astype(np.float64))
        out_indptr[r + 1] = acc.shape[0]
        out_cols.append(cols[new])
        out_vals.append(acc.astype(VALUE_DTYPE))
        if with_tasks:
            merge_tasks.append(MergeTask(r, [int(p[0].shape[0]) for p in parts], acc.shape[0]))
    np.cumsum(out_indptr, out=out_indptr)
    c = CSR(
        (m, n),
        out_indptr,
        np.concatenate(out_cols) if out_cols else np.zeros(0, INDEX_DTYPE),
        np.concatenate(out_vals) if out_vals else np.zeros(0, VALUE_DTYPE),
    )
    return SpGEMMResult(c, multiply_tasks, merge_tasks, flops)


def spgemm_reference(a: COO | CSR | CSC, b: COO | CSR | CSC) -> CSR:
    """C = A @ B by :func:`spgemm_tasks` (no task lists)."""
    a_csc = a if isinstance(a, CSC) else a.to_csc()
    b_csr = b if isinstance(b, CSR) else b.to_csr()
    return spgemm_tasks(a_csc, b_csr, with_tasks=False).c


def spgemm_scipy(a: COO | CSR | CSC, b: COO | CSR | CSC) -> CSR:
    """scipy oracle: C = A @ B with sorted indices and summed duplicates."""
    c = a.to_scipy().tocsr() @ b.to_scipy().tocsr()
    c.sum_duplicates()
    c.sort_indices()
    return CSR.from_scipy(c)


def spgemm_flops(a_csc: CSC, b_csr: CSR) -> int:
    """Multiply-phase FLOP count Σᵢ nnz(column i of A)·nnz(row i of B),
    the numerator of the command line's GFLOP/s."""
    return int(np.dot(a_csc.major_nnz().astype(np.int64), b_csr.major_nnz().astype(np.int64)))


def compare_coo(a: COO, b: COO, eps: float = 1e-6, relative: bool = True) -> bool:
    """Whether two COOs hold the same coordinates (row-major sorted) and
    values within ``eps``: relative to the larger magnitude (an exact 0
    against 0 passes), or absolute with ``relative=False``."""
    if a.shape != b.shape or a.nnz != b.nnz:
        return False
    sa, sb = a.sorted_rowmajor(), b.sorted_rowmajor()
    if not (np.array_equal(sa.row, sb.row) and np.array_equal(sa.col, sb.col)):
        return False
    if relative:
        denom = np.maximum(np.abs(sa.val), np.abs(sb.val))
        denom = np.where(denom == 0, 1.0, denom)
        return bool(np.all(np.abs(sa.val - sb.val) / denom <= eps))
    return bool(np.all(np.abs(sa.val - sb.val) <= eps))


def assert_csr_allclose(
    actual: CSR, expected: CSR, rtol: float = 1e-6, atol: float = 1e-6
) -> None:
    """nnz, indptr and indices exact; values within (rtol, atol)."""
    if actual.shape != expected.shape:
        raise AssertionError(f"shape {actual.shape} != {expected.shape}")
    if actual.nnz != expected.nnz:
        raise AssertionError(f"nnz {actual.nnz} != {expected.nnz}")
    np.testing.assert_array_equal(actual.indptr, expected.indptr)
    np.testing.assert_array_equal(actual.indices, expected.indices)
    np.testing.assert_allclose(actual.data, expected.data, rtol=rtol, atol=atol)
