"""CSR / CSC compressed sparse containers.

``indptr`` (int64) / ``indices`` (int32) / ``data`` (float32) numpy
struct-of-arrays with scipy naming, as in the JAX package
(``formats/csr.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from outerspace_tpu_torch.formats.coo import COO, INDEX_DTYPE, VALUE_DTYPE


def _compress(
    major: np.ndarray,
    minor: np.ndarray,
    val: np.ndarray,
    n_major: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort by (major, minor) and build the prefix ``indptr`` array."""
    p = np.lexsort((minor, major))
    major, minor, val = major[p], minor[p], val[p]
    counts = np.bincount(major, minlength=n_major)
    indptr = np.zeros(n_major + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, np.ascontiguousarray(minor), np.ascontiguousarray(val)


@dataclasses.dataclass
class _Compressed:
    shape: tuple[int, int]
    indptr: np.ndarray  # int64, len = n_major + 1
    indices: np.ndarray  # int32, len = nnz
    data: np.ndarray  # float32, len = nnz

    def __post_init__(self) -> None:
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        self.indptr = np.ascontiguousarray(self.indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(self.indices, dtype=INDEX_DTYPE)
        self.data = np.ascontiguousarray(self.data, dtype=VALUE_DTYPE)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def major_nnz(self) -> np.ndarray:
        """nnz per major slice (row for CSR, column for CSC)."""
        return np.asarray(self.indptr[1:] - self.indptr[:-1], dtype=INDEX_DTYPE)


class CSR(_Compressed):
    """Compressed sparse row: ``indices`` are column ids, rows contiguous."""

    @classmethod
    def from_coo(cls, coo: COO) -> "CSR":
        indptr, indices, data = _compress(
            coo.row, coo.col, coo.val, coo.shape[0]
        )
        return cls(coo.shape, indptr, indices, data)

    def to_coo(self) -> COO:
        rows = np.repeat(
            np.arange(self.shape[0], dtype=INDEX_DTYPE), self.major_nnz()
        )
        return COO(self.shape, rows, self.indices, self.data)

    def to_csc(self) -> "CSC":
        return CSC.from_coo(self.to_coo())

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape
        )

    @classmethod
    def from_scipy(cls, m) -> "CSR":
        m = m.tocsr()
        m.sort_indices()
        return cls(m.shape, m.indptr, m.indices, m.data)

    def __repr__(self) -> str:  # pragma: no cover
        return f"CSR(shape={self.shape}, nnz={self.nnz})"


class CSC(_Compressed):
    """Compressed sparse column: ``indices`` are row ids, columns contiguous."""

    @classmethod
    def from_coo(cls, coo: COO) -> "CSC":
        indptr, indices, data = _compress(
            coo.col, coo.row, coo.val, coo.shape[1]
        )
        return cls(coo.shape, indptr, indices, data)

    def to_coo(self) -> COO:
        cols = np.repeat(
            np.arange(self.shape[1], dtype=INDEX_DTYPE), self.major_nnz()
        )
        return COO(self.shape, self.indices, cols, self.data)

    def to_csr(self) -> CSR:
        return CSR.from_coo(self.to_coo())

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csc_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape
        )

    @classmethod
    def from_scipy(cls, m) -> "CSC":
        m = m.tocsc()
        m.sort_indices()
        return cls(m.shape, m.indptr, m.indices, m.data)

    def __repr__(self) -> str:  # pragma: no cover
        return f"CSC(shape={self.shape}, nnz={self.nnz})"
