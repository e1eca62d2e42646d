"""COO (coordinate) sparse matrix container.

Struct-of-arrays (``row``/``col``/``val`` numpy vectors): the same buffers
move to the card as flat int32 / float32 tensors with no repacking. Index
dtype int32, values float32, as in the JAX package (``formats/coo.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

INDEX_DTYPE = np.int32
VALUE_DTYPE = np.float32


@dataclasses.dataclass
class COO:
    """Sparse matrix in coordinate format (struct-of-arrays)."""

    shape: tuple[int, int]
    row: np.ndarray
    col: np.ndarray
    val: np.ndarray

    def __post_init__(self) -> None:
        self.row = np.ascontiguousarray(self.row, dtype=INDEX_DTYPE)
        self.col = np.ascontiguousarray(self.col, dtype=INDEX_DTYPE)
        self.val = np.ascontiguousarray(self.val, dtype=VALUE_DTYPE)
        if not (self.row.shape == self.col.shape == self.val.shape):
            raise ValueError(
                f"COO arrays must have equal length: "
                f"{self.row.shape} / {self.col.shape} / {self.val.shape}"
            )
        if self.row.ndim != 1:
            raise ValueError("COO arrays must be 1-D")
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        if self.nnz:
            if self.row.min(initial=0) < 0 or self.col.min(initial=0) < 0:
                raise ValueError("negative coordinate in COO")
            if self.row.max() >= self.shape[0] or self.col.max() >= self.shape[1]:
                raise ValueError("coordinate out of bounds for shape")

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    def argsort_rowmajor(self) -> np.ndarray:
        """Permutation sorting entries by (row, col)."""
        return np.lexsort((self.col, self.row))

    def deduplicated(self) -> "COO":
        """Sum values at duplicate coordinates (row-major result)."""
        if self.nnz == 0:
            return self
        p = self.argsort_rowmajor()
        r, c, v = self.row[p], self.col[p], self.val[p]
        new = np.ones(self.nnz, dtype=bool)
        new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        seg = np.cumsum(new) - 1
        n = int(seg[-1]) + 1
        out_v = np.zeros(n, dtype=VALUE_DTYPE)
        np.add.at(out_v, seg, v)
        return COO(self.shape, r[new], c[new], out_v)

    def transpose(self) -> "COO":
        return COO((self.shape[1], self.shape[0]), self.col, self.row, self.val)

    def to_csr(self):
        from outerspace_tpu_torch.formats.csr import CSR

        return CSR.from_coo(self)

    def to_csc(self):
        from outerspace_tpu_torch.formats.csr import CSC

        return CSC.from_coo(self)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.coo_matrix(
            (self.val, (self.row, self.col)), shape=self.shape
        )

    @classmethod
    def from_scipy(cls, m) -> "COO":
        m = m.tocoo()
        return cls(m.shape, m.row, m.col, m.data)

    def __repr__(self) -> str:  # pragma: no cover
        return f"COO(shape={self.shape}, nnz={self.nnz})"
