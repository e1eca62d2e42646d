"""Symbolic (nnz-sizing) pass: everything shape-like about ``C = A @ B``
computed on the host before any device work.

- the exact partial-product (expansion) count
  ``P = Σₑ nnz(B.row(col(e)))`` over nonzeros *e* of A;
- the expansion offsets of each A nonzero;
- bucketed padding sizes (``round_up_bucket``).

A numpy copy of the JAX package's ``ops/symbolic.py`` trimmed to what the
gather and tiled pipelines use; both packages build identical plans from it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from outerspace_tpu_torch.formats.csr import CSC, CSR


def round_up_bucket(n: int, min_size: int = 256) -> int:
    """Smallest bucket ≥ n from the {2^k, 1.25·2^k, 1.5·2^k, 1.75·2^k}
    grid (≥ min_size): bounds padding waste to ≤25%."""
    n = max(int(n), min_size)
    pow2 = 1 << (n - 1).bit_length()
    for frac in (4, 5, 6, 7):
        cand = (pow2 // 8) * frac
        if cand >= n:
            return cand
    return pow2


@dataclasses.dataclass
class ExpansionPlan:
    """Host-side static plan for one SpGEMM, sized by nnz(A) / nnz(B)."""

    m: int  # rows of C
    n: int  # cols of C
    k: int  # inner dimension
    # Per-nonzero-of-A (CSC order): output row, value, outer index k.
    a_rows: np.ndarray  # int32[nnz_a]
    a_vals: np.ndarray  # f32[nnz_a]
    a_k: np.ndarray  # int32[nnz_a]
    # B in CSR form.
    b_indptr: np.ndarray  # int64[k+1]
    b_cols: np.ndarray  # int32[nnz_b]
    b_vals: np.ndarray  # f32[nnz_b]
    # Partial products of A-nonzero e occupy [offsets[e], offsets[e+1]).
    offsets: np.ndarray  # int64[nnz_a + 1]

    @property
    def expansion_size(self) -> int:
        """Exact partial-product count P (= multiply-phase FLOPs)."""
        return int(self.offsets[-1])

    def padded_size(self, min_size: int = 256) -> int:
        """The bucketed stream length (``round_up_bucket``) for P."""
        return round_up_bucket(max(self.expansion_size, 1), min_size)


def expansion_plan(a_csc: CSC, b_csr: CSR) -> ExpansionPlan:
    """Build the symbolic plan for ``C = A @ B`` from CSC(A) and CSR(B)."""
    if a_csc.shape[1] != b_csr.shape[0]:
        raise ValueError(
            f"inner dimensions differ: {a_csc.shape} @ {b_csr.shape}"
        )
    k_dim = a_csc.shape[1]
    a_nnz_per_col = a_csc.major_nnz().astype(np.int64)
    a_k = np.repeat(np.arange(k_dim, dtype=np.int32), a_nnz_per_col)
    b_row_nnz = b_csr.major_nnz().astype(np.int64)
    counts = b_row_nnz[a_k]
    offsets = np.zeros(a_k.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return ExpansionPlan(
        m=a_csc.shape[0],
        n=b_csr.shape[1],
        k=k_dim,
        a_rows=a_csc.indices,
        a_vals=a_csc.data,
        a_k=a_k,
        b_indptr=b_csr.indptr,
        b_cols=b_csr.indices,
        b_vals=b_csr.data,
        offsets=offsets,
    )


def expansion_plan_subset(
    a_csc: CSC, b_csr: CSR, k_subset: np.ndarray
) -> ExpansionPlan:
    """Expansion plan restricted to outer indices in ``k_subset``."""
    k_dim = a_csc.shape[1]
    keep_k = np.zeros(k_dim, dtype=bool)
    keep_k[k_subset] = True
    a_nnz_per_col = a_csc.major_nnz().astype(np.int64)
    a_k = np.repeat(np.arange(k_dim, dtype=np.int32), a_nnz_per_col)
    keep_e = keep_k[a_k]
    a_k = a_k[keep_e]
    b_row_nnz = b_csr.major_nnz().astype(np.int64)
    counts = b_row_nnz[a_k]
    offsets = np.zeros(a_k.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return ExpansionPlan(
        m=a_csc.shape[0],
        n=b_csr.shape[1],
        k=k_dim,
        a_rows=a_csc.indices[keep_e],
        a_vals=a_csc.data[keep_e],
        a_k=a_k,
        b_indptr=b_csr.indptr,
        b_cols=b_csr.indices,
        b_vals=b_csr.data,
        offsets=offsets,
    )
