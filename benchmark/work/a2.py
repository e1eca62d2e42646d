"""The work an A·B product needs, whatever computes it: the yardstick of
the A² roofline.

- ``products``: the partial products, Σₖ nnz(A[:,k]) · nnz(B[k,:]); each
  is one multiply and one add, so the operations are ``2 · products``.
- ``bytes``: A read once as CSC and B once as CSR, C written once as
  CSR; a CSR or CSC of ``r`` majors and ``z`` entries is ``8·(r+1)``
  bytes of int64 offsets plus ``z`` int32 indices and ``z`` float32
  values, as the port's host containers (and scipy's) hold them.
"""

from __future__ import annotations

import numpy as np


def csr_bytes(n_major: int, nnz: int) -> int:
    """Bytes of a CSR (or CSC) with ``n_major`` rows and ``nnz`` entries."""
    return 8 * (n_major + 1) + 8 * nnz


def products(a_shape, a_indices, b_indptr) -> int:
    """Σₖ nnz(A[:,k])·nnz(B[k,:]) for A given by its CSR column indices."""
    col_nnz = np.bincount(np.asarray(a_indices), minlength=a_shape[1]).astype(np.int64)
    row_nnz = np.diff(np.asarray(b_indptr)).astype(np.int64)
    return int(np.dot(col_nnz, row_nnz))


def a2_work(shape, indptr, indices, nnz_c: int) -> dict:
    """Products, operations and bytes of A·A for a square CSR A whose
    product holds ``nnz_c`` entries."""
    n_rows, n_cols = shape
    p = products(shape, indices, indptr)
    nnz = int(np.asarray(indices).shape[0])
    return {
        "products": p,
        "flops": 2 * p,
        "bytes": csr_bytes(n_cols, nnz) + csr_bytes(n_rows, nnz) + csr_bytes(n_rows, nnz_c),
    }


def least_seconds(work: dict, peaks: dict) -> tuple[float, str]:
    """The least time a chip with ``peaks`` needs for ``work``, and which
    of its rates bounds it ("bytes" or "flops")."""
    t_bytes = work["bytes"] / peaks["hbm_bytes_per_s"]
    t_flops = work["flops"] / peaks["fp32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")
