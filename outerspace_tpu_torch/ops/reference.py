"""Oracles the port is checked with: the scipy product and a hard-failing
CSR comparison (numpy / scipy only, as in the JAX package's
``ops/reference.py``)."""

from __future__ import annotations

import numpy as np

from outerspace_tpu_torch.formats.coo import COO
from outerspace_tpu_torch.formats.csr import CSC, CSR


def spgemm_scipy(a: COO | CSR | CSC, b: COO | CSR | CSC) -> CSR:
    """scipy oracle: C = A @ B with sorted indices and summed duplicates."""
    c = a.to_scipy().tocsr() @ b.to_scipy().tocsr()
    c.sum_duplicates()
    c.sort_indices()
    return CSR.from_scipy(c)


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
