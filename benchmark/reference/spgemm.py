"""Plain PyTorch sparse products: the reference the benchmark holds the
program's answers to.

``csr_matmul`` forms every partial product ``A[i,k]·B[k,j]`` of a block
of A's rows, sorts the block's products by ``i·n + j`` and sums each run
with ``index_add_``. Blocks hold at most ``block_products`` products, so
the reference fits beside nothing else on the card, or on the host at
test sizes. It imports nothing of the program.

``precision`` says how values are computed: "float64" (the reference)
or "bfloat16" (the control: every input value and every output value
rounded to bfloat16, the products and sums in float32 — storing values
in bfloat16 is the cheapest precision a faster program could drop to).
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "bfloat16")


def _values(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float64":
        return x.to(torch.float64)
    return x.to(torch.bfloat16).to(torch.float32)


def csr_matmul(a, b, *, precision: str = "float64", device="cpu", block_products: int = 1 << 24):
    """C = A @ B for CSRs given as ``(shape, indptr, indices, data)``
    (numpy arrays or tensors). Returns C the same way, as tensors on
    ``device``: indptr int64, indices int64, data float64 (float32 for
    the bfloat16 control, whose values are rounded to bfloat16)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    (m, ka), a_ptr, a_idx, a_val = a
    (kb, n), b_ptr, b_idx, b_val = b
    if ka != kb:
        raise ValueError(f"inner dimensions differ: {(m, ka)} @ {(kb, n)}")

    def t(x, dtype=None):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    a_ptr, a_idx, a_val = t(a_ptr, torch.int64), t(a_idx, torch.int64), _values(t(a_val), precision)
    b_ptr, b_idx, b_val = t(b_ptr, torch.int64), t(b_idx, torch.int64), _values(t(b_val), precision)
    a_row = torch.repeat_interleave(torch.arange(m, device=device), a_ptr[1:] - a_ptr[:-1])
    deg = (b_ptr[1:] - b_ptr[:-1])[a_idx]  # products of each A element
    row_products = torch.zeros(m, dtype=torch.int64, device=device).index_add_(0, a_row, deg)
    row_cum = torch.cumsum(row_products, 0).cpu()
    rows_out, cols_out, vals_out = [], [], []
    lo = 0
    while lo < m:
        # the longest run of rows from lo whose products fit the block
        base = int(row_cum[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(row_cum, torch.tensor(base + block_products), right=True))
        hi = max(hi, lo + 1)
        e0, e1 = int(a_ptr[lo]), int(a_ptr[hi])
        counts = deg[e0:e1]
        p = int(counts.sum())
        if p:
            src = torch.repeat_interleave(torch.arange(e0, e1, device=device), counts)
            first = torch.cumsum(counts, 0) - counts
            pos = b_ptr[a_idx[src]] + torch.arange(p, device=device) - first[src - e0]
            key = (a_row[src] - lo) * n + b_idx[pos]
            prod = a_val[src] * b_val[pos]
            key, order = torch.sort(key)
            uniq, inverse = torch.unique_consecutive(key, return_inverse=True)
            sums = torch.zeros(uniq.shape[0], dtype=prod.dtype, device=device)
            sums.index_add_(0, inverse, prod[order])
            rows_out.append(uniq // n + lo)
            cols_out.append(uniq % n)
            vals_out.append(sums)
        lo = hi
    rows = torch.cat(rows_out) if rows_out else torch.zeros(0, dtype=torch.int64, device=device)
    cols = torch.cat(cols_out) if cols_out else torch.zeros(0, dtype=torch.int64, device=device)
    vals = torch.cat(vals_out) if vals_out else torch.zeros(0, dtype=torch.float64, device=device)
    if precision == "bfloat16":
        vals = vals.to(torch.bfloat16).to(torch.float32)
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
    return (m, n), indptr, cols, vals
