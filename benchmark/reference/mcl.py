"""Plain PyTorch Markov clustering: the reference for the MCL cells.

``flow_of`` builds the chain's input from a graph, as the benchmark
hands it to the program: self loops of weight 1 added to |A|,
duplicates summed, each column divided by its sum (in float64, then
rounded to float32). ``mcl`` runs the recurrence the program states:
per iteration the flow squared (:func:`.spgemm.csr_matmul`), every
entry whose power ``v**inflation`` is not above ``threshold`` pruned,
the survivors powered and each column divided by its sum.

Pruning is a comparison with a threshold, so a value that lies within
rounding of it may be kept by one correct computation and pruned by
another, and the column it sits in differs from then on. ``mcl`` marks
such columns: an entry whose power lies within ``band`` (relative) of
the threshold makes its column uncertain, and an uncertain column ``c``
makes uncertain every column that the next squaring mixes it into
(the columns ``j`` with an entry at ``(c, j)``). The comparison judges
the other columns only (:func:`.compare.compare_flows`).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.spgemm import csr_matmul

# a row is an attractor where its diagonal entry exceeds this (as the
# port's ``mcl_clusters`` reads a flow)
ATTRACTOR_MIN = 1e-6


def flow_of(graph):
    """The column-normalised, self-looped |A| of a CSR graph, as a CSR
    of numpy arrays with float32 values."""
    (n, n2), indptr, indices, data = graph
    if n != n2:
        raise ValueError(f"MCL needs a square graph, got {(n, n2)}")
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    r = np.concatenate([rows, np.arange(n)])
    c = np.concatenate([indices.astype(np.int64), np.arange(n)])
    v = np.concatenate([np.abs(data).astype(np.float32), np.ones(n, np.float32)])
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    new = np.ones(r.shape[0], dtype=bool)
    new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    seg = np.cumsum(new) - 1
    vals = np.zeros(int(seg[-1]) + 1, dtype=np.float32)
    np.add.at(vals, seg, v)
    r, c = r[new], c[new]
    colsum = np.bincount(c, weights=vals.astype(np.float64), minlength=n)
    colsum[colsum == 0] = 1.0
    vals = (vals.astype(np.float64) / colsum[c]).astype(np.float32)
    out_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=out_ptr[1:])
    return (n, n), out_ptr, c.astype(np.int32), vals


def mcl(flow, *, iters: int, inflation: float, threshold: float, precision: str = "float64",
        device="cpu", band: float = 0.0):
    """``iters`` MCL iterations from ``flow`` (a CSR). Returns (the final
    flow as a CSR of tensors, a bool tensor of uncertain columns, and per
    iteration the count of entries within ``band`` of the threshold)."""
    (n, _), indptr, indices, data = flow
    m = ((n, n), torch.as_tensor(indptr).to(device), torch.as_tensor(indices).to(device).long(),
         torch.as_tensor(data).to(device))
    uncertain = torch.zeros(n, dtype=torch.bool, device=device)
    near_counts = []
    for _ in range(iters):
        (_, _), ptr, idx, _ = m
        # uncertain columns mix into the columns of their rows' entries
        rows = torch.repeat_interleave(torch.arange(n, device=device), ptr[1:] - ptr[:-1])
        hit = uncertain[rows]
        uncertain = uncertain.clone()
        uncertain[idx[hit]] = True
        sq = csr_matmul(m, m, precision=precision, device=device)
        (_, _), sptr, scol, sval = sq
        srow = torch.repeat_interleave(torch.arange(n, device=device), sptr[1:] - sptr[:-1])
        v = torch.clamp(sval, min=0.0)
        vp = v.to(torch.float64) ** inflation if precision == "float64" else _bf16(v ** inflation)
        keep = vp > threshold
        near = (vp.to(torch.float64) - threshold).abs() <= band * threshold
        near_counts.append(int(near.sum()))
        uncertain[scol[near]] = True
        r, c, w = srow[keep], scol[keep], vp[keep]
        colsum = torch.zeros(n, dtype=w.dtype, device=device).index_add_(0, c, w)
        colsum = torch.where(colsum == 0, torch.ones_like(colsum), colsum)
        w = w / colsum[c]
        if precision != "float64":
            w = _bf16(w)
        ptr2 = torch.zeros(n + 1, dtype=torch.int64, device=device)
        ptr2[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
        m = ((n, n), ptr2, c, w)
    return m, uncertain, near_counts


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def clusters(flow, cols_ok=None) -> set:
    """The clusters of a final flow (numpy or tensor CSR): each row whose
    diagonal entry exceeds :data:`ATTRACTOR_MIN` (an attractor) with the
    columns of its stored nonzeros, as a set of member tuples. With
    ``cols_ok`` (bool per column) only attractors and members in those
    columns count."""
    (n, _), indptr, indices, data = flow
    indptr, indices, data = (np.asarray(torch.as_tensor(x).cpu()) for x in (indptr, indices, data))
    rows = np.repeat(np.arange(n), np.diff(indptr))
    diag = np.zeros(n)
    on = rows == indices
    diag[rows[on]] = data[on]
    out = set()
    ok = np.ones(n, dtype=bool) if cols_ok is None else np.asarray(cols_ok)
    for a in np.nonzero((diag > ATTRACTOR_MIN) & ok)[0]:
        lo, hi = indptr[a], indptr[a + 1]
        members = indices[lo:hi][(data[lo:hi] != 0) & ok[indices[lo:hi]]]
        if members.size:
            out.add(tuple(sorted(members.tolist())))
    return out
