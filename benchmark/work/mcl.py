"""The work of one MCL run, whatever computes it: the yardstick of the MCL
kernels' rooflines.

``recurrence`` runs the recurrence the reference states
(``reference/mcl.py``: square, prune the powered values at the
threshold, normalise the columns) in float64 and counts, per squaring,
its partial products ``products`` (Σ over the flow's entries (r, k) of
the entries of row k), the entries of the square ``nnz`` and the
entries that survive the prune ``survivors``. ``mcl_work`` turns the
counts into the bytes the 64-bit-key kernels need, each input byte read
once and each output byte written once, on exact counts and not on the
program's padded budgets:

- ``K2_64_bytes``: K2 over each loop squaring's merged stream, one slot
  a product: the int64 key and float32 value read (12 B) and the row,
  column, value and valid byte written (13 B), 25 B a product;
- ``prune_compact_64_bytes``: the prune and compaction of the first
  squaring's merged stream, one slot a product: 5 B a slot read (value,
  valid byte), and for each survivor its row and column read and its
  int64 key and float32 value written, 20 B a survivor.

``kernel_share`` is what the roofline readers report: those bytes over
the peak bandwidth over the kernels' device time per traced run, the
kernels found in the trace by name.
"""

from __future__ import annotations

import torch

from benchmark.reference.spgemm import csr_matmul
from benchmark.trace import mean

K2_BYTES_PER_PRODUCT = 25
PRUNE_BYTES_PER_SLOT = 5
PRUNE_BYTES_PER_SURVIVOR = 20


def recurrence(flow, *, iters: int, inflation: float, threshold: float, device="cpu") -> dict:
    """Per squaring of ``iters`` MCL iterations from ``flow`` (a CSR):
    ``products``, ``nnz`` and ``survivors`` (lists of ints)."""
    (n, _), indptr, indices, data = flow
    m = ((n, n), torch.as_tensor(indptr).to(device), torch.as_tensor(indices).to(device).long(),
         torch.as_tensor(data).to(device))
    out = {"products": [], "nnz": [], "survivors": []}
    for _ in range(iters):
        (_, _), ptr, idx, _ = m
        out["products"].append(int((ptr[1:] - ptr[:-1])[idx].sum()))
        (_, _), sptr, scol, sval = csr_matmul(m, m, device=device)
        srow = torch.repeat_interleave(torch.arange(n, device=device), sptr[1:] - sptr[:-1])
        vp = torch.clamp(sval, min=0.0) ** inflation
        keep = vp > threshold
        out["nnz"].append(int(scol.shape[0]))
        out["survivors"].append(int(keep.sum()))
        r, c, w = srow[keep], scol[keep], vp[keep]
        colsum = torch.zeros(n, dtype=w.dtype, device=device).index_add_(0, c, w)
        w = w / torch.where(colsum == 0, torch.ones_like(colsum), colsum)[c]
        ptr2 = torch.zeros(n + 1, dtype=torch.int64, device=device)
        ptr2[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
        m = ((n, n), ptr2, c, w)
    return out


def mcl_work(counts: dict) -> dict:
    """The counts of :func:`recurrence` and the bytes of each 64-bit-key
    kernel over one run."""
    p, s = counts["products"], counts["survivors"]
    return {
        **counts,
        "K2_64_bytes": K2_BYTES_PER_PRODUCT * sum(p[1:]),
        "prune_compact_64_bytes": PRUNE_BYTES_PER_SLOT * p[0] + PRUNE_BYTES_PER_SURVIVOR * s[0],
    }


def kernel_ms(rec, names) -> float | None:
    """Device ms per traced call of the kernels whose names hold one of
    ``names``; None where none ran."""
    per_call = [sum(e - s for k, s, e in c.kernels if any(x in k for x in names))
                for c in rec.calls]
    return mean(per_call) / 1e3 if any(per_call) else None


def kernel_share(rec, kernel: str, names) -> float | None:
    """100 × ``work[kernel + "_bytes"]`` ÷ the peak bandwidth ÷ the device
    time per traced call of the kernels named ``names`` (%); None on a
    card the peak table does not hold, without the bytes, or where none
    of the kernels ran."""
    nbytes = rec.work.get(f"{kernel}_bytes")
    ms = kernel_ms(rec, names)
    if rec.peaks is None or not nbytes or not ms:
        return None
    return 100.0 * nbytes / rec.peaks["hbm_bytes_per_s"] / (ms / 1e3)
