"""SpGEMM entry point and the merge stage: biased-key packing, sort,
merge epilogue (K2), and the merged result.

The port of the pieces of the JAX package's ``ops/spgemm.py`` that the
single-device main path runs. Keys pack (row, col) into one int32
``row·n + col − 2³¹`` with int32 wraparound, so signed int32 order equals
the unsigned order of ``row·n + col`` and one int32 sort covers every
m·n ≤ 2³². PyTorch has no wrapping int32 multiply-add that is safe to
rely on, so the arithmetic runs in int64 and narrows at the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from outerspace_tpu_torch.formats.coo import COO
from outerspace_tpu_torch.formats.csr import CSC, CSR
from outerspace_tpu_torch.ops.kernels.scan import merge_epilogue_scan

I32_MAX = 2**31 - 1
KEY_BIAS = -(2**31)


def pack_key_biased(rows: torch.Tensor, cols: torch.Tensor, n_cols) -> torch.Tensor:
    """Pack (row, col) into one biased-uint32 int32 sort key (m·n ≤ 2³²)."""
    u = torch.remainder(rows.long() * n_cols + cols.long(), 2**32)
    return (u + KEY_BIAS).to(torch.int32)


def unpack_key_biased(key: torch.Tensor, n_cols: int):
    """Inverse of :func:`pack_key_biased`: (row, col) as int32."""
    ku = key.long() - KEY_BIAS  # the unsigned value row·n + col
    return (ku // n_cols).to(torch.int32), (ku % n_cols).to(torch.int32)


def merge_epilogue(key, vals, n_cols: int, sentinel_row: int, pad_count: int = 0):
    """Everything after the sort (K2): segmented sums, unpack, validity
    and nnz over an ALREADY-SORTED biased-key stream."""
    return merge_epilogue_scan(
        key, vals, pad_count, n_cols=n_cols, sentinel_row=sentinel_row
    )


def merge_biased_keys(key, vals, n_cols: int, sentinel_row: int, pad_count: int = 0):
    """Merge a biased-key stream: ``torch.sort`` by key, the values
    gathered by the returned order, then :func:`merge_epilogue`.

    Padding slots carry the sentinel INT32_MAX with value 0; at
    m·n = 2³² the real corner shares that bit pattern and is recovered
    exactly through ``pad_count`` (see ``ops.kernels.scan``). The sort is
    not stable: that only permutes the summands of a run."""
    key, order = torch.sort(key)
    return merge_epilogue(key, vals[order], n_cols, sentinel_row, pad_count)


@dataclasses.dataclass
class MergedCOO:
    """Device-resident merged result: padded, row-major sorted, masked."""

    shape: tuple[int, int]
    rows: torch.Tensor  # int32[N], sentinel where ~valid
    cols: torch.Tensor
    vals: torch.Tensor
    valid: torch.Tensor  # bool[N]
    nnz: torch.Tensor  # int32 scalar

    def to_csr(self) -> CSR:
        """Fetch to host and build an exact-nnz CSR."""
        valid = self.valid.cpu().numpy()
        rows = self.rows.cpu().numpy()[valid]
        cols = self.cols.cpu().numpy()[valid]
        vals = self.vals.cpu().numpy()[valid]
        counts = np.bincount(rows, minlength=self.shape[0])
        indptr = np.zeros(self.shape[0] + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSR(self.shape, indptr, cols, vals)


def spgemm(
    a: COO | CSR | CSC,
    b: COO | CSR | CSC,
    strategy: str = "auto",
    device: str | torch.device = "cuda",
) -> CSR:
    """C = A @ B; returns a host CSR with exact nnz.

    Host plan → K1 expand → sort → K2 epilogue on ``device`` →
    compaction to CSR. ``strategy``: "gather" runs the row-split
    windowed-gather pipeline (``ops.gather_pipeline``); "auto" resolves
    to it. "tiles" and "flat" are not ported yet (ROADMAP queue A)."""
    if strategy in ("tiles", "flat"):
        raise NotImplementedError(
            f"strategy {strategy!r} is not ported yet: see ROADMAP.md, queue A "
            "(item 4 for 'flat', item 7 for 'tiles')"
        )
    if strategy not in ("auto", "gather"):
        raise ValueError(f"unknown strategy {strategy!r}")
    from outerspace_tpu_torch.ops.gather_pipeline import spgemm_gather

    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    return spgemm_gather(a, b, device=device)
