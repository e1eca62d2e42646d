"""Matrix Market (.mtx) reader, Python path.

Same behaviour as the JAX package's Python reader (``formats/mtx.py``):
``%`` comment lines skipped, header ``NRow NCol NNZ``, 1-based → 0-based
indices, a missing value field (pattern matrices) reads as 1.0, and
``symmetric`` / ``skew-symmetric`` headers mirror off-diagonal entries.
``.mtx.gz`` files are decompressed on the fly.
"""

from __future__ import annotations

import gzip

import numpy as np

from outerspace_tpu_torch.formats.coo import COO, INDEX_DTYPE, VALUE_DTYPE


def read_mtx(path: str, expand_symmetric: bool = True) -> COO:
    """Read a Matrix Market coordinate file into COO."""
    opener = gzip.open if path.endswith(".gz") else open
    rows: list[int] = []
    cols: list[int] = []
    vals: list[float] = []
    symmetric = skew = pattern = False
    header_seen = False
    nrow = ncol = 0
    with opener(path, "rt") as f:
        first = f.readline()
        if first.startswith("%%MatrixMarket"):
            tokens = first.lower().split()
            skew = "skew-symmetric" in tokens
            symmetric = skew or "symmetric" in tokens
            pattern = "pattern" in tokens
        else:
            f.seek(0)
        for line in f:
            line = line.strip()
            if not line or line.startswith("%"):
                continue
            parts = line.split()
            if not header_seen:
                nrow, ncol = int(parts[0]), int(parts[1])
                header_seen = True
                continue
            r = int(parts[0]) - 1
            c = int(parts[1]) - 1
            v = float(parts[2]) if (len(parts) > 2 and not pattern) else 1.0
            rows.append(r)
            cols.append(c)
            vals.append(v)
            if symmetric and expand_symmetric and r != c:
                rows.append(c)
                cols.append(r)
                vals.append(-v if skew else v)
    if not header_seen:
        raise ValueError(f"{path}: no Matrix Market size header found")
    return COO(
        (nrow, ncol),
        np.asarray(rows, dtype=INDEX_DTYPE),
        np.asarray(cols, dtype=INDEX_DTYPE),
        np.asarray(vals, dtype=VALUE_DTYPE),
    )
