"""Matrix Market (.mtx) reader and writer.

:func:`read_mtx` parses with the native C++ reader
(``runtime.native.read_mtx_native``) unless ``native=False`` asks for the
Python one; both behave as the JAX package's readers
(``formats/mtx.py``): ``%`` comment lines skipped, header
``NRow NCol NNZ``, 1-based → 0-based indices, a missing value field
(pattern matrices) reads as 1.0, and ``symmetric`` / ``skew-symmetric``
headers mirror off-diagonal entries. :func:`write_mtx` writes the JAX
package's bytes: a general real coordinate file in column-major order,
values as ``%.9g``.
"""

from __future__ import annotations

import gzip
import os
import shutil
import tempfile

import numpy as np

from outerspace_tpu_torch.formats.coo import COO, INDEX_DTYPE, VALUE_DTYPE


def read_mtx(path: str, expand_symmetric: bool = True, native: bool = True) -> COO:
    """Read a Matrix Market coordinate file (``.mtx``, or ``.mtx.gz``)
    into COO. The native reader's failures raise; with ``native=True`` a
    ``.gz`` file is decompressed to a temporary file (under ``$TMPDIR``,
    removed after) and read natively."""
    if not native:
        return _read_mtx_python(path, expand_symmetric)
    from outerspace_tpu_torch.runtime.native import read_mtx_native

    if not path.endswith(".gz"):
        return read_mtx_native(path, expand_symmetric)
    with tempfile.TemporaryDirectory() as d:
        tmp = os.path.join(d, "m.mtx")
        with gzip.open(path, "rb") as src, open(tmp, "wb") as dst:
            shutil.copyfileobj(src, dst)
        return read_mtx_native(tmp, expand_symmetric)


def _read_mtx_python(path: str, expand_symmetric: bool) -> COO:
    """The Python reader (``.gz`` decompressed on the fly)."""
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


def write_mtx(path: str, m, comment: str | None = None) -> None:
    """Write a COO / CSR / CSC matrix as a general real coordinate .mtx
    file, entries in column-major order (as scipy's ``mmwrite``)."""
    coo = m if isinstance(m, COO) else m.to_coo()
    coo = coo.sorted_colmajor()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {coo.nnz}\n")
        for r, c, v in zip(coo.row, coo.col, coo.val):
            f.write(f"{int(r) + 1} {int(c) + 1} {float(v):.9g}\n")
