"""Device-resident compaction of a merged stream, the first piece of the
JAX package's ``ops/chain.py`` (device chains and the fused MCL build
on it).

``compact_to_csr_device`` front-compacts a padded merged stream
(row-major sorted, masked by ``valid``) into CSR-ish arrays on the
device that holds it: a cumulative sum over ``valid`` gives each kept
slot its place, three scatters move the rows, columns and values there,
and a row count gives ``indptr``. The JAX package computes this with
``jnp.cumsum`` and XLA scatters, outside any Pallas kernel, so it is
plain PyTorch here.
"""

from __future__ import annotations

import torch


def front_compact(rows, cols, vals, valid, size: int, sentinel: int):
    """The valid slots of a stream moved to its front in order, to length
    ``size`` (valid slots past it dropped); the tail holds row
    ``sentinel``, column 0 and value 0."""
    dev = rows.device
    dest = torch.cumsum(valid, 0, dtype=torch.int64) - 1
    # invalid slots and those past the end go to a trash slot at size
    dest = torch.where(valid & (dest < size), dest, size)
    out_r = torch.full((size + 1,), sentinel, dtype=torch.int32, device=dev)
    out_c = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    out_v = torch.zeros(size + 1, dtype=torch.float32, device=dev)
    out_r.scatter_(0, dest, torch.where(valid, rows, sentinel).to(torch.int32))
    out_c.scatter_(0, dest, torch.where(valid, cols, 0).to(torch.int32))
    out_v.scatter_(0, dest, torch.where(valid, vals, 0.0).to(torch.float32))
    return out_r[:size], out_c[:size], out_v[:size]


def compact_to_csr_device(rows, cols, vals, valid, *, nnz_pad: int, m: int):
    """Front-compact a padded merged stream (row-major sorted) into
    ``(rows, cols, vals, indptr, nnz)`` on its device: the first ``nnz``
    slots hold the valid entries in stream order, the rest row ``m``
    (the sentinel), column 0 and value 0, to length ``nnz_pad``; valid
    entries past ``nnz_pad`` are dropped. ``indptr`` (int32, m + 1)
    counts the kept entries per row; ``nnz`` counts every valid slot."""
    out_r, out_c, out_v = front_compact(rows, cols, vals, valid, nnz_pad, m)
    indptr = torch.zeros(m + 1, dtype=torch.int32, device=rows.device)
    indptr[1:] = torch.cumsum(torch.bincount(out_r, minlength=m + 1)[:m], 0)
    return out_r, out_c, out_v, indptr, valid.sum(dtype=torch.int32)
