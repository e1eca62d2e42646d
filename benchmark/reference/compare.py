"""The comparisons that decide ``correct``: a program's CSR against the
reference's.

Every number returned is an error that must not exceed its limit (the
cell's ``workloads/<cell>.json``):

- ``struct_mismatch``: entries in one structure and not the other
  (exact: limit 0);
- ``val_rel_err``: the largest ``|got - want| / |want|`` over the
  entries both hold.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.mcl import clusters


def _tensor(x, device, dtype):
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x)).to(device=device, dtype=dtype)


def _keys(csr, device, cols_ok=None):
    """Row-major keys ``row·n + col`` (sorted), values, of a CSR; only the
    entries whose column is not excluded by ``cols_ok`` when given."""
    (m, n), indptr, indices, data = csr
    indptr, indices = _tensor(indptr, device, torch.int64), _tensor(indices, device, torch.int64)
    data = _tensor(data, device, torch.float64)
    rows = torch.repeat_interleave(torch.arange(m, device=device), indptr[1:] - indptr[:-1])
    key = rows * n + indices
    if cols_ok is not None:
        sel = cols_ok[indices]
        key, data = key[sel], data[sel]
    key, order = torch.sort(key)
    return key, data[order]


def compare_csr(got, want, device="cpu", cols_ok=None) -> dict:
    """``struct_mismatch`` and ``val_rel_err`` of ``got`` against
    ``want``, both ``(shape, indptr, indices, data)``; with ``cols_ok``
    (bool per column) over those columns alone."""
    if tuple(got[0]) != tuple(want[0]):
        return {"struct_mismatch": max(len(got[2]), len(want[2])) or 1, "val_rel_err": 1.0}
    kg, vg = _keys(got, device, cols_ok)
    kw, vw = _keys(want, device, cols_ok)
    if kg.shape == kw.shape and bool(torch.equal(kg, kw)):
        common_g, common_w, mismatch = vg, vw, 0
    else:
        pos = torch.searchsorted(kw, kg).clamp(max=max(kw.shape[0] - 1, 0))
        hit = (kw[pos] == kg) if kw.numel() else torch.zeros_like(kg, dtype=torch.bool)
        common_g, common_w = vg[hit], vw[pos[hit]]
        mismatch = int(kg.shape[0] + kw.shape[0] - 2 * int(hit.sum()))
    if common_w.numel() == 0:
        return {"struct_mismatch": mismatch, "val_rel_err": 1.0 if mismatch else 0.0}
    rel = (common_g - common_w).abs() / common_w.abs().clamp(min=1e-30)
    return {"struct_mismatch": mismatch, "val_rel_err": float(rel.max())}


def compare_flows(got, want, uncertain: torch.Tensor, device="cpu") -> dict:
    """An MCL flow against the reference's over the columns the
    reference does not mark uncertain: ``struct_mismatch``,
    ``val_rel_err``, and ``cluster_mismatch``, the clusters (attractor
    and members, each restricted to those columns) that only one side
    has. An attractor counts if its column is certain, and a member if
    its column is. ``uncertain_share`` is the share of columns left out."""
    uncertain = uncertain.to(device)
    cols_ok = ~uncertain
    out = compare_csr(got, want, device=device, cols_ok=cols_ok)
    ok = np.asarray(cols_ok.cpu())
    out["cluster_mismatch"] = len(clusters(got, ok) ^ clusters(want, ok))
    out["uncertain_share"] = float(uncertain.float().mean())
    return out
