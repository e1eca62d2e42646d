"""Device chains and Markov clustering on the card: the port of the JAX
package's ``ops/chain.py``.

A chain of products (A², A⁴, the MCL flow) keeps its operand on the card
between products; the host reads a few scalars, never the matrix.

- ``compact_to_csr_device`` front-compacts a merged stream into CSR-ish
  arrays (the fetch to CSR runs it too);
- ``spgemm_from_device_csr`` / ``square_device``: a product of operands
  that live on the card as compacted streams (the CSC order by one
  ``torch.sort``, the expansion offsets by gathered degrees and a
  cumulative sum), then the flat expand, sort and K2;
- ``inflate_device`` / ``markov_cluster_device``: the stepwise MCL chain,
  two host reads per squaring;
- ``markov_cluster_device_fused`` and ``mcl_whole_traced``: the loop on
  fixed-size buffers (:func:`_mcl_iteration`), with no host read inside
  it. A device ``ok`` flag records whether every budget held; the caller
  reads it once and falls back to the exact stepwise chain when it did
  not.

The flow stays in CSC order inside the loop, as a stream of keys
``col·m + row`` with its values. While m² < 2³² the keys are biased
int32, ``col·m + row − 2³¹`` (INT32_MAX marks an empty slot), and no
real key equals the sentinel: the merges here pass the stream length as
K2's ``pad_count``, which keeps K2's corner rule off without reading P
on the host. From m² ≥ 2³² on (:func:`key_dtype`) every key of the
chain is a plain int64 ``col·m + row`` (INT64_MAX marks an empty slot):
the first squaring's compaction, each loop squaring's merged stream,
sort, column starts and compaction, the final sort and the exact
fallback. The first squaring itself merges part-local int32 keys, and
the column normalisation sorts by column alone, which fits int32 at any
m. The dtype follows from m, and every helper reads it from its keys.

The JAX package computes all of this with XLA sorts, scans, gathers and
scatters, outside any Pallas kernel, so it is plain PyTorch here; its
products run K1 / K3 (the first squaring) and K2 (every merge, and the
per-column sums of the column normalisation with ``n_cols=1``). On the
card the prune and compaction after the staged chain's first squaring is
one kernel of its own (``ops/kernels/compact.py``), since that step
streams the largest stream of the run, and so are each loop squaring's
gather expand (``ops/kernels/loop_expand.py``), which fills hundreds of
millions of product slots on a large flow, and its prune and in-order
compaction (``ops/kernels/compact.py:loop_compact``), which reads them
back. Where the JAX code works in
uint32, the port carries the values in int64, which is exact below 2³²;
the keys that come out are bit-equal to the JAX package's.

Spans (``perf.timer.span``, recorded only under the profiler): the
staged chain's stages ``mcl.square1``, ``mcl.iteration`` and
``mcl.finish``, and its phases ``expand``, ``sort`` (:func:`_sort_pair`),
``merge`` (K2) and ``compact`` (prune, compaction, inflation and
column normalisation).
"""

from __future__ import annotations

import numpy as np
import torch

from outerspace_tpu_torch.ops.gather_pipeline import GatherPipelinePlan, spgemm_gather_padded
from outerspace_tpu_torch.ops.kernels.compact import (
    _pack,
    _sentinel,
    _to_front,
    _ukey,
    _unpack,
    key_dtype,
    loop_compact,
    prune_compact,
)
from outerspace_tpu_torch.ops.kernels.loop_expand import loop_expand
from outerspace_tpu_torch.ops.spgemm import (
    I32_MAX,
    KEY_BIAS,
    MergedCOO,
    _segment_broadcast_bits,
    expand_partial_products,
    merge_biased_keys,
    merge_epilogue,
    spgemm_padded_tiled_parts,
)
from outerspace_tpu_torch.ops.symbolic import round_up_bucket
from outerspace_tpu_torch.perf.timer import span

# the fused chain's product budget: the first squaring's P times this
P_HEADROOM = 1.5


def _col_keys(kcsc: torch.Tensor, m: int) -> torch.Tensor:
    """The biased column keys ``col − 2³¹`` (int32) of a CSC stream's
    keys; an int64 stream's empty slots take column m."""
    if kcsc.dtype == torch.int64:
        col = torch.where(kcsc != _sentinel(kcsc.dtype), kcsc // m, m)
        return (col + KEY_BIAS).to(torch.int32)
    return (_ukey(kcsc) // m + KEY_BIAS).to(torch.int32)


def _f32(x: float) -> float:
    """``x`` rounded to float32, so comparisons with float32 tensors use
    the value the JAX package compares with."""
    return float(np.float32(x))


def _fit(key, val, size: int):
    """A (key, value) stream cut or padded (sentinel, 0) to ``size``."""
    extra = size - key.shape[0]
    if extra <= 0:
        return key[:size], val[:size]
    return (torch.cat([key, key.new_full((extra,), _sentinel(key.dtype))]),
            torch.cat([val, val.new_zeros(extra)]))


def _sort_pair(key, val):
    """(key, value) sorted by key; not stable. A ``sort`` span."""
    with span("sort"):
        key, order = torch.sort(key)
        return key, val[order]


def front_compact(rows, cols, vals, valid, size: int, sentinel: int):
    """The valid slots of a stream moved to its front in order, to length
    ``size`` (valid slots past it dropped); the tail holds row
    ``sentinel``, column 0 and value 0."""
    return _to_front(valid, size, (rows.to(torch.int32), sentinel),
                     (cols.to(torch.int32), 0), (vals.to(torch.float32), 0.0))


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


def _slice_compact(rows, cols, vals, valid, *, nnz_pad: int):
    """The valid slots front-compacted to ``nnz_pad``; the tail holds row
    INT32_MAX (the JAX package's ``_slice_compact_jit``)."""
    return front_compact(rows, cols, vals, valid, nnz_pad, I32_MAX)


def _check_square(shape) -> tuple[int, int]:
    m, n = shape
    # rows and columns are int32; keys take int64 from m·n = 2³² on
    if m != n or not 0 < m < 2**31:
        raise ValueError(f"the device chain needs a square flow with 0 < m < 2^31, got {shape}")
    return m, n


# --------------------------------------------------------------------------
# The stepwise chain
# --------------------------------------------------------------------------


def spgemm_from_device_csr(a_rows, a_cols, a_vals, b_cols, b_vals, b_indptr, *,
                           p_pad: int, m: int, n: int):
    """C = A @ B with both operands on the card as compacted CSR streams
    (A's inner index is its column; B's rows are indexed by ``b_indptr``;
    tail slots of A hold row ``m``). A goes to CSC order by one sort of
    its packed (col, row) keys, the expansion offsets come from B's row
    degrees gathered per element, then the flat expand over ``p_pad``
    slots (which must hold P), sort and K2. Returns (rows, cols, vals,
    valid, nnz) of length ``p_pad``; keys in :func:`key_dtype` of
    (m, n)."""
    dtype = key_dtype(m, n)
    sent = _sentinel(dtype)
    valid_a = a_rows < m
    csc_key = torch.where(valid_a, _pack(a_cols, a_rows, m, dtype), sent)
    with span("sort"):
        _, order = torch.sort(csc_key)
        rows_s, cols_s, vals_s = a_rows[order], a_cols[order], a_vals[order]
    with span("expand"):
        valid_s = rows_s < m
        a_k = torch.where(valid_s, cols_s, 0)
        deg = torch.where(valid_s, b_indptr[a_k.long() + 1] - b_indptr[a_k.long()], 0)
        offsets = torch.cat([deg.new_zeros(1, dtype=torch.int64), torch.cumsum(deg, 0)])
        p_total = offsets[-1]
        r, c, v = expand_partial_products(
            torch.where(valid_s, rows_s, m), torch.where(valid_s, vals_s, 0.0), a_k,
            b_indptr, b_cols, b_vals, offsets, p_total, p_pad, m,
        )
        key = torch.where(torch.arange(p_pad, device=r.device) < p_total,
                          _pack(r, c, n, dtype), sent)
    # every slot counts as padding for K2: no real key is the sentinel,
    # and P stays on the card
    return merge_biased_keys(key, v, n, m, p_pad)


def _chain_stats(rows, cols, indptr, *, m: int) -> torch.Tensor:
    """P of M @ M for a compacted CSR stream, exact (int64 scalar).

    P gathers row degrees by each element's COLUMN, the inner index that
    feeds the expansion: P = Σ_e rownnz(col(e))."""
    deg = (indptr[1:] - indptr[:-1]).long()
    return torch.where(rows < m, deg[cols.long().clamp(max=m - 1)], 0).sum()


def square_device(merged: MergedCOO) -> MergedCOO:
    """M @ M with M on the card; the host reads two scalars (nnz, then P)
    to size the buffers."""
    m, n = _check_square(merged.shape)
    nnz = int(merged.nnz)
    nnz_pad = round_up_bucket(max(nnz, 1), min_size=1024)
    rows, cols, vals, indptr, _ = compact_to_csr_device(
        merged.rows, merged.cols, merged.vals, merged.valid, nnz_pad=nnz_pad, m=m)
    p = int(_chain_stats(rows, cols, indptr, m=m))
    if p >= 2**31:
        raise ValueError(f"chained expansion {p} exceeds the int32 index space")
    p_pad = round_up_bucket(max(p, 1), min_size=4096)
    r, c, v, valid, out_nnz = spgemm_from_device_csr(
        rows, cols, vals, cols, vals, indptr, p_pad=p_pad, m=m, n=n)
    return MergedCOO((m, n), r, c, v, valid, out_nnz)


def inflate_device(rows, cols, vals, valid, *, m: int, inflation: float, threshold: float):
    """MCL inflation on the card: elementwise power, prune, column
    normalise (an ``index_add_`` of the column sums). Returns (values,
    valid, nnz)."""
    vp = torch.pow(torch.clamp(torch.where(valid, vals, 0.0), min=0.0), inflation)
    valid2 = valid & (vp > _f32(threshold))
    col = torch.where(valid2, cols, 0).long()
    colsum = torch.zeros(m, dtype=torch.float32, device=vals.device)
    colsum.index_add_(0, col, torch.where(valid2, vp, 0.0))
    colsum = torch.where(colsum == 0, 1.0, colsum)
    vn = torch.where(valid2, vp / colsum[col], 0.0)
    return vn, valid2, valid2.sum(dtype=torch.int32)


def markov_cluster_device(merged0: MergedCOO, inflation: float = 2.0, iters: int = 10,
                          prune_threshold: float = 1e-4) -> MergedCOO:
    """The MCL loop with the flow on the card throughout; per iteration
    the host reads two scalars (:func:`square_device`)."""
    flow = merged0
    for _ in range(iters):
        sq = square_device(flow)
        v2, valid2, nnz2 = inflate_device(sq.rows, sq.cols, sq.vals, sq.valid, m=flow.shape[0],
                                          inflation=inflation, threshold=prune_threshold)
        flow = MergedCOO(sq.shape, sq.rows, sq.cols, v2, valid2, nnz2)
    return flow


# --------------------------------------------------------------------------
# Ranks, column starts, compaction, column normalisation
# --------------------------------------------------------------------------


def ranks_in_sorted(sorted_keys: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """``searchsorted(sorted_keys, probes, side="left")`` (int32): the
    JAX package's two-sort rank pass, a binary search on the card."""
    return torch.searchsorted(sorted_keys.contiguous(), probes.contiguous(), out_int32=True)


def _column_starts(kstream: torch.Tensor, m: int) -> torch.Tensor:
    """Column start positions (int32[m+1]) of a stream sorted by the
    packed CSC key ``col·m + row``: the ranks of the probes ``c·m``."""
    c = torch.arange(m + 1, device=kstream.device)
    return ranks_in_sorted(kstream, _pack(c, torch.zeros_like(c), m, kstream.dtype))


def _csc_colnorm_sorted(kcol, vp, m: int, starts_ext):
    """Per-column totals of a stream whose column keys ``kcol`` (biased
    ``col − 2³¹``) are sorted ascending, broadcast back to every slot.

    The totals are K2's segmented sums (the merge epilogue with
    ``n_cols=1``), read at each column's last slot, found from the column
    starts ``starts_ext`` (int32[m+1]). An empty column's total is 1. Tail
    slots past the last column take its total."""
    L = kcol.shape[0]
    col_of, _, col_tot, tot_valid, _ = merge_epilogue(kcol, vp, 1, m, L)
    pos = (starts_ext[1:].long() - 1).clamp(0, L - 1)
    hit = tot_valid[pos] & (col_of[pos] == torch.arange(m, device=kcol.device))
    colsum = torch.where(hit, col_tot[pos], 1.0)
    colsum = torch.where(colsum == 0, 1.0, colsum)
    return _segment_broadcast_bits(colsum.view(torch.int32), starts_ext[:m], L).view(torch.float32)


# --------------------------------------------------------------------------
# The loop on fixed buffers
# --------------------------------------------------------------------------


def _mcl_iteration(state, *, p_pad: int, elem_pad: int, m: int, inflation: float,
                   threshold: float):
    """One MCL iteration (square + inflate) on fixed buffers, with no
    host read.

    ``state`` = (kcsc, vals, starts_ext, ok): the flow as a compacted
    CSC stream of ``elem_pad`` slots (sorted ``col·m + row`` keys of
    :func:`key_dtype`, sentinel tail), its column starts (int32[m+1])
    and the 0-d bool ``ok``. The expansion is role-flipped: each element
    f = (k, c) pairs with CSC column k of the same stream. The merge
    sorts by C's CSC key, so its output is already in the loop's order;
    the survivors of the prune (on the raw merged values: v^p > t ⟺
    v > t^(1/p)) are front-compacted, in order, to ``elem_pad`` slots
    (:func:`loop_compact`, one kernel on the card), then powered and
    column-normalised (K2 with ``n_cols=1``). The products take
    ``p_pad`` slots; :func:`loop_expand` reads each product's (row,
    value) by index (one kernel on the card).

    ``ok`` gathers every budget: P (exact in int64) within ``p_pad``
    and the survivors within ``elem_pad``."""
    kcsc, vals, starts_ext, ok = state
    dev = kcsc.device
    sent = _sentinel(kcsc.dtype)
    with span("expand"):
        _, row_f = _unpack(kcsc, m)
        valid_f = kcsc != sent
        indptr = starts_ext
        col_deg = indptr[1:] - indptr[:-1]
        # element f = (k=row_f, c) pairs with CSC column row_f
        a_k = torch.where(valid_f, row_f, 0)
        deg = torch.where(valid_f, col_deg[a_k.long().clamp(max=m - 1)], 0)
        offsets = torch.cat([deg.new_zeros(1, dtype=torch.int64), torch.cumsum(deg, 0)])
        p_total = offsets[-1]
        ok = ok & (p_total <= p_pad)
        p_clamped = p_total.clamp(0, p_pad)
        key, v = loop_expand(kcsc, vals, indptr, offsets, p_clamped, p_pad=p_pad, m=m)
    key_s, v_s = _sort_pair(key, v)
    # the stream length as pad_count: no real key is the sentinel
    _, _, v2, valid2, _ = merge_epilogue(key_s, v_s, m, m, key_s.shape[0])
    with span("compact", device=dev):
        thr_root = _f32(float(threshold) ** (1.0 / float(inflation)))
        # the merged stream is sorted, so compaction in order keeps it sorted
        k_next, vp_next, fits = loop_compact(key_s, v2, valid2, thr_root=thr_root,
                                             elem_pad=elem_pad)
        ok = ok & fits
        vp_next = torch.pow(vp_next, inflation)
        starts_next = _column_starts(k_next, m)
        colsum = _csc_colnorm_sorted(_col_keys(k_next, m), vp_next, m, starts_next)
        v_next = torch.where(k_next != sent, vp_next / colsum, 0.0)
    return k_next, v_next, starts_next, ok


def _to_csc_state(rows, cols, vals, valid, *, p_pad: int, m: int):
    """A masked COO stream as the loop's state: sorted ``col·m + row``
    keys (:func:`key_dtype`) with a sentinel tail, and values, cut or
    padded to ``p_pad`` after the sort (the caller guarantees
    nnz ≤ p_pad)."""
    dtype = key_dtype(m)
    key = torch.where(valid, _pack(cols, rows, m, dtype), _sentinel(dtype))
    return _fit(*_sort_pair(key, torch.where(valid, vals, 0.0)), p_pad)


def _from_csc_state(kcsc, vals, *, m: int, n: int, nnz_pad: int):
    """The loop's CSC state back to row-major compacted (rows, cols,
    vals) of length ``nnz_pad``; tail rows ``m``."""
    sent = _sentinel(kcsc.dtype)
    valid = kcsc != sent
    cols_o, rows_o = _unpack(kcsc, m)
    krow = torch.where(valid, _pack(rows_o, cols_o, n, kcsc.dtype), sent)
    k_r, v_r = _fit(*_sort_pair(krow, vals), nnz_pad)
    r2, c2 = _unpack(k_r, n)
    valid_o = k_r != sent
    return torch.where(valid_o, r2, m), torch.where(valid_o, c2, 0), torch.where(valid_o, v_r, 0.0)


def _flow_stats(rows, cols, valid, *, m: int) -> torch.Tensor:
    """[nnz, P of M @ M] of a masked COO flow, exact (int64[2])."""
    deg = torch.zeros(m + 1, dtype=torch.int64, device=rows.device)
    deg.index_add_(0, torch.where(valid, rows, m).long(), torch.ones_like(rows, dtype=torch.int64))
    p = torch.where(valid, deg[cols.long().clamp(max=m - 1)], 0).sum()
    return torch.stack([valid.sum(dtype=torch.int64), p])


def _mcl_fused(kcsc, vals, *, p_pad: int, elem_pad: int, m: int, iters: int,
               inflation: float, threshold: float):
    """``iters`` loop iterations from the CSC state (the JAX package's
    ``fori_loop``, here a host loop that queues launches and reads
    nothing). Returns the final (kcsc, vals, starts_ext, ok)."""
    state = (kcsc, vals, _column_starts(kcsc, m), torch.ones((), dtype=torch.bool, device=kcsc.device))
    for _ in range(iters):
        state = _mcl_iteration(state, p_pad=p_pad, elem_pad=elem_pad, m=m,
                               inflation=inflation, threshold=threshold)
    return state


def markov_cluster_device_fused(merged0: MergedCOO, inflation: float = 2.0, iters: int = 10,
                                prune_threshold: float = 1e-4) -> MergedCOO:
    """MCL with three host reads for the whole run (nnz and P before, ok
    and nnz after). The product budget is the first squaring's P times
    ``P_HEADROOM``; the element budget 4× the entry nnz. If ``ok`` says a
    budget did not hold, the exact stepwise chain runs instead."""
    m, n = _check_square(merged0.shape)
    if iters <= 0:
        return merged0
    nnz0, p1 = _flow_stats(merged0.rows, merged0.cols, merged0.valid, m=m).tolist()
    p_budget = int(p1 * P_HEADROOM) + 4096
    if p_budget >= 2**31:
        return markov_cluster_device(merged0, inflation=inflation, iters=iters,
                                     prune_threshold=prune_threshold)
    # a stream padded past the loop's budget (a tiled squaring's) is
    # compacted first
    n_in = int(merged0.rows.shape[0])
    nnz_pad0 = round_up_bucket(max(nnz0, 1), min_size=1024)
    if n_in > max(p_budget, nnz_pad0):
        n_in = min(nnz_pad0, n_in)
        r0, c0, v0 = _slice_compact(merged0.rows, merged0.cols, merged0.vals, merged0.valid,
                                    nnz_pad=n_in)
        valid0 = torch.arange(n_in, device=r0.device) < nnz0
        merged0 = MergedCOO((m, n), r0, c0, v0, valid0, valid0.sum(dtype=torch.int32))
    p_pad = round_up_bucket(max(p_budget, n_in, 4096), min_size=4096)
    # flows grow before they converge; ok guards the 4x margin
    elem_pad = min(round_up_bucket(max(4 * nnz0, 4096), min_size=4096), p_pad)
    kcsc0, vals0 = _to_csc_state(merged0.rows, merged0.cols, merged0.vals, merged0.valid,
                                 p_pad=elem_pad, m=m)
    k_out, v_out, _, ok = _mcl_fused(kcsc0, vals0, p_pad=p_pad, elem_pad=elem_pad, m=m,
                                     iters=iters, inflation=float(inflation),
                                     threshold=float(prune_threshold))
    if not bool(ok):  # a budget did not hold: the exact stepwise chain
        return markov_cluster_device(merged0, inflation=inflation, iters=iters,
                                     prune_threshold=prune_threshold)
    nnz = int((k_out != _sentinel(k_out.dtype)).sum())
    nnz_pad = min(round_up_bucket(max(nnz, 1), min_size=1024), p_pad)
    r2, c2, v2 = _from_csc_state(k_out, v_out, m=m, n=n, nnz_pad=nnz_pad)
    valid2 = torch.arange(nnz_pad, device=r2.device) < nnz
    return MergedCOO((m, n), r2, c2, v2, valid2, valid2.sum(dtype=torch.int32))


# --------------------------------------------------------------------------
# The staged program: first squaring on the host plan, then the loop
# --------------------------------------------------------------------------


def _stage1_squaring(tplan):
    """The chain's first squaring over the host plan ``mcl_prepare``
    picked: the windowed-gather pipeline (K1, sort, K2 per part) or the
    tiled row parts (K3 / K1, sort, K2)."""
    if isinstance(tplan, GatherPipelinePlan):
        return spgemm_gather_padded(tplan)
    return spgemm_padded_tiled_parts(tplan)


def mcl_whole_traced(tplan, *, p_pad: int, nnz_pad: int, m: int, n_cols: int, iters: int,
                     inflation: float, threshold: float, elem_pad: int | None = None,
                     p_pads: tuple[int, ...] | None = None):
    """The whole staged MCL with no host read: the first squaring over
    ``tplan``, prune, compaction into ``elem_pad`` loop slots in CSC
    order, inflation and column normalisation, ``iters`` loop iterations
    (:func:`_mcl_iteration`), and one row-major sort. Returns (rows
    [nnz_pad], cols, vals, nnz, ok): ``ok`` guards every budget, so the
    caller falls back to the exact stepwise chain when it is false.
    Spans: ``mcl.square1``, then ``compact``, ``mcl.loop`` (which names
    the card for itself alone, so one pair of CUDA events times it and
    the spans under it keep host time) over one ``mcl.iteration`` per loop
    iteration (attribute ``iteration``: 2 for the first), and
    ``mcl.finish``. Keys take :func:`key_dtype` of m from the first
    compaction on.

    ``p_pads``: one product budget per loop iteration (P collapses as the
    flow converges; each is capped by ``p_pad`` and at least
    ``elem_pad``)."""
    if inflation <= 0.0:
        raise ValueError(f"inflation must be positive, got {inflation}")
    if p_pads is None:
        p_pads = (p_pad,) * iters
    if len(p_pads) != iters:
        raise ValueError(f"p_pads has {len(p_pads)} entries for {iters} iterations")
    if elem_pad is None:
        elem_pad = round_up_bucket(4 * nnz_pad, min_size=4096)
    elem_pad = min(max(elem_pad, nnz_pad), p_pad)
    with span("mcl.square1"):
        sq = _stage1_squaring(tplan)
    with span("compact", device=sq.rows.device):
        # prune on the raw merged values (v^p > t ⟺ v > t^(1/p) for v ≥ 0,
        # p > 0), so the power runs after the compaction on survivors only
        thr_root = _f32(float(threshold) ** (1.0 / float(inflation)))
        kp, vp, ok = prune_compact(sq.rows, sq.cols, sq.vals, sq.valid, thr_root=thr_root, m=m,
                                   elem_pad=elem_pad)
        kp, vp = _sort_pair(kp, vp)
        valid1 = kp != _sentinel(kp.dtype)
        vp = torch.where(valid1, torch.pow(torch.clamp(vp, min=0.0), inflation), 0.0)
        starts1 = _column_starts(kp, m)
        colsum = _csc_colnorm_sorted(_col_keys(kp, m), vp, m, starts1)
        state = (kp, torch.where(valid1, vp / colsum, 0.0), starts1, ok)
    with span("mcl.loop", device=kp.device, inherit=False):
        for i, pp in enumerate(p_pads):
            with span("mcl.iteration", iteration=i + 2):
                state = _mcl_iteration(state, p_pad=max(min(pp, p_pad), elem_pad),
                                       elem_pad=elem_pad, m=m, inflation=inflation,
                                       threshold=threshold)
    with span("mcl.finish"):
        k_out, v_out, _, ok = state
        valid = k_out != _sentinel(k_out.dtype)
        nnz = valid.sum(dtype=torch.int32)
        ok = ok & (nnz <= nnz_pad)
        r2, c2, v2 = _from_csc_state(k_out, v_out, m=m, n=n_cols, nnz_pad=nnz_pad)
    return r2, c2, v2, nnz, ok
