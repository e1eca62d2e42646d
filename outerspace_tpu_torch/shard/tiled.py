"""Sharded SpGEMM whose per-rank compute is the tiled pipeline's kernels:
K3 over the dense-tile classes, K1 over the windowed-gather residue, one
``torch.sort``, then K2 in the merge after the exchange.

The port of the JAX package's ``shard/tiled.py``. The host plan is the
same numpy, array for array (:func:`shard_plan_tiled`):

- the outer-product index space k is split along mesh axis "x"
  (contiguous, FLOP-balanced) and B's columns optionally along "y", so
  rank (i, j) holds A's k-slice i and B's (k-slice i × column range j)
  shard: B is never replicated;
- each rank expands its shard into packed biased int32 keys and values
  (K3 once over its class tables, K1 on the residue), written in place
  into one stream, and sorts it once by key, so each (owner, chunk)
  bucket is one contiguous run;
- the runs go to their row owners along "x", ``chunks`` all_to_alls of
  padded (ndst, capacity) buckets (keys and values in one buffer);
- each owner merges what it received in ``merge_parts`` key-range parts,
  each by ``torch.sort`` and K2 (with one sender, kx = 1, the received
  buffer is already sorted and K2 runs alone).

Past m·n = 2³² the plan rebases keys per (owner, chunk) bucket
(:func:`_shard_plan_tiled_rebased`): every bucket is planned on its rows
alone, so its keys fit span·n < 2³²; each bucket is expanded and sorted
on its own, its first ``capacity`` slots are its exchange slot, and the
merge adds the bucket's first row back.

The JAX program is one ``shard_map`` over all devices, so its plan pads
every device's task tables to common shapes (``class_T``, ``ngroups``).
The plan keeps those fields for parity; a rank here launches K3 over its
own tasks only (the common padding tasks emit nothing but sentinels).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from outerspace_tpu_torch.formats.csr import CSC, CSR
from outerspace_tpu_torch.ops.kernels.expand import (
    TileGroup,
    b_blocks_host,
    expand_part_packed,
    group_descriptor,
    schedule_to_host,
)
from outerspace_tpu_torch.ops.kernels.gexpand import expand_gather, gather_plan_to_host
from outerspace_tpu_torch.ops.spgemm import (
    I32_MAX,
    MergedCOO,
    merge_biased_keys,
    merge_epilogue,
)
from outerspace_tpu_torch.ops.symbolic import round_up_bucket
from outerspace_tpu_torch.sched.gplanner import B_WIN, GROUP_SUBS, SUB_P
from outerspace_tpu_torch.sched.planner import (
    TILE_A_CLASSES,
    TILE_B,
    plan_outer_classes,
)
from outerspace_tpu_torch.shard.mesh import balanced_contiguous_partition
from outerspace_tpu_torch.shard.spgemm_sharded import (
    _slice_fill_buckets,
    exchange,
    gather_to_csr,
)

_A_GROUP = 8
FULL_SEARCH_BITS = 8  # K1's owner search over the whole 256-element A window


def slice_a_columns(a_csc: CSC, k_lo: int, k_hi: int) -> CSC:
    """A's column (outer-index) slice [k_lo, k_hi) as a CSC of shape
    (m, k_hi - k_lo)."""
    ptr = np.asarray(a_csc.indptr)
    e0, e1 = int(ptr[k_lo]), int(ptr[k_hi])
    return CSC(
        (a_csc.shape[0], k_hi - k_lo),
        ptr[k_lo : k_hi + 1] - ptr[k_lo],
        np.asarray(a_csc.indices)[e0:e1],
        np.asarray(a_csc.data)[e0:e1],
    )


def slice_b_rows_cols(
    b_csr: CSR, k_lo: int, k_hi: int, c_lo: int, c_hi: int
) -> CSR:
    """B's (row-range × column-range) shard as a CSR of shape
    (k_hi - k_lo, n); column ids stay global (output keys are global)."""
    ptr = np.asarray(b_csr.indptr)
    e0, e1 = int(ptr[k_lo]), int(ptr[k_hi])
    cols = np.asarray(b_csr.indices)[e0:e1]
    vals = np.asarray(b_csr.data)[e0:e1]
    kloc = k_hi - k_lo
    row_ids = np.repeat(
        np.arange(kloc), np.diff(ptr[k_lo : k_hi + 1]).astype(np.int64)
    )
    if c_lo > 0 or c_hi < b_csr.shape[1]:
        sel = (cols >= c_lo) & (cols < c_hi)
        cols, vals, row_ids = cols[sel], vals[sel], row_ids[sel]
    indptr = np.zeros(kloc + 1, dtype=np.int64)
    np.cumsum(np.bincount(row_ids, minlength=kloc), out=indptr[1:])
    return CSR((kloc, b_csr.shape[1]), indptr, cols, vals)


def _pack_u32_biased(u: np.ndarray) -> np.ndarray:
    """uint32 value → biased int32 key bit pattern (host side)."""
    u32 = (np.asarray(u, dtype=np.uint64) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32
    )
    return (u32 ^ np.uint32(0x80000000)).view(np.int32)


@dataclasses.dataclass
class ShardedTiledPlan:
    """Host-side static plan: per-device task tables stacked to common
    shapes over the (kx × ny) device grid."""

    m: int
    n: int
    kx: int
    ny: int
    rows_per_x: int  # output-row ownership granularity along "x"
    capacity: int  # per-(src, dst, chunk) exchange bucket (bucket grid)
    chunks: int  # exchange chunks per owner (see shard_plan_tiled)
    merge_parts: int  # key-range parts per chunk merge (see shard_plan_tiled)
    mcap: int  # per-(src, dst, chunk, part) merge-part bucket (bucket grid)
    max_run: int  # global duplicate bound (pow2)
    # Active tile classes (subset of TILE_A_CLASSES with any task):
    tile_as: tuple[int, ...]
    class_T: tuple[int, ...]  # common padded task count per class
    nblocks: int  # common padded B block count
    # Gather residue (0 groups = none anywhere on the grid):
    ngroups: int
    b_win: int
    # Stacked arrays, leading dims [kx, ny, ...]:
    class_tasks: list  # int32[kx, ny, T*4] per class
    class_arow: list  # int32[kx, ny, T, tile_a]
    class_aval: list  # f32[kx, ny, T, tile_a]
    b_cols_blk: np.ndarray | None  # int32[kx, ny, NB, 128]
    b_vals_blk: np.ndarray | None  # f32[kx, ny, NB, 128]
    g_bases: np.ndarray | None  # int32[kx, ny, G*2]
    g_table: np.ndarray | None  # int32[kx, ny, G, GROUP_SUBS, 128]
    g_apack: np.ndarray | None  # int32[kx, ny, NAB8, 8, 4, 128]
    g_bpack: np.ndarray | None  # int32[kx, ny, NBB8, 8, 2, 128]
    recv_pad: np.ndarray  # int32[kx, ny, chunks, parts] sentinels after exchange
    boundaries: np.ndarray  # int32[kx*chunks+1] biased (owner, chunk) starts
    mbounds: np.ndarray  # int32[kx, ny, chunks*parts+1] biased part starts
    # ---- rebased mode (m·n ≥ 2³²: per-(owner, chunk)-bucket keys) ----
    rebase: bool = False
    # Per destination bucket b = owner·chunks + chunk (len kx·chunks),
    # each a dict: tile_as/class_T tuples, class_tasks/arow/aval stacked
    # [kx, ny, ...] lists, ngroups/b_win ints, g_* stacked arrays.
    buckets: list | None = None
    row_base: np.ndarray | None = None  # int32[kx, ny, chunks] global row starts
    sentinel_span: int = 0  # common invalid-row label for rebased merges

    @property
    def stream_len(self) -> int:
        """Per-device expand stream length (pre-exchange), as the JAX
        program pads it."""
        if self.rebase:
            return sum(_bucket_stream_len(bk) for bk in self.buckets)
        return sum(
            t * ta * TILE_B for t, ta in zip(self.class_T, self.tile_as)
        ) + self.ngroups * GROUP_SUBS * SUB_P

    @property
    def merge_len(self) -> int:
        return self.kx * self.mcap * self.merge_parts * self.chunks


def _bucket_stream_len(bk: dict) -> int:
    """One rebased bucket's expand stream length."""
    return sum(
        t * ta * TILE_B for t, ta in zip(bk["class_T"], bk["tile_as"])
    ) + bk["ngroups"] * GROUP_SUBS * SUB_P


def _owner_chunk_starts(
    prod_row: np.ndarray, lo: int, hi: int, chunks: int, span_cap: int
) -> np.ndarray:
    """Product-balanced sub-range starts of [lo, hi) with every span ≤
    ``span_cap`` (the rebased key-space bound): a greedy walk toward the
    remaining-product-even target, clipped to the cap from above and to
    the leave-enough-room bound from below. Requires
    ``chunks·span_cap ≥ hi−lo`` (the planner raises ``chunks`` to it)."""
    cum = np.zeros(hi - lo + 1, dtype=np.float64)
    np.cumsum(prod_row[lo:hi], out=cum[1:])
    total = cum[-1]
    starts = np.empty(chunks + 1, dtype=np.int64)
    starts[0] = lo
    cur = lo
    for c in range(1, chunks):
        remaining = chunks - c + 1  # sub-ranges left, incl. the current
        target = cum[cur - lo] + (total - cum[cur - lo]) / remaining
        nxt = lo + int(np.searchsorted(cum, target, side="left"))
        low_req = max(cur, hi - (chunks - c) * span_cap)
        high_cap = min(hi, cur + span_cap)
        nxt = min(max(nxt, low_req), high_cap)
        starts[c] = nxt
        cur = nxt
    starts[chunks] = hi
    return starts


def _col_bounds(b_csr: CSR, n: int, ny: int) -> np.ndarray:
    if ny > 1:
        col_hist = np.bincount(
            np.asarray(b_csr.indices, dtype=np.int64), minlength=n
        ).astype(np.float64)
        return balanced_contiguous_partition(col_hist, ny)
    return np.array([0, n], dtype=np.int64)


def _prod_row(a_csc: CSC, b_csr: CSR, m: int) -> np.ndarray:
    """Products per output row (products of element (r, k) land in row r)."""
    nb_full = b_csr.major_nnz().astype(np.int64)
    a_k_full = np.repeat(
        np.arange(a_csc.shape[1]),
        np.diff(np.asarray(a_csc.indptr)).astype(np.int64),
    )
    return np.bincount(
        np.asarray(a_csc.indices, dtype=np.int64),
        weights=nb_full[a_k_full].astype(np.float64),
        minlength=m,
    )


def _residue_plan(a_sl, b_sl, cp, nb_sl, m: int, n: int):
    """The windowed-gather plan of a class plan's residue (light k's and
    the trimmed edge blocks), or None."""
    from outerspace_tpu_torch.sched.gplanner import plan_gather_ranges

    if cp.light_k.shape[0] == 0 and cp.edge_k.shape[0] == 0:
        return None
    b_ptr = np.asarray(b_sl.indptr).astype(np.int64)
    lk = cp.light_k.astype(np.int64)
    lk = lk[nb_sl[lk] > 0]
    gplan = plan_gather_ranges(
        a_sl,
        np.concatenate([lk, cp.edge_k]),
        np.concatenate([b_ptr[lk], cp.edge_jb]),
        np.concatenate([nb_sl[lk], cp.edge_len]),
        np.asarray(b_sl.indices),
        np.asarray(b_sl.data),
        m,
        n,
    )
    if gplan is not None and gplan.b_win != B_WIN:
        raise AssertionError("tiled-residue gather plans always use B_WIN")
    return gplan


def _merge_part_count(kx: int, capacity: int, merge_parts: int | None) -> int:
    """``merge_parts``, or the auto pick: 1 with one sender (the received
    buffer is sorted; parts would only add fills), else one part per
    ~2M merged pairs, at most 8."""
    if merge_parts is not None:
        return max(1, int(merge_parts))
    if kx == 1:
        return 1
    from outerspace_tpu_torch.sched.gplanner import perf_part_count

    return perf_part_count(float(kx) * capacity, max_part_products=2 << 20, part_cap=8)


def _fine_rows(prod_row, row_starts_all, dst_inputs, kx, ny, chunks, mparts, m, per_dst,
               capacity):
    """(row_fine, mcap, recv_pad): the (owner, chunk, part) row starts,
    the merge-part bucket and the sentinels each part receives."""
    nbuckets = kx * chunks
    if mparts > 1:
        row_fine = np.empty(nbuckets * mparts + 1, dtype=np.int64)
        for b in range(nbuckets):
            lo = int(row_starts_all[b])
            hi = int(row_starts_all[b + 1])
            sub = balanced_contiguous_partition(prod_row[lo:hi], mparts) + lo
            row_fine[b * mparts : (b + 1) * mparts] = sub[:-1]
        row_fine[-1] = m
        mcap_real = 1
        incoming_f = np.zeros((kx, ny, chunks, mparts), np.int64)
        for (i, j), (rows_e, counts_e) in dst_inputs.items():
            if rows_e.size == 0:
                continue
            of = np.searchsorted(row_fine, rows_e, side="right") - 1
            pdf = np.bincount(
                of, weights=counts_e, minlength=nbuckets * mparts
            ).astype(np.int64)
            mcap_real = max(mcap_real, int(pdf.max()))
            incoming_f[:, j] += pdf.reshape(kx, chunks, mparts)
        mcap = round_up_bucket(mcap_real, min_size=1024)
    else:
        row_fine = row_starts_all
        mcap = capacity
        incoming_f = np.zeros((kx, ny, chunks, 1), np.int64)
        for (i, j), pd in per_dst.items():
            incoming_f[:, j, :, 0] += pd.reshape(kx, chunks)
    return row_fine, mcap, (kx * mcap - incoming_f).astype(np.int32)


def _max_run(a_csc: CSC, m: int) -> int:
    max_run = int(np.bincount(np.asarray(a_csc.indices), minlength=m).max(initial=1))
    return 1 << (max(max_run, 1) - 1).bit_length()


def _stack_classes(cps_at, kx, ny, t_max_of):
    """(tile_as, class_T, tasks, arow, aval) of the classes with a task
    anywhere on the grid, each table padded to the common count and
    stacked [kx, ny, ...]; ``cps_at(i, j)`` is device (i, j)'s class plan."""
    n_classes = len(TILE_A_CLASSES)
    t_max = [t_max_of(ci) for ci in range(n_classes)]
    active = [ci for ci in range(n_classes) if t_max[ci] > 0]
    class_T = tuple(
        -(-round_up_bucket(t_max[ci], min_size=_A_GROUP) // _A_GROUP) * _A_GROUP
        for ci in active
    )
    tile_as = tuple(TILE_A_CLASSES[ci] for ci in active)
    class_tasks = [np.zeros((kx, ny, t * 4), np.int32) for t in class_T]
    class_arow = [np.zeros((kx, ny, t, ta), np.int32) for t, ta in zip(class_T, tile_as)]
    class_aval = [np.zeros((kx, ny, t, ta), np.float32) for t, ta in zip(class_T, tile_as)]
    for i in range(kx):
        for j in range(ny):
            cp = cps_at(i, j)
            for ai, ci in enumerate(active):
                host = schedule_to_host(cp.classes[ci], ntasks_pad=class_T[ai])
                class_tasks[ai][i, j] = host["tasks"]
                class_arow[ai][i, j] = host["a_rows_t"]
                class_aval[ai][i, j] = host["a_vals_t"]
    return tile_as, class_T, class_tasks, class_arow, class_aval


def _stack_gather(g_at, kx, ny):
    """(ngroups, g_bases, g_table, g_apack, g_bpack): every device's
    residue plan (``g_at(i, j)``, or None) padded to common shapes."""
    g_list = [g_at(i, j) for i in range(kx) for j in range(ny)]
    g_list = [g for g in g_list if g is not None]
    if not g_list:
        return 0, None, None, None, None
    ngroups = round_up_bucket(max(g.ngroups for g in g_list), min_size=1)
    nab8 = round_up_bucket(max(g.a_pack.shape[0] // 8 for g in g_list), min_size=1)
    nbb8 = round_up_bucket(max(g.b_pack.shape[0] // 8 for g in g_list), min_size=1)
    g_bases = np.zeros((kx, ny, ngroups * 2), np.int32)
    g_table = np.zeros((kx, ny, ngroups, GROUP_SUBS, TILE_B), np.int32)
    g_apack = np.zeros((kx, ny, nab8, 8, 4, TILE_B), np.int32)
    g_bpack = np.zeros((kx, ny, nbb8, 8, 2, TILE_B), np.int32)
    for i in range(kx):
        for j in range(ny):
            g = g_at(i, j)
            if g is None:
                continue
            host = gather_plan_to_host(g, ngroups_pad=ngroups, nab8_pad=nab8, nbb8_pad=nbb8)
            g_bases[i, j] = host["bases"]
            g_table[i, j] = host["table"]
            g_apack[i, j] = host["a_pack"]
            g_bpack[i, j] = host["b_pack"]
    return ngroups, g_bases, g_table, g_apack, g_bpack


def _stack_b_blocks(b_slices, kx, ny):
    """(nblocks, b_cols_blk, b_vals_blk): every device's B shard in
    128-lane blocks, padded to the common block count."""
    nat_nb = max(-(-max(b_slices[d].nnz, 1) // TILE_B) for d in b_slices)
    nblocks = round_up_bucket(-(-nat_nb // _A_GROUP) * _A_GROUP, min_size=_A_GROUP)
    nblocks = -(-nblocks // _A_GROUP) * _A_GROUP
    b_cols_blk = np.zeros((kx, ny, nblocks, TILE_B), np.int32)
    b_vals_blk = np.zeros((kx, ny, nblocks, TILE_B), np.float32)
    for (i, j), b_sl in b_slices.items():
        cols_p, vals_p = b_blocks_host(
            np.asarray(b_sl.indices), np.asarray(b_sl.data), nblocks_pad=nblocks
        )
        b_cols_blk[i, j] = cols_p
        b_vals_blk[i, j] = vals_p
    return nblocks, b_cols_blk, b_vals_blk


def shard_plan_tiled(
    a_csc: CSC,
    b_csr: CSR,
    kx: int,
    ny: int = 1,
    waste_limit: float | None = None,
    exchange_chunks: int = 1,
    merge_parts: int | None = None,
    rebase: bool | None = None,
) -> ShardedTiledPlan:
    """Build the stacked per-device plan for a (kx × ny) grid.

    ``exchange_chunks`` > 1 splits every owner's rows into that many
    product-balanced sub-ranges, exchanged and merged one after another:
    ``chunks`` smaller all_to_alls, each merge a ``chunks``× shorter
    stream. ``merge_parts`` splits each chunk's merge into key-range
    parts without touching the exchange (None: the auto pick of
    :func:`_merge_part_count`). ``waste_limit=None`` takes the cost
    model's pick (``sched.autotune``). ``rebase`` (default: m·n ≥ 2³²)
    takes the rebased plan; ``rebase=False`` past 2³² raises, since the
    packed keys would wrap."""
    if a_csc.shape[1] != b_csr.shape[0]:
        raise ValueError("inner dimensions differ")
    m, n = a_csc.shape[0], b_csr.shape[1]
    if rebase is None:
        rebase = m * n >= 2**32
    elif not rebase and m * n >= 2**32:
        raise ValueError(
            f"global packed keys need m*n < 2^32, got {m}*{n}; use rebase=True (or None)"
        )
    if waste_limit is None:
        from outerspace_tpu_torch.sched.autotune import autotune

        waste_limit = autotune(a_csc, b_csr)[1]
    if rebase:
        return _shard_plan_tiled_rebased(
            a_csc, b_csr, kx, ny, waste_limit, exchange_chunks, merge_parts,
        )
    from outerspace_tpu_torch.ops.symbolic import per_outer_index_flops

    flops = per_outer_index_flops(a_csc, b_csr)
    k_bounds = balanced_contiguous_partition(flops.astype(np.float64), kx)
    col_bounds = _col_bounds(b_csr, n, ny)
    rows_per_x = -(-m // kx)
    chunks = max(1, int(exchange_chunks))
    # (owner, chunk) row starts: each owner's range subdivides into
    # `chunks` product-balanced sub-ranges
    prod_row = _prod_row(a_csc, b_csr, m)
    row_starts_all = np.empty(kx * chunks + 1, dtype=np.int64)
    for d in range(kx):
        lo = min(d * rows_per_x, m)
        hi = min((d + 1) * rows_per_x, m)
        sub = balanced_contiguous_partition(prod_row[lo:hi], chunks) + lo
        row_starts_all[d * chunks : (d + 1) * chunks] = sub[:-1]
    row_starts_all[-1] = m

    # ---- per-device planning ----
    cps, gplans, b_slices, per_dst, dst_inputs = {}, {}, {}, {}, {}
    for i in range(kx):
        k_lo, k_hi = int(k_bounds[i]), int(k_bounds[i + 1])
        a_sl = slice_a_columns(a_csc, k_lo, k_hi)
        a_k_e = np.repeat(
            np.arange(a_sl.shape[1]),
            np.diff(np.asarray(a_sl.indptr)).astype(np.int64),
        )
        # (owner, chunk) bucket of each A-element's output row
        owners = (
            np.searchsorted(
                row_starts_all, np.asarray(a_sl.indices, dtype=np.int64), side="right"
            )
            - 1
        )
        for j in range(ny):
            c_lo, c_hi = int(col_bounds[j]), int(col_bounds[j + 1])
            b_sl = slice_b_rows_cols(b_csr, k_lo, k_hi, c_lo, c_hi)
            b_slices[i, j] = b_sl
            cp = plan_outer_classes(a_sl, b_sl, waste_limit=waste_limit)
            cps[i, j] = cp
            nb_sl = b_sl.major_nnz().astype(np.int64)
            gplans[i, j] = _residue_plan(a_sl, b_sl, cp, nb_sl, m, n)
            # exact per-destination real product counts (exchange sizing)
            counts_e = nb_sl[a_k_e] if a_k_e.shape[0] else np.zeros(0, dtype=np.int64)
            per_dst[i, j] = np.bincount(
                owners, weights=counts_e, minlength=kx * chunks
            ).astype(np.int64)
            dst_inputs[i, j] = (np.asarray(a_sl.indices, dtype=np.int64), counts_e)

    # ---- common shapes across the grid, stacked to [kx, ny, ...] ----
    tile_as, class_T, class_tasks, class_arow, class_aval = _stack_classes(
        lambda i, j: cps[i, j], kx, ny,
        lambda ci: max(cps[d].classes[ci].ntasks for d in cps),
    )
    if tile_as:
        nblocks, b_cols_blk, b_vals_blk = _stack_b_blocks(b_slices, kx, ny)
    else:
        nblocks = _stack_b_blocks(b_slices, kx, ny)[0]
        b_cols_blk = b_vals_blk = None
    ngroups, g_bases, g_table, g_apack, g_bpack = _stack_gather(
        lambda i, j: gplans[i, j], kx, ny)

    # ---- exchange sizing (exact) + merge bookkeeping ----
    cap = max((int(per_dst[d].max()) for d in per_dst if per_dst[d].size), default=1)
    # the JAX package's bucket grid (2^k·{1, 1.25, 1.5, 1.75}); kept so
    # both packages size the same buffers
    capacity = round_up_bucket(cap, min_size=1024)
    mparts = _merge_part_count(kx, capacity, merge_parts)
    row_fine, mcap, recv_pad = _fine_rows(
        prod_row, row_starts_all, dst_inputs, kx, ny, chunks, mparts, m, per_dst, capacity)

    boundaries = _pack_u32_biased(row_starts_all * n)
    # device d's part boundaries: its own (chunk, part) row starts plus
    # the closing bound (consecutive devices share interior points)
    fine_b = _pack_u32_biased(row_fine * n)
    per_dev = np.stack(
        [fine_b[d * chunks * mparts : (d + 1) * chunks * mparts + 1] for d in range(kx)]
    )
    mbounds = np.broadcast_to(per_dev[:, None, :], (kx, ny, chunks * mparts + 1)).copy()

    plan = ShardedTiledPlan(
        m=m, n=n, kx=kx, ny=ny, rows_per_x=rows_per_x,
        capacity=capacity, chunks=chunks, merge_parts=mparts,
        mcap=mcap, max_run=_max_run(a_csc, m),
        tile_as=tile_as, class_T=class_T, nblocks=nblocks,
        ngroups=ngroups, b_win=B_WIN,
        class_tasks=class_tasks, class_arow=class_arow, class_aval=class_aval,
        b_cols_blk=b_cols_blk, b_vals_blk=b_vals_blk,
        g_bases=g_bases, g_table=g_table, g_apack=g_apack, g_bpack=g_bpack,
        recv_pad=recv_pad, boundaries=boundaries, mbounds=mbounds,
    )
    if plan.stream_len >= 2**31:
        raise ValueError(
            f"per-device stream {plan.stream_len} exceeds int32 index space; use more devices"
        )
    return plan


def _shard_plan_tiled_rebased(
    a_csc: CSC,
    b_csr: CSR,
    kx: int,
    ny: int,
    waste_limit: float,
    exchange_chunks: int,
    merge_parts: int | None,
) -> ShardedTiledPlan:
    """Rebased-key variant of :func:`shard_plan_tiled` for m·n ≥ 2³².

    Every destination bucket (owner d, chunk c) gets its own sub-plan on
    a row-rebased A slice, so its keys live in the bucket's span·n < 2³²
    space, and each bucket's sorted stream starts with its exchange slot
    (real products sort strictly below the sentinel). Chunk bounds are
    span-capped (``_owner_chunk_starts``) and ``chunks`` rises to cover
    every owner's rows. B's blocks are shared across buckets; only the A
    side and the gather residue split."""
    from outerspace_tpu_torch.ops.spgemm import _slice_a_rows
    from outerspace_tpu_torch.ops.symbolic import per_outer_index_flops

    m, n = a_csc.shape[0], b_csr.shape[1]
    if n >= 2**31 or m >= 2**31:
        raise ValueError(
            "rebased tiled sharding needs m and n to fit int32 "
            "(n alone must leave row-span room in the u32 key space)"
        )
    span_cap = max((2**32 - 1) // n, 1)
    flops = per_outer_index_flops(a_csc, b_csr)
    k_bounds = balanced_contiguous_partition(flops.astype(np.float64), kx)
    col_bounds = _col_bounds(b_csr, n, ny)
    rows_per_x = -(-m // kx)
    chunks = max(1, int(exchange_chunks), -(-rows_per_x // span_cap))
    prod_row = _prod_row(a_csc, b_csr, m)
    row_starts_all = np.empty(kx * chunks + 1, dtype=np.int64)
    for d in range(kx):
        lo = min(d * rows_per_x, m)
        hi = min((d + 1) * rows_per_x, m)
        sub = _owner_chunk_starts(prod_row, lo, hi, chunks, span_cap)
        row_starts_all[d * chunks : (d + 1) * chunks] = sub[:-1]
    row_starts_all[-1] = m
    spans = np.diff(row_starts_all)
    if int(spans.max(initial=0)) > span_cap:
        raise AssertionError("span-capped chunking exceeded the key space")

    # ---- per-(device, bucket) sub-planning ----
    cps, gplans, b_slices, per_dst, dst_inputs = {}, {}, {}, {}, {}
    nbuckets = kx * chunks
    for i in range(kx):
        k_lo, k_hi = int(k_bounds[i]), int(k_bounds[i + 1])
        a_sl = slice_a_columns(a_csc, k_lo, k_hi)
        a_k_e = np.repeat(
            np.arange(a_sl.shape[1]),
            np.diff(np.asarray(a_sl.indptr)).astype(np.int64),
        )
        owners = (
            np.searchsorted(
                row_starts_all, np.asarray(a_sl.indices, dtype=np.int64), side="right"
            )
            - 1
        )
        for j in range(ny):
            c_lo, c_hi = int(col_bounds[j]), int(col_bounds[j + 1])
            b_sl = slice_b_rows_cols(b_csr, k_lo, k_hi, c_lo, c_hi)
            b_slices[i, j] = b_sl
            nb_sl = b_sl.major_nnz().astype(np.int64)
            counts_e = nb_sl[a_k_e] if a_k_e.shape[0] else np.zeros(0, dtype=np.int64)
            per_dst[i, j] = np.bincount(
                owners, weights=counts_e, minlength=nbuckets
            ).astype(np.int64)
            dst_inputs[i, j] = (np.asarray(a_sl.indices, dtype=np.int64), counts_e)
            for b in range(nbuckets):
                lo = int(row_starts_all[b])
                hi = int(row_starts_all[b + 1])
                a_sub = _slice_a_rows(a_sl, lo, hi, local=True)
                cp = plan_outer_classes(a_sub, b_sl, waste_limit=waste_limit)
                cps[i, j, b] = cp
                gplans[i, j, b] = _residue_plan(a_sub, b_sl, cp, nb_sl, hi - lo, n)

    # ---- per-bucket common shapes across the device grid ----
    buckets = []
    any_tiles = False
    for b in range(nbuckets):
        tile_as, class_T, class_tasks, class_arow, class_aval = _stack_classes(
            lambda i, j, b=b: cps[i, j, b], kx, ny,
            lambda ci, b=b: max(cps[i, j, b].classes[ci].ntasks
                                for i in range(kx) for j in range(ny)),
        )
        any_tiles = any_tiles or bool(tile_as)
        ngroups, g_bases, g_table, g_apack, g_bpack = _stack_gather(
            lambda i, j, b=b: gplans[i, j, b], kx, ny)
        bk = dict(
            tile_as=tile_as, class_T=class_T, ngroups=ngroups,
            b_win=B_WIN, class_tasks=class_tasks, class_arow=class_arow,
            class_aval=class_aval, g_bases=g_bases, g_table=g_table,
            g_apack=g_apack, g_bpack=g_bpack,
        )
        if _bucket_stream_len(bk) >= 2**31:
            raise ValueError(
                "per-bucket stream exceeds int32 index space; use more devices or chunks"
            )
        buckets.append(bk)

    if any_tiles:
        nblocks, b_cols_blk, b_vals_blk = _stack_b_blocks(b_slices, kx, ny)
    else:
        nblocks = 0
        b_cols_blk = b_vals_blk = None

    # ---- exchange sizing + merge bookkeeping (global rows; bounds are
    # emitted rebased per bucket) ----
    cap = max((int(per_dst[d].max()) for d in per_dst if per_dst[d].size), default=1)
    capacity = round_up_bucket(cap, min_size=1024)
    mparts = _merge_part_count(kx, capacity, merge_parts)
    row_fine, mcap, recv_pad = _fine_rows(
        prod_row, row_starts_all, dst_inputs, kx, ny, chunks, mparts, m, per_dst, capacity)

    # rebased per-device part boundaries [kx, ny, chunks, parts+1]: each
    # chunk closes at its own span·n and opens at 0
    mbounds = np.zeros((kx, ny, chunks, mparts + 1), np.int32)
    row_base = np.zeros((kx, ny, chunks), np.int32)
    for d in range(kx):
        for c in range(chunks):
            b = d * chunks + c
            lo = int(row_starts_all[b])
            fine = (
                row_fine[b * mparts : (b + 1) * mparts + 1]
                if mparts > 1
                else row_starts_all[b : b + 2]
            )
            reb = (fine.astype(np.int64) - lo) * n
            mbounds[d, :, c] = _pack_u32_biased(reb)
            row_base[d, :, c] = lo

    return ShardedTiledPlan(
        m=m, n=n, kx=kx, ny=ny, rows_per_x=rows_per_x,
        capacity=capacity, chunks=chunks, merge_parts=mparts,
        mcap=mcap, max_run=_max_run(a_csc, m),
        tile_as=(), class_T=(), nblocks=nblocks,
        ngroups=0, b_win=B_WIN,
        class_tasks=[], class_arow=[], class_aval=[],
        b_cols_blk=b_cols_blk, b_vals_blk=b_vals_blk,
        g_bases=None, g_table=None, g_apack=None, g_bpack=None,
        recv_pad=recv_pad, boundaries=np.zeros(0, np.int32),
        mbounds=mbounds, rebase=True, buckets=buckets,
        row_base=row_base,
        sentinel_span=int(max(spans.max(initial=1), 1)),
    )


# --------------------------------------------------------------------------
# The rank's program
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RankExpand:
    """One stream's expand inputs on a rank, staged: the K3 group of its
    own tasks (None if it has none) and K1's residue (None if none)."""

    group: TileGroup | None
    gather: dict | None  # bases, table, a_pack, b_pack, group_bits
    b_win: int

    @property
    def slots(self) -> int:
        g = self.group.slots if self.group is not None else 0
        k1 = self.gather["table"].shape[0] * GROUP_SUBS * SUB_P if self.gather else 0
        return g + k1

    def expand(self, n_cols: int, out_keys, out_vals) -> None:
        """K3 over the group, then K1, in place into the first
        :attr:`slots` slots of ``out_keys`` / ``out_vals``."""
        pos = 0
        if self.group is not None:
            pos = self.group.slots
            expand_part_packed(self.group, n_cols=n_cols, out_keys=out_keys[:pos],
                               out_vals=out_vals[:pos])
        if self.gather is not None:
            g = self.gather
            end = self.slots
            expand_gather(g["bases"], g["table"], g["a_pack"], g["b_pack"], g["group_bits"],
                          b_win=self.b_win, out=(out_keys[pos:end], out_vals[pos:end]))


def _live_tasks(tasks: np.ndarray) -> int:
    """Real tasks of a padded class table (padding tasks, a_len = 0,
    follow them)."""
    return int((tasks.reshape(-1, 4)[:, 0] > 0).sum())


def _stream_tables(plan: ShardedTiledPlan):
    """Each stream's (tile_as, tasks, ngroups): one in global mode, one
    per destination bucket in rebased mode."""
    if plan.rebase:
        return [(bk["tile_as"], bk["class_tasks"], bk["ngroups"]) for bk in plan.buckets]
    return [(plan.tile_as, plan.class_tasks, plan.ngroups)]


def rank_stream_lens(plan: ShardedTiledPlan, i: int, j: int) -> list[int]:
    """Slots that rank (i, j) expands into each of its streams: K3 over
    its own tasks (the grid's common padding left out), K1 over every
    group of the residue."""
    return [sum(_live_tasks(t[i, j]) * ta * TILE_B for ta, t in zip(tile_as, tasks))
            + ngroups * GROUP_SUBS * SUB_P
            for tile_as, tasks, ngroups in _stream_tables(plan)]


def _stage_rank_expand(class_rows, b_blk, gather_rows, b_win: int, device) -> RankExpand:
    """Stage one stream's tables for this rank: ``class_rows`` =
    [(tile_a, tasks[T·4], arow[T, ta], aval[T, ta])] (the common padded
    tables), cut to the rank's own tasks (padding tasks, a_len = 0, come
    after the real ones); ``b_blk`` = (device cols, device vals) blocks;
    ``gather_rows`` = (bases, table, a_pack, b_pack) or None."""
    tables = []
    for tile_a, tasks, arow, aval in class_rows:
        live = _live_tasks(tasks)
        if live:
            tables.append((tile_a, tasks[:4 * live], arow[:live], aval[:live]))
    group = None
    if tables:
        desc = group_descriptor([(ta, t.shape[0] // 4) for ta, t, _, _ in tables])

        def join(i, dtype):
            x = np.concatenate([np.asarray(t[i], dtype).reshape(-1) for t in tables])
            return torch.from_numpy(x).to(device)

        group = TileGroup(desc, join(1, np.int32), join(2, np.int32), join(3, np.float32), *b_blk)
    gather = None
    if gather_rows is not None:
        bases, table, a_pack, b_pack = (torch.from_numpy(np.ascontiguousarray(x)).to(device)
                                        for x in gather_rows)
        # the sharded plan keeps no group widths, so every group searches
        # its whole window (always exact)
        bits = torch.full((table.shape[0],), FULL_SEARCH_BITS, dtype=torch.int32, device=device)
        gather = dict(bases=bases, table=table, a_pack=a_pack, b_pack=b_pack, group_bits=bits)
    return RankExpand(group, gather, b_win)


def _empty_merged(m: int, n: int, device) -> MergedCOO:
    return MergedCOO(
        (m, n),
        torch.full((1,), I32_MAX, dtype=torch.int32, device=device),
        torch.zeros(1, dtype=torch.int32, device=device),
        torch.zeros(1, dtype=torch.float32, device=device),
        torch.zeros(1, dtype=torch.bool, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def _concat(m: int, n: int, outs) -> MergedCOO:
    if len(outs) == 1:
        return MergedCOO((m, n), *outs[0])
    nnz = outs[0][4]
    for o in outs[1:]:
        nnz = nnz + o[4]
    return MergedCOO((m, n), *(torch.cat([o[f] for o in outs]) for f in range(4)), nnz)


@dataclasses.dataclass
class ShardedTiledProgram:
    """One rank's tiled sharded program with its inputs staged on
    ``mesh.device``: :meth:`run` expands, sorts, exchanges and merges,
    and returns the rank's merged rows. ``streams``: the staged expand
    inputs, one per stream (one in global mode, one per destination
    bucket in rebased mode); ``bounds``: the (owner, chunk) key starts
    (global mode); ``mbounds``: the rank's merge-part key starts."""

    plan: ShardedTiledPlan
    mesh: object
    axis: str
    i: int
    j: int
    streams: list
    bounds: torch.Tensor
    mbounds: torch.Tensor

    def run(self) -> MergedCOO:
        plan = self.plan
        if not plan.rebase and not plan.tile_as and not plan.ngroups:
            return _empty_merged(plan.m, plan.n, self.mesh.device)
        if plan.rebase:
            return self._run_rebased()
        return self._run_global()

    def _merge(self, k, v, pad: int, sentinel: int):
        plan = self.plan
        if plan.kx == 1:  # one sender: the received buffer is already sorted
            return merge_epilogue(k, v, plan.n, sentinel, pad_count=pad)
        return merge_biased_keys(k, v, plan.n, sentinel, pad_count=pad)

    def _exchange_merge(self, send_k, send_v, c: int, bounds_c, sentinel: int):
        """Chunk ``c``: exchange its buckets along x, then merge in
        ``merge_parts`` key-range parts (each received bucket is a
        sorted run, so one batched search finds every part's run)."""
        plan = self.plan
        kx, cap = plan.kx, plan.capacity
        rk, rv = exchange(self.mesh, self.axis, send_k, send_v)
        pads = plan.recv_pad[self.i, self.j, c]
        if plan.merge_parts == 1:
            return [self._merge(rk, rv, int(pads[0]), sentinel)]
        dev = rk.device
        pos = torch.searchsorted(rk.view(kx, cap), bounds_c.expand(kx, -1).contiguous())
        base = (torch.arange(kx, device=dev) * cap)[:, None]
        pos = pos + base
        outs = []
        for r in range(plan.merge_parts):
            pk, pv = _slice_fill_buckets(pos[:, r], pos[:, r + 1], plan.mcap, kx,
                                         (rk, I32_MAX), (rv, 0.0))
            outs.append(self._merge(pk.reshape(-1), pv.reshape(-1), int(pads[r]), sentinel))
        return outs

    def _run_global(self) -> MergedCOO:
        plan = self.plan
        dev = self.mesh.device
        (rx,) = self.streams
        keys = torch.empty(rx.slots, dtype=torch.int32, device=dev)
        vals = torch.empty(rx.slots, dtype=torch.float32, device=dev)
        rx.expand(plan.n, keys, vals)
        key, order = torch.sort(keys)
        val = vals[order]
        bstart = torch.searchsorted(key, self.bounds)
        starts = bstart[:-1].view(plan.kx, plan.chunks)
        ends = bstart[1:].view(plan.kx, plan.chunks)
        mb = self.mbounds
        mp = plan.merge_parts
        outs = []
        for c in range(plan.chunks):
            send_k, send_v = _slice_fill_buckets(starts[:, c], ends[:, c], plan.capacity,
                                                 plan.kx, (key, I32_MAX), (val, 0.0))
            outs += self._exchange_merge(send_k, send_v, c, mb[c * mp:(c + 1) * mp + 1], plan.m)
        return _concat(plan.m, plan.n, outs)

    def _expand_sort_bucket(self, rx: RankExpand):
        """A rebased bucket's exchange slot: its stream expanded and
        sorted, cut or sentinel-padded to ``capacity``."""
        cap = self.plan.capacity
        dev = self.mesh.device
        keys = torch.full((max(rx.slots, cap),), I32_MAX, dtype=torch.int32, device=dev)
        vals = torch.zeros(max(rx.slots, cap), dtype=torch.float32, device=dev)
        if rx.slots:
            rx.expand(self.plan.n, keys, vals)
            k, order = torch.sort(keys[:rx.slots])
            keys[:rx.slots] = k
            vals[:rx.slots] = vals[:rx.slots][order]
        return keys[:cap], vals[:cap]

    def _run_rebased(self) -> MergedCOO:
        plan = self.plan
        mb = self.mbounds
        outs = []
        for c in range(plan.chunks):
            slots = [self._expand_sort_bucket(self.streams[d * plan.chunks + c])
                     for d in range(plan.kx)]
            send_k = torch.stack([k for k, _ in slots])
            send_v = torch.stack([v for _, v in slots])
            base = int(plan.row_base[self.i, self.j, c])
            for mr, mc, mv, mvalid, nnz in self._exchange_merge(
                    send_k, send_v, c, mb[c], plan.sentinel_span):
                outs.append((torch.where(mvalid, mr + base, plan.m), mc, mv, mvalid, nnz))
        return _concat(plan.m, plan.n, outs)


def _rank_axes(plan: ShardedTiledPlan, mesh, axes) -> tuple[str, int, int]:
    """(x axis name, i, j) of this rank for ``plan`` on ``mesh``."""
    if isinstance(axes, str):
        axes = (axes, None)
    ax, ay = axes[0], (axes[1] if len(axes) > 1 else None)
    if plan.ny > 1 and ay is None:
        raise ValueError("2-D plan needs a second mesh axis")
    if mesh.size(ax) != plan.kx:
        raise ValueError(f"plan for kx={plan.kx}, mesh axis {ax!r} has {mesh.size(ax)} ranks")
    j = 0
    if plan.ny > 1:
        if mesh.size(ay) != plan.ny:
            raise ValueError(f"plan for ny={plan.ny}, mesh axis {ay!r} has {mesh.size(ay)} ranks")
        j = mesh.index(ay)
    elif len(mesh.shape) > 1 and ay is not None and mesh.size(ay) != 1:
        raise ValueError(f"a 1-D plan needs the mesh's axis {ay!r} to be 1, got {mesh.size(ay)}")
    return ax, mesh.index(ax), j


def build_sharded_tiled(
    plan: ShardedTiledPlan,
    mesh,
    axes: tuple[str, str] | str = ("x", "y"),
) -> ShardedTiledProgram:
    """This rank's program for ``plan`` on ``mesh``, its inputs staged on
    ``mesh.device``. ``axes``: (k/row axis, column axis); a 1-D plan
    (ny == 1) takes a single axis name."""
    ax, i, j = _rank_axes(plan, mesh, axes)
    dev = mesh.device
    b_blk = None
    if plan.b_cols_blk is not None:
        b_blk = tuple(torch.from_numpy(np.ascontiguousarray(x[i, j])).to(dev)
                      for x in (plan.b_cols_blk, plan.b_vals_blk))

    def stage(tile_as, tasks, arow, aval, ngroups, g):
        rows = [(ta, tasks[a][i, j], arow[a][i, j], aval[a][i, j]) for a, ta in enumerate(tile_as)]
        gather = tuple(x[i, j] for x in g) if ngroups else None
        return _stage_rank_expand(rows, b_blk, gather, plan.b_win, dev)

    if plan.rebase:
        streams = [stage(bk["tile_as"], bk["class_tasks"], bk["class_arow"], bk["class_aval"],
                         bk["ngroups"], (bk["g_bases"], bk["g_table"], bk["g_apack"],
                                         bk["g_bpack"]))
                   for bk in plan.buckets]
    else:
        streams = [stage(plan.tile_as, plan.class_tasks, plan.class_arow, plan.class_aval,
                         plan.ngroups, (plan.g_bases, plan.g_table, plan.g_apack, plan.g_bpack))]
    bounds, mbounds = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                       for x in (plan.boundaries, plan.mbounds[i, j]))
    return ShardedTiledProgram(plan, mesh, ax, i, j, streams, bounds, mbounds)


def spgemm_sharded_tiled(
    plan: ShardedTiledPlan,
    mesh,
    axes: tuple[str, str] | str = ("x", "y"),
) -> MergedCOO:
    """This rank's part of the tiled sharded SpGEMM over ``mesh``: the
    merged entries of its rows (and, on a 2-D plan, its column range),
    padded, on ``mesh.device``. Every rank calls it with the same plan."""
    return build_sharded_tiled(plan, mesh, axes).run()


def sharded_tiled_to_csr(plan: ShardedTiledPlan, out: MergedCOO) -> CSR | None:
    """Gather every rank's merged output to rank 0 and assemble the CSR
    there (None on the other ranks)."""
    return gather_to_csr((plan.m, plan.n), out)
