"""Sharded SpGEMM with the flat expand: the outer-product index space k
split over the ranks of a mesh.

The port of the JAX package's ``shard/spgemm_sharded.py``. The host plan
is the same numpy (``shard_plan``, ``shard_plan_2d``); the rank's program
runs what one ``shard_map`` device ran:

- the multiply phase over the rank's k-slice (the flat expand,
  ``ops.spgemm.expand_partial_products``);
- a sort by output row, so each owner's products are one contiguous run;
- the runs copied into padded exchange buckets (:func:`_slice_fill_buckets`)
  and sent to their row owners by one all_to_all along the k/row axis
  (:meth:`Mesh.all_to_all`);
- the merge of the owned rows: the biased-key sort and K2 where m·n < 2³²,
  else the two-key merge.

The 2-D plan splits B's columns over a second axis as well, so B is
never replicated; the exchange runs only along x, among the ranks that
share a column range. A rank's result is a ``MergedCOO`` of its rows;
``sharded_result_to_csr`` gathers every rank's entries to rank 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from outerspace_tpu_torch.formats.csr import CSC, CSR
from outerspace_tpu_torch.ops.spgemm import (
    I32_MAX,
    MergedCOO,
    expand_partial_products,
    merge_biased_keys,
    merge_twokey,
    pack_key_biased,
)
from outerspace_tpu_torch.ops.symbolic import (
    expansion_plan_subset,
    per_outer_index_flops,
    round_up_bucket,
)
from outerspace_tpu_torch.shard.mesh import balanced_contiguous_partition


def _slice_fill_buckets(starts, ends, capacity: int, ndst: int, *streams):
    """(ndst, capacity) exchange buffers from streams sorted by owner:
    bucket d holds ``stream[starts[d]:ends[d]]`` (at most ``capacity``
    long) left-aligned, then the stream's dead value. ``streams`` are
    (tensor, dead value) pairs; ``starts`` / ``ends`` int tensors on the
    streams' device, read there (no host read).

    A slot filled from a sorted stream whose dead value is the key-space
    maximum is itself sorted, which the partitioned merge relies on."""
    dev = streams[0][0].device
    lane = torch.arange(capacity, device=dev)
    starts = starts.long()
    idx = starts[:, None] + lane
    live = lane < (ends.long() - starts)[:, None]
    outs = []
    for arr, dead in streams:
        if arr.numel() == 0:
            outs.append(torch.full((ndst, capacity), dead, dtype=arr.dtype, device=dev))
            continue
        got = arr[idx.clamp(max=arr.numel() - 1)]
        # the dead value as a Python scalar: a 0-d tensor made from it would
        # be a copy from the host, a synchronisation on a card
        outs.append(torch.where(live, got, dead))
    return tuple(outs)


def exchange(mesh, axis: str, *streams):
    """Each (ndst, cap) stream's row d to the rank at index d along
    ``axis``, in one all_to_all (the streams ride as int32 lanes of one
    buffer); returns the received streams, each flattened to nsrc·cap."""
    lanes = [s.view(torch.int32) if s.dtype == torch.float32 else s for s in streams]
    recv = mesh.all_to_all(torch.stack(lanes, dim=1).reshape(lanes[0].shape[0], -1), axis)
    recv = recv.view(recv.shape[0], len(streams), -1)
    return tuple((recv[:, i].view(s.dtype) if s.dtype == torch.float32 else recv[:, i])
                 .reshape(-1) for i, s in enumerate(streams))


@dataclasses.dataclass
class ShardedPlan:
    """Host-side static plan for one sharded SpGEMM."""

    m: int
    n: int
    ndev: int
    rows_per_dev: int  # row ownership granularity
    p_pad: int  # per-device expansion padding
    capacity: int  # per-(src, dst) all-to-all bucket capacity
    # Stacked per-device arrays, each [ndev, ...]:
    a_rows: np.ndarray
    a_vals: np.ndarray
    a_k: np.ndarray
    offsets: np.ndarray
    p_total: np.ndarray  # [ndev]
    # Replicated B (CSR):
    b_indptr: np.ndarray
    b_cols: np.ndarray
    b_vals: np.ndarray
    # Merge hints: single-key packed sort where m·n fits int32, and the
    # host bound on duplicates per output coordinate (pow2-rounded).
    packed: bool = False
    max_run: int = 1


def shard_plan(a_csc: CSC, b_csr: CSR, ndev: int) -> ShardedPlan:
    """Split the outer-product index space into ``ndev`` FLOP-balanced
    contiguous k-ranges and compute exact exchange capacities."""
    if a_csc.shape[1] != b_csr.shape[0]:
        raise ValueError("inner dimensions differ")
    m, n = a_csc.shape[0], b_csr.shape[1]
    flops = per_outer_index_flops(a_csc, b_csr)
    bounds = balanced_contiguous_partition(flops.astype(np.float64), ndev)
    rows_per_dev = -(-m // ndev)

    plans = []
    for d in range(ndev):
        ks = np.arange(bounds[d], bounds[d + 1], dtype=np.int64)
        plans.append(expansion_plan_subset(a_csc, b_csr, ks))

    max_nnz_a = max(max(p.a_rows.shape[0] for p in plans), 1)
    max_p = max(max(p.expansion_size for p in plans), 1)
    if max_p >= 2**31:
        raise ValueError(
            f"per-device expansion size {max_p} exceeds int32 index space; "
            "use more devices or split the operands"
        )
    p_pad = round_up_bucket(max_p)

    def pad_stack(field, fill):
        out = np.full((ndev, max_nnz_a), fill, dtype=np.int32)
        for d, p in enumerate(plans):
            arr = getattr(p, field)
            out[d, : arr.shape[0]] = arr
        return out

    a_rows = pad_stack("a_rows", 0)
    a_k = pad_stack("a_k", 0)
    a_vals = np.zeros((ndev, max_nnz_a), dtype=np.float32)
    offsets = np.zeros((ndev, max_nnz_a + 1), dtype=np.int32)
    p_total = np.zeros(ndev, dtype=np.int32)
    for d, p in enumerate(plans):
        a_vals[d, : p.a_vals.shape[0]] = p.a_vals
        off = p.offsets.astype(np.int32)
        offsets[d, : off.shape[0]] = off
        offsets[d, off.shape[0] :] = off[-1]  # zero-length tail segments
        p_total[d] = p.expansion_size

    # Exact per-(src, dst) counts: every partial product of A-nonzero e
    # lands in row a_rows[e], owner = row // rows_per_dev.
    capacity = 1
    for d, p in enumerate(plans):
        if p.a_rows.shape[0] == 0:
            continue
        counts = np.diff(p.offsets)
        owners = p.a_rows // rows_per_dev
        per_dst = np.bincount(owners, weights=counts, minlength=ndev)
        capacity = max(capacity, int(per_dst.max()))
    capacity = round_up_bucket(capacity, min_size=128)

    return ShardedPlan(
        m=m,
        n=n,
        ndev=ndev,
        rows_per_dev=rows_per_dev,
        p_pad=int(p_pad),
        capacity=int(capacity),
        a_rows=a_rows,
        a_vals=a_vals,
        a_k=a_k,
        offsets=offsets,
        p_total=p_total,
        b_indptr=np.asarray(b_csr.indptr, dtype=np.int32),
        b_cols=np.asarray(b_csr.indices, dtype=np.int32),
        b_vals=np.asarray(b_csr.data, dtype=np.float32),
        packed=bool(m * n < 2**32),
        max_run=1
        << (
            max(
                int(np.bincount(a_csc.indices, minlength=m).max(initial=1)),
                1,
            )
            - 1
        ).bit_length(),
    )


def _incoming(a_rows: np.ndarray, offsets: np.ndarray, rows_per: int, owner: int) -> int:
    """Real products that the senders' slices (``a_rows[s]``,
    ``offsets[s]``, stacked) route to ``owner``: the merge's exact
    count of received real slots."""
    counts = np.diff(offsets.astype(np.int64), axis=-1)
    return int(counts[a_rows.astype(np.int64) // rows_per == owner].sum())


def _local_shard(mesh, axis, a_rows, a_vals, a_k, offsets, b_indptr, b_cols, b_vals, *,
                 p_total: int, p_pad: int, m: int, n: int, rows_per_dev: int, ndst: int,
                 capacity: int, packed: bool, incoming: int) -> MergedCOO:
    """One rank's program (``_local_shard_fn`` of the JAX package): expand
    its k-slice, sort by row, fill the owner buckets, exchange along
    ``axis``, merge the owned rows."""
    dev = mesh.device

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)

    r, c, v = expand_partial_products(
        put(a_rows, np.int32), put(a_vals, np.float32), put(a_k, np.int32),
        put(b_indptr, np.int32), put(b_cols, np.int32), put(b_vals, np.float32),
        put(offsets, np.int32), p_total, p_pad, m,
    )
    r, order = torch.sort(r)
    c, v = c[order], v[order]
    row_bounds = torch.clamp(
        torch.arange(1, ndst + 1, dtype=torch.int32, device=dev) * rows_per_dev, max=m)
    bstart = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.searchsorted(r, row_bounds)])
    send = _slice_fill_buckets(bstart[:-1], bstart[1:], capacity, ndst,
                               (r, I32_MAX), (c, 0), (v, 0.0))
    recv_r, recv_c, recv_v = exchange(mesh, axis, *send)
    if packed:
        valid = recv_r < m
        key = torch.where(valid, pack_key_biased(recv_r, recv_c, n), I32_MAX)
        out = merge_biased_keys(key, recv_v, n, m, pad_count=recv_r.numel() - incoming)
    else:
        out = merge_twokey(recv_r, recv_c, recv_v, I32_MAX)
    return MergedCOO((m, n), *out)


def spgemm_sharded(plan: ShardedPlan, mesh, axis: str = "x") -> MergedCOO:
    """This rank's part of the sharded SpGEMM over ``mesh`` (1-D along
    ``axis``): the merged entries of the rows it owns, padded, on
    ``mesh.device``. Every rank of the mesh calls it with the same plan."""
    if mesh.size(axis) != plan.ndev:
        raise ValueError(f"plan for {plan.ndev} devices, mesh axis {axis!r} has {mesh.size(axis)}")
    d = mesh.index(axis)
    return _local_shard(
        mesh, axis, plan.a_rows[d], plan.a_vals[d], plan.a_k[d], plan.offsets[d],
        plan.b_indptr, plan.b_cols, plan.b_vals,
        p_total=int(plan.p_total[d]), p_pad=plan.p_pad, m=plan.m, n=plan.n,
        rows_per_dev=plan.rows_per_dev, ndst=plan.ndev, capacity=plan.capacity,
        packed=plan.packed,
        incoming=_incoming(plan.a_rows, plan.offsets, plan.rows_per_dev, d),
    )


def gather_to_csr(shape, out: MergedCOO) -> CSR | None:
    """Every rank's valid entries gathered to rank 0 of the default group
    and assembled into a host CSR there; None on the other ranks."""
    import torch.distributed as dist

    from outerspace_tpu_torch.formats.coo import COO

    sel = out.valid
    local = tuple(t[sel].cpu().numpy() for t in (out.rows, out.cols, out.vals))
    rank = dist.get_rank()
    parts = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(local, parts, dst=0)
    if rank != 0:
        return None
    return COO(
        shape,
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
        np.concatenate([p[2] for p in parts]),
    ).to_csr()


def allgather_to_csr(shape, out: MergedCOO) -> CSR:
    """Every rank's valid entries gathered to every rank of the default
    group and assembled into a host CSR on each (a rank that plans the
    next product needs all of this one)."""
    import torch.distributed as dist

    from outerspace_tpu_torch.formats.coo import COO

    sel = out.valid
    local = tuple(t[sel].cpu().numpy() for t in (out.rows, out.cols, out.vals))
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, local)
    return COO(shape, *(np.concatenate([p[f] for p in parts]) for f in range(3))).to_csr()


def sharded_result_to_csr(plan: ShardedPlan, out: MergedCOO) -> CSR | None:
    """Gather every rank's merged output to rank 0 and assemble the CSR
    there (None on the other ranks)."""
    return gather_to_csr((plan.m, plan.n), out)


# --------------------------------------------------------------------------
# 2-D partition: outer-product index space k × output-column space
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedPlan2D:
    """Host-side static plan for the 2-D sharded SpGEMM: k (and the
    merge's output rows) split along "x" into ``kx`` ranges, B's
    columns along "y" into ``ny``, so rank (i, j) holds A's k-slice i and
    only B's (k-slice i × column range j) shard."""

    m: int
    n: int
    kx: int
    ny: int
    rows_per_dev: int  # output-row ownership granularity along x
    p_pad: int
    capacity: int
    max_run: int
    col_bounds: np.ndarray  # int64[ny+1]
    # Stacked per-device arrays, leading dims [kx, ny, ...]:
    a_rows: np.ndarray
    a_vals: np.ndarray
    a_k_local: np.ndarray  # k localised to the device's B shard rows
    offsets: np.ndarray
    p_total: np.ndarray  # [kx, ny]
    b_indptr: np.ndarray  # [kx, ny, klocal_max+1]
    b_cols: np.ndarray  # [kx, ny, nnzb_max]
    b_vals: np.ndarray


def shard_plan_2d(a_csc: CSC, b_csr: CSR, kx: int, ny: int) -> ShardedPlan2D:
    """Split k into ``kx`` FLOP-balanced ranges and B's columns into
    ``ny`` nnz-balanced ranges; compute exact exchange capacities."""
    if a_csc.shape[1] != b_csr.shape[0]:
        raise ValueError("inner dimensions differ")
    m, n = a_csc.shape[0], b_csr.shape[1]
    flops = per_outer_index_flops(a_csc, b_csr)
    k_bounds = balanced_contiguous_partition(flops.astype(np.float64), kx)
    col_hist = np.bincount(
        np.asarray(b_csr.indices, dtype=np.int64), minlength=n
    ).astype(np.float64)
    col_bounds = balanced_contiguous_partition(col_hist, ny)
    rows_per_dev = -(-m // kx)

    from outerspace_tpu_torch.shard.tiled import slice_b_rows_cols

    a_ptr = np.asarray(a_csc.indptr)
    a_rows_all = np.asarray(a_csc.indices)
    a_vals_all = np.asarray(a_csc.data, dtype=np.float32)

    parts = {}
    max_nnz_a = max_nnz_b = max_kloc = 1
    max_p = 1
    for i in range(kx):
        k_lo, k_hi = int(k_bounds[i]), int(k_bounds[i + 1])
        kloc = k_hi - k_lo
        max_kloc = max(max_kloc, kloc)
        e0, e1 = int(a_ptr[k_lo]), int(a_ptr[k_hi])
        a_rows_i = a_rows_all[e0:e1].astype(np.int32)
        a_vals_i = a_vals_all[e0:e1]
        a_k_i = (
            np.repeat(
                np.arange(k_lo, k_hi, dtype=np.int64),
                np.diff(a_ptr[k_lo : k_hi + 1]).astype(np.int64),
            )
            - k_lo
        ).astype(np.int32)
        max_nnz_a = max(max_nnz_a, a_rows_i.shape[0])
        for j in range(ny):
            c_lo, c_hi = int(col_bounds[j]), int(col_bounds[j + 1])
            b_sl = slice_b_rows_cols(b_csr, k_lo, k_hi, c_lo, c_hi)
            ptr_loc = np.asarray(b_sl.indptr, dtype=np.int64)
            b_cols_ij = np.asarray(b_sl.indices).astype(np.int32)
            b_vals_ij = np.asarray(b_sl.data).astype(np.float32)
            counts = ptr_loc[a_k_i + 1] - ptr_loc[a_k_i]
            offs = np.zeros(a_k_i.shape[0] + 1, dtype=np.int64)
            np.cumsum(counts, out=offs[1:])
            p_ij = int(offs[-1])
            max_p = max(max_p, p_ij)
            max_nnz_b = max(max_nnz_b, b_cols_ij.shape[0])
            parts[(i, j)] = (
                a_rows_i, a_vals_i, a_k_i, ptr_loc, b_cols_ij, b_vals_ij,
                offs, p_ij,
            )
    if max_p >= 2**31:
        raise ValueError("per-device expansion exceeds int32 index space")
    p_pad = round_up_bucket(max_p)

    a_rows = np.zeros((kx, ny, max_nnz_a), np.int32)
    a_vals = np.zeros((kx, ny, max_nnz_a), np.float32)
    a_k_local = np.zeros((kx, ny, max_nnz_a), np.int32)
    offsets = np.zeros((kx, ny, max_nnz_a + 1), np.int32)
    p_total = np.zeros((kx, ny), np.int32)
    b_indptr = np.zeros((kx, ny, max_kloc + 1), np.int32)
    b_cols = np.zeros((kx, ny, max(max_nnz_b, 1)), np.int32)
    b_vals = np.zeros((kx, ny, max(max_nnz_b, 1)), np.float32)
    capacity = 1
    for (i, j), (ar, av, ak, ptr, bc, bv, offs, p_ij) in parts.items():
        na = ar.shape[0]
        a_rows[i, j, :na] = ar
        a_vals[i, j, :na] = av
        a_k_local[i, j, :na] = ak
        offsets[i, j, : na + 1] = offs.astype(np.int32)
        offsets[i, j, na + 1 :] = offs[-1]
        p_total[i, j] = p_ij
        b_indptr[i, j, : ptr.shape[0]] = ptr.astype(np.int32)
        b_indptr[i, j, ptr.shape[0] :] = ptr[-1]
        b_cols[i, j, : bc.shape[0]] = bc
        b_vals[i, j, : bv.shape[0]] = bv
        if na:
            counts = np.diff(offs)
            owners = ar // rows_per_dev
            per_dst = np.bincount(owners, weights=counts, minlength=kx)
            capacity = max(capacity, int(per_dst.max()))
    capacity = round_up_bucket(capacity, min_size=128)
    max_run = int(np.bincount(a_rows_all, minlength=m).max(initial=1))
    max_run = 1 << (max(max_run, 1) - 1).bit_length()

    return ShardedPlan2D(
        m=m, n=n, kx=kx, ny=ny, rows_per_dev=rows_per_dev,
        p_pad=int(p_pad), capacity=int(capacity), max_run=max_run,
        col_bounds=col_bounds,
        a_rows=a_rows, a_vals=a_vals, a_k_local=a_k_local,
        offsets=offsets, p_total=p_total,
        b_indptr=b_indptr, b_cols=b_cols, b_vals=b_vals,
    )


def spgemm_sharded_2d(plan: ShardedPlan2D, mesh, axes: tuple[str, str] = ("x", "y")) -> MergedCOO:
    """This rank's part of the 2-D sharded SpGEMM over ``mesh`` (axes =
    (k/row, column)): the merged entries of its row block in its column
    range. The exchange runs along the first axis only."""
    ax, ay = axes
    if (mesh.size(ax), mesh.size(ay)) != (plan.kx, plan.ny):
        raise ValueError(f"plan for a {plan.kx}x{plan.ny} mesh, mesh axes {axes} are "
                         f"{mesh.size(ax)}x{mesh.size(ay)}")
    i, j = mesh.index(ax), mesh.index(ay)
    return _local_shard(
        mesh, ax, plan.a_rows[i, j], plan.a_vals[i, j], plan.a_k_local[i, j],
        plan.offsets[i, j], plan.b_indptr[i, j], plan.b_cols[i, j], plan.b_vals[i, j],
        p_total=int(plan.p_total[i, j]), p_pad=plan.p_pad, m=plan.m, n=plan.n,
        rows_per_dev=plan.rows_per_dev, ndst=plan.kx, capacity=plan.capacity,
        packed=bool(plan.m * plan.n < 2**32),
        incoming=_incoming(plan.a_rows[:, j], plan.offsets[:, j], plan.rows_per_dev, i),
    )


def sharded_2d_result_to_csr(plan: ShardedPlan2D, out: MergedCOO) -> CSR | None:
    """Gather every rank's merged output to rank 0 and assemble the CSR
    there (None on the other ranks)."""
    return gather_to_csr((plan.m, plan.n), out)
