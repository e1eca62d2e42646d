"""Device-resident sharded Markov clustering: the whole MCL loop runs in
the ranks of a mesh, with no host planning between iterations.

The port of the JAX package's ``shard/mcl.py``. ``ops.graph.
markov_cluster_sharded`` plans every squaring on the host; here the flow
stays on the ranks' devices and each iteration is one step of the rank
program (:class:`ShardedMclProgram`):

- **expand**: the flat expand over the rank's k-slice
  (``ops.spgemm.expand_partial_products``), its offsets derived on the
  device from the flow's row counts, its product count a 0-d tensor;
- **exchange**: one ``torch.sort`` by packed (row, col) key, static
  owner-range bounds found by ``torch.searchsorted``,
  ``_slice_fill_buckets`` and one all_to_all along "x";
- **merge**: ``torch.sort`` and K2 over what the rank received (K2 alone
  with one sender, whose stream arrives sorted);
- **inflate / prune / normalise**: elementwise, with a dense column sum
  all-reduced along "x" (:meth:`Mesh.psum`);
- **re-shard**: the new flow is row-sharded; the next iteration's A side
  (the CSC k-slices) comes from a second all_to_all keyed by column
  owner, and on a 2-D mesh an all_gather along "y" (the A slices are
  y-replicated, as ``shard_plan_tiled``'s are).

Keys are the one-card chain's (``ops.kernels.compact.key_dtype``):
biased int32 ``row·m + col − 2³¹`` while m² < 2³², else the plain int64
``row·m + col`` with the sentinel INT64_MAX, whose merge takes K2's
64-bit instantiation; the exchange carries an int64 key as two int32
lanes beside the value's. Any m < 2³¹ is planned.

Every static size comes from one host scipy recurrence before the loop
(:func:`_sharded_mcl_sizing`), run once per flow and mesh and kept in
the sizing cache (``sched/sizing_cache.py``); in a world, rank 0 sizes
and broadcasts the budgets. A device ``ok`` flag guards them. JAX's
``lax.while_loop`` stops on the device once the flow converges or a
budget fails; here the loop runs ``iters`` bodies and each body's carry
is taken only where the loop is still live (``torch.where``, so a
converged or failed state stays frozen), and the flags are read once at
the end: the results are the while loop's. If a budget failed,
:func:`run_to_csr` falls back to the exact host-planned loop, and its
``report`` names the budgets that failed.

The sizing also counts the initial flow (the JAX package sizes the flow
buffer and the re-shard bucket from the iterations' flows only, and
refuses a dense adjacency whose initial flow exceeds them). A rank
stages only its own shard of the initial flow (:meth:`ShardedMclPlan.
shard`).

k-partition == output-row ownership (uniform ``rows_per_x``), so the
B side of the next iteration is exactly the merge output. Requires an
expansion of 2.

Spans (``perf.timer``, recorded under the profiler), named as the
one-card chain's where they mean the same: ``mcl.run`` (attribute
``sharded``) over ``mcl.loop`` (CUDA events on the rank's card) over
``mcl.iteration``, each with ``expand``, ``sort``, ``merge``,
``exchange`` (attribute ``kind``: "merge" or "reshard"; CUDA events:
the bucket fill and the all_to_all) and ``allreduce`` (the column
sums); ``fetch`` (a root after ``mcl.run``) around the gather of the
final flow. Counters on each rank: ``mcl.runs``, ``mcl.wide_runs``,
``mcl.fallbacks``, ``mcl.rank_products`` (the rank's products of the
live iterations), ``mcl.exchange_bytes_sent`` and
``mcl.exchange_bytes_received`` (the all_to_alls' bytes between ranks,
padded buckets included, the rank's chunk to itself left out).

:class:`ShardedMcl` keeps a world of ranks alive (``shard.mesh.
LiveWorld``) and runs the loop of one flow on every call.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from outerspace_tpu_torch.formats.csr import CSR
from outerspace_tpu_torch.ops.kernels.compact import _pack, _sentinel, _ukey, _unpack, key_dtype
from outerspace_tpu_torch.ops.spgemm import (
    expand_partial_products,
    merge_biased_keys,
    merge_epilogue,
)
from outerspace_tpu_torch.ops.symbolic import round_up_bucket
from outerspace_tpu_torch.perf.timer import count, span
from outerspace_tpu_torch.shard.spgemm_sharded import _slice_fill_buckets, exchange
from outerspace_tpu_torch.shard.tiled import _rank_axes

HEADROOM = 1.25  # the budgets' margin over the host recurrence's maxima
CONV_TOL = 1e-6  # ops.graph._converged's
# the budgets ``ok`` checks, in the order of the flags' failure bits
BUDGETS = ("p_pad", "cap", "nb", "ecap")
_STATS = ("p_dev", "cap", "ecap", "nnz_b", "max_row")


@dataclasses.dataclass
class ShardedMclPlan:
    """Static budgets of the device loop and its initial flow.

    A rank stages its own shard (:meth:`shard`); the stacked
    ``[kx, ny, ...]`` arrays of every rank (``flow_k``, ``flow_v``,
    ``a_rows``, ``a_k``, ``a_vals``) are made only when asked for."""

    m: int
    kx: int
    ny: int
    rows_per_x: int
    cols_per_y: int
    iters: int
    inflation: float
    threshold: float
    p_pad: int  # per-rank expansion stream
    cap: int  # per-(src, dst) merge-exchange bucket
    ecap: int  # per-(src, dst) CSC re-shard bucket
    nb: int  # per-rank flow (B side, CSR) buffer
    na: int  # per-rank A side (CSC) buffer = ny·kx·ecap
    max_run: int
    flow0: CSR = dataclasses.field(repr=False, compare=False)

    @property
    def key_dtype(self) -> torch.dtype:
        return key_dtype(self.m)

    def shard(self, i: int, j: int) -> tuple:
        """Rank (i, j)'s initial state: its flow keys (local-row keys
        ``(row − row_lo)·m + col``, sorted, sentinel-padded to ``nb``)
        and values, and its A side (the flow's columns in x-range i, in
        CSC order: global rows, sentinel m on padding; local k; values,
        padded to ``na``)."""
        m, kdt = self.m, self.key_dtype
        lo, hi = min(i * self.rows_per_x, m), min((i + 1) * self.rows_per_x, m)
        ptr = np.asarray(self.flow0.indptr, dtype=np.int64)
        idx = np.asarray(self.flow0.indices, dtype=np.int64)
        val = np.asarray(self.flow0.data, dtype=np.float32)
        # B side: rows in x-range i, columns in y-range j
        e0, e1 = ptr[lo], ptr[hi]
        row = np.repeat(np.arange(lo, hi, dtype=np.int64), np.diff(ptr[lo:hi + 1]))
        col, v = idx[e0:e1], val[e0:e1]
        sel = np.minimum(col // self.cols_per_y, self.ny - 1) == j
        ukey = (row[sel] - lo) * m + col[sel]
        if ukey.shape[0] > self.nb:
            raise ValueError("initial flow exceeds the nb budget")
        order = np.argsort(ukey, kind="stable")
        key = ukey[order] - 2**31 if kdt == torch.int32 else ukey[order]
        flow_k = np.full(self.nb, _sentinel(kdt), np.int32 if kdt == torch.int32 else np.int64)
        flow_k[:key.shape[0]] = key
        flow_v = np.zeros(self.nb, np.float32)
        flow_v[:key.shape[0]] = v[sel][order]
        # A side: columns in x-range i (y-replicated), CSC order
        all_rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ptr))
        sela = np.minimum(idx // self.rows_per_x, self.kx - 1) == i
        ra, ca = all_rows[sela], idx[sela] - i * self.rows_per_x
        if ra.shape[0] > self.na:
            raise ValueError("initial flow exceeds the na budget")
        orda = np.lexsort((ra, ca))
        a_rows = np.full(self.na, m, np.int32)
        a_k = np.zeros(self.na, np.int32)
        a_vals = np.zeros(self.na, np.float32)
        a_rows[:ra.shape[0]] = ra[orda]
        a_k[:ra.shape[0]] = ca[orda]
        a_vals[:ra.shape[0]] = val[sela][orda]
        return flow_k, flow_v, a_rows, a_k, a_vals

    @functools.cached_property
    def _stacked(self) -> tuple:
        shards = [[self.shard(i, j) for j in range(self.ny)] for i in range(self.kx)]
        return tuple(np.stack([np.stack([s[f] for s in row]) for row in shards]) for f in range(5))

    flow_k = property(lambda self: self._stacked[0])
    flow_v = property(lambda self: self._stacked[1])
    a_rows = property(lambda self: self._stacked[2])
    a_k = property(lambda self: self._stacked[3])
    a_vals = property(lambda self: self._stacked[4])


def _owners(x: np.ndarray, per: int, parts: int) -> np.ndarray:
    return np.minimum(x // per, parts - 1)


def _flow_counts(row, col, kx, ny, rows_per_x, cols_per_y):
    """(per-(row owner, y) nnz, per-(row owner, y, column owner) re-shard
    counts) of a flow's entries."""
    ox_row, oy_col = _owners(row, rows_per_x, kx), _owners(col, cols_per_y, ny)
    ox_col = _owners(col, rows_per_x, kx)
    nbo = np.bincount(ox_row * ny + oy_col, minlength=kx * ny)
    ec = np.bincount((ox_row * ny + oy_col) * kx + ox_col, minlength=kx * ny * kx)
    return nbo, ec


def _sharded_mcl_sizing(f0, m: int, kx: int, ny: int, rows_per_x: int, cols_per_y: int,
                        inflation: float, iters: int, threshold: float):
    """Run the MCL recurrence on the host in scipy (exact index math) and
    take every static maximum the device loop needs: per-rank products,
    per-(src, dst) counts of both all_to_alls, per-rank flow nnz and the
    longest row. The flow nnz and the re-shard counts start from the
    initial flow's (the JAX package starts them at 1)."""
    import scipy.sparse as sp

    def entries(f):
        coo = f.tocoo()
        return coo.row.astype(np.int64), coo.col.astype(np.int64)

    f = f0.to_scipy().tocsr()
    nbo, ec = _flow_counts(*entries(f), kx, ny, rows_per_x, cols_per_y)
    stats = dict(p_dev=1, cap=1, ecap=max(1, int(ec.max(initial=0))),
                 nnz_b=max(1, int(nbo.max(initial=0))), max_row=1)
    for _ in range(iters):
        row, col = entries(f)
        ox_col, oy_col = _owners(col, rows_per_x, kx), _owners(col, cols_per_y, ny)
        ox_row = _owners(row, rows_per_x, kx)
        # per-(row k, y-range) nnz of f: the products of each element
        nr2 = np.bincount(row * ny + oy_col, minlength=m * ny).reshape(m, ny)
        per = nr2[col, :].astype(np.float64)  # exact: counts stay far below 2^53
        for j in range(ny):
            # products per (i, j): the A elements (r, k = col) with k in x-range i;
            # merge-exchange counts per (src i, dst o, j)
            pd = np.bincount(ox_col, weights=per[:, j], minlength=kx)
            ex = np.bincount(ox_col * kx + ox_row, weights=per[:, j], minlength=kx * kx)
            stats["p_dev"] = max(stats["p_dev"], int(pd.max(initial=0)))
            stats["cap"] = max(stats["cap"], int(ex.max(initial=0)))
        stats["max_row"] = max(stats["max_row"], int(np.diff(f.indptr).max(initial=1)))
        del per, nr2
        # the recurrence (ops.graph._mcl_inflate_prune's semantics)
        c = (f @ f).tocoo()
        v = np.power(np.maximum(c.data, 0.0), inflation)
        keep = v > threshold
        c = sp.coo_matrix((v[keep], (c.row[keep], c.col[keep])), shape=(m, m)).tocsr()
        colsum = np.asarray(abs(c).sum(axis=0)).ravel()
        colsum[colsum == 0] = 1.0
        f = (c @ sp.diags(1.0 / colsum)).tocsr()
        nbo, ec = _flow_counts(*entries(f), kx, ny, rows_per_x, cols_per_y)
        stats["nnz_b"] = max(stats["nnz_b"], int(nbo.max(initial=0)))
        stats["ecap"] = max(stats["ecap"], int(ec.max(initial=0)))
    return stats


def _sizing(flow0: CSR, m, kx, ny, rows_per_x, cols_per_y, inflation, iters, threshold) -> dict:
    """The recurrence's maxima from the sizing cache, else from
    :func:`_sharded_mcl_sizing`, stored in the cache. The key is the
    flow's structure and (kx, ny, inflation, iters, threshold)."""
    from outerspace_tpu_torch.sched import sizing_cache

    key = sizing_cache.workload_key(
        (np.asarray(flow0.indptr), np.asarray(flow0.indices)),
        ("mcl-sharded-torch", m, kx, ny, float(inflation), int(iters), float(threshold)))
    got = sizing_cache.lookup(key) or {}
    if all(isinstance(got.get(k), int) and got[k] >= 1 for k in _STATS):
        return {k: got[k] for k in _STATS}
    stats = _sharded_mcl_sizing(flow0, m, kx, ny, rows_per_x, cols_per_y, inflation, iters,
                                threshold)
    sizing_cache.store(key, stats)
    return stats


def _pad(x: int, granule: int = 1024) -> int:
    return round_up_bucket(int(np.ceil(x * HEADROOM)) + 64, min_size=granule)


def plan_mcl_sharded_device(flow0: CSR, kx: int, ny: int = 1, inflation: float = 2.0,
                            iters: int = 10, prune_threshold: float = 1e-4,
                            mesh=None) -> ShardedMclPlan:
    """The host stage: the sizing (once per flow and mesh, then from the
    sizing cache) and the budgets, each maximum with :data:`HEADROOM`
    and 64 slots more, on the ``round_up_bucket`` grid. Called by every
    rank of ``mesh``, rank 0 sizes and broadcasts the maxima, so no
    other rank runs the recurrence."""
    m = flow0.shape[0]
    if flow0.shape[0] != flow0.shape[1]:
        raise ValueError("MCL flow must be square")
    if not 0 < m < 2**31:
        raise ValueError(f"device MCL loop needs 0 < m < 2^31, got m = {m}")
    rows_per_x = -(-m // kx)
    cols_per_y = -(-m // ny)
    args = (flow0, m, kx, ny, rows_per_x, cols_per_y, inflation, iters, prune_threshold)
    if mesh is None:
        stats = _sizing(*args)
    else:
        import torch.distributed as dist

        box = [_sizing(*args) if mesh.rank == 0 else None]
        dist.broadcast_object_list(box, src=0,
                                   device=mesh.device if mesh.backend == "nccl" else None)
        stats = box[0]
    p_pad = _pad(stats["p_dev"], 4096)
    cap = _pad(stats["cap"])
    ecap = _pad(stats["ecap"])
    # a rank's flow nnz ≤ all it received, kx·cap, and the new flow is a
    # slice of the merged stream: nb never needs more (with self loops a
    # squaring keeps every entry of its operand, so the initial flow fits)
    nb = min(_pad(stats["nnz_b"]), kx * cap)
    na = ny * kx * ecap
    max_run = 1 << (max(stats["max_row"], 1) - 1).bit_length()
    return ShardedMclPlan(
        m=m, kx=kx, ny=ny, rows_per_x=rows_per_x, cols_per_y=cols_per_y, iters=iters,
        inflation=float(inflation), threshold=float(prune_threshold), p_pad=p_pad, cap=cap,
        ecap=ecap, nb=nb, na=na, max_run=max_run, flow0=flow0,
    )


def _owner_bounds(plan: ShardedMclPlan, device) -> torch.Tensor:
    """The keys of the owners' first rows, ``row_start·m`` (packed as the
    plan's keys), and the end: the merge exchange's bounds in the
    (row·m + col) key space and the re-shard's in the (col·m + row) one
    (the same arithmetic: k-partition == row ownership)."""
    starts = torch.from_numpy(
        np.minimum(np.arange(plan.kx + 1, dtype=np.int64) * plan.rows_per_x, plan.m))
    return _pack(starts, torch.zeros_like(starts), plan.m, plan.key_dtype).to(device)


@dataclasses.dataclass
class ShardedMclProgram:
    """One rank's device loop for ``plan`` on ``mesh``, its initial state
    staged on ``mesh.device``; :meth:`run` returns ``(flow, flags)``
    without reading the device: ``flow`` int32, the rank's sorted
    local-row keys (two int32 words each when they are int64) then its
    values' bits, and ``flags`` int64[5 + iters]: iterations run,
    converged, ok, the flow's nnz over every rank, the bits of the
    budgets that failed (:data:`BUDGETS`), then the rank's products of
    each live iteration (0 once the loop has stopped)."""

    plan: ShardedMclPlan
    mesh: object
    ax: str
    ay: str | None
    state: tuple
    bounds: torch.Tensor

    @property
    def all_axes(self):
        return (self.ax,) if self.ay is None else (self.ax, self.ay)

    @property
    def sentinel(self) -> int:
        return _sentinel(self.plan.key_dtype)

    def run(self):
        plan, dev = self.plan, self.mesh.device
        it = torch.zeros((), dtype=torch.int64, device=dev)
        conv = torch.zeros((), dtype=torch.bool, device=dev)
        ok = torch.ones((), dtype=torch.bool, device=dev)
        failed = torch.zeros((), dtype=torch.int64, device=dev)
        products = []
        state = self.state
        with span("mcl.loop", dev, inherit=False):
            for t in range(plan.iters):
                with span("mcl.iteration", iteration=t):
                    live = ~conv & ok
                    new_conv, new_ok, new_failed, p_total, new_state = self._body(*state)
                    state = tuple(torch.where(live, n, o) for n, o in zip(new_state, state))
                    conv = torch.where(live, new_conv, conv)
                    ok = torch.where(live, new_ok, ok)
                    failed = torch.where(live, new_failed, failed)
                    products.append(torch.where(live, p_total.to(torch.int64), 0))
                    it = it + live.to(torch.int64)
        fk, fv = state[:2]
        nnz = self.mesh.psum((fk != self.sentinel).sum(), self.all_axes)
        flags = torch.stack([it, conv.to(torch.int64), ok.to(torch.int64), nnz.to(torch.int64),
                             failed, *products])
        return torch.cat([fk.view(torch.int32), fv.view(torch.int32)]), flags

    def _exchange(self, kind: str, pos, cap: int, *streams):
        """Each owner's run of the sorted ``streams`` ((tensor, dead
        value) pairs; owner d's run starts at ``pos[d]``) filled into a
        bucket of ``cap`` slots and sent to its owner along x in one
        all_to_all: an ``exchange`` span over the fill and the
        all_to_all, its bytes counted."""
        kx = self.plan.kx
        with span("exchange", self.mesh.device, kind=kind):
            buckets = _slice_fill_buckets(pos[:-1], torch.minimum(pos[1:], pos[:-1] + cap), cap,
                                          kx, *streams)
            out = exchange(self.mesh, self.ax, *buckets)
        row_bytes = sum(b[0].numel() * b.element_size() for b in buckets)
        count("mcl.exchange_bytes_sent", (kx - 1) * row_bytes)
        count("mcl.exchange_bytes_received", (kx - 1) * row_bytes)
        return out

    def _body(self, flow_k, flow_v, a_rows, a_k, a_vals):
        """One iteration: (converged, ok, failed budgets' bits, the rank's
        products, the new state). Every rank runs the same collectives
        in the same order, live or not."""
        plan, mesh = self.plan, self.mesh
        m, kx, dev = plan.m, plan.kx, mesh.device
        kdt, sent = plan.key_dtype, self.sentinel
        row_lo = mesh.index(self.ax) * plan.rows_per_x
        with span("expand"):
            # offsets from the flow's row counts, on the device
            valid_a = a_rows < m
            valid_b = flow_k != sent
            b_row, b_col = _unpack(flow_k, m)
            b_counts = torch.zeros(plan.rows_per_x, dtype=torch.int32, device=dev)
            b_counts.index_add_(0, torch.where(valid_b, b_row, 0).long(),
                                valid_b.to(torch.int32))
            zero = torch.zeros(1, dtype=torch.int32, device=dev)
            b_indptr = torch.cat([zero, torch.cumsum(b_counts, 0, dtype=torch.int32)])
            b_vals = torch.where(valid_b, flow_v, 0.0)
            ak = a_k.long()
            deg = torch.where(valid_a, b_indptr[ak + 1] - b_indptr[ak], 0)
            offsets = torch.cat([zero, torch.cumsum(deg, 0, dtype=torch.int32)])
            p_total = offsets[-1]
            p_ok = p_total <= plan.p_pad
            r, c, v = expand_partial_products(
                torch.where(valid_a, a_rows, m), torch.where(valid_a, a_vals, 0.0), a_k,
                b_indptr, b_col, b_vals, offsets, p_total, plan.p_pad, m)
            live = torch.arange(plan.p_pad, device=dev) < p_total
            key = torch.where(live, _pack(r, c, m, kdt), sent)
            del r, c, live
        with span("sort"):
            key, order = torch.sort(key)
            v = v[order]
            del order
        # ---- exchange to the output rows' owners
        bpos = torch.searchsorted(key, self.bounds)
        cap_ok = torch.all(bpos[1:] - bpos[:-1] <= plan.cap)
        rk, rv = self._exchange("merge", bpos, plan.cap, (key, sent), (v, 0.0))
        del key, v
        # ---- merge. No real key is the sentinel (m² < 2³², or int64
        # keys): every sentinel slot is padding, and the buffer's length
        # bounds their count without a host read (the JAX loop counts
        # them on the device)
        pad = rk.numel()
        if kx == 1:  # one sender: the received buffer is already sorted
            mr, mc, mv, mvalid, _ = merge_epilogue(rk, rv, m, m, pad_count=pad)
        else:
            mr, mc, mv, mvalid, _ = merge_biased_keys(rk, rv, m, m, pad_count=pad)
        del rk, rv
        # ---- inflate / prune / normalise the columns
        pw = torch.pow(torch.clamp(mv, min=0.0), plan.inflation)
        keep = mvalid & (pw > plan.threshold)
        colsum = torch.zeros(m, dtype=torch.float32, device=dev)
        # a dropped slot adds 0 to a column of its own lane's choosing, not
        # all to one: millions of atomic adds on one address serialise
        lane = torch.arange(mc.numel(), device=dev) % m
        colsum.index_add_(0, torch.where(keep, mc.long(), lane), torch.where(keep, pw.abs(), 0.0))
        del lane
        with span("allreduce"):
            colsum = mesh.psum(colsum, self.ax)
        colsum = torch.where(colsum == 0.0, 1.0, colsum)
        nv = torch.where(keep, pw / colsum[mc.long()], 0.0)
        # ---- the new flow, row-sharded, local-row keys, sorted
        nk = torch.where(keep, _pack(mr - row_lo, mc, m, kdt), sent)
        del mr, mc, mv, mvalid, pw, keep
        with span("sort"):
            nk, order = torch.sort(nk)
            nv = nv[order]
        nb_ok = (nk != sent).sum() <= plan.nb
        new_k, new_v = nk[:plan.nb], nv[:plan.nb]
        local_conv = torch.all(new_k == flow_k) & ((new_v - flow_v).abs().max() <= CONV_TOL)
        # ---- re-shard the A side for the next iteration: (col·m + global
        # row) keys, the same packed space column-major
        n_row, n_col = _unpack(nk, m)
        ck = torch.where(nk != sent, _pack(n_col, n_row + row_lo, m, kdt), sent)
        del n_row, n_col
        with span("sort"):
            ck, order = torch.sort(ck)
            cv = nv[order]
        cpos = torch.searchsorted(ck, self.bounds)
        ecap_ok = torch.all(cpos[1:] - cpos[:-1] <= plan.ecap)
        # one all-reduce over the mesh for the votes
        votes = self.mesh.psum(torch.stack([local_conv, p_ok, cap_ok, nb_ok, ecap_ok])
                               .to(torch.int32), self.all_axes)
        n_dev = kx * plan.ny
        conv = votes[0] == n_dev
        budget_ok = votes[1:] == n_dev
        ok_all = torch.all(budget_ok)
        failed = ((~budget_ok).to(torch.int64)
                  * (2 ** torch.arange(len(BUDGETS), device=dev))).sum()
        ak2, av2 = self._exchange("reshard", cpos, plan.ecap, (ck, sent), (cv, 0.0))
        if self.ay is not None:
            ak2 = mesh.all_gather(ak2, self.ay).reshape(-1)
            av2 = mesh.all_gather(av2, self.ay).reshape(-1)
        with span("sort"):
            ak2, order = torch.sort(ak2)
            av2 = av2[order]
        a_valid = ak2 != sent
        col_g, row_g = _unpack(ak2, m)
        new_state = (
            new_k, new_v,
            torch.where(a_valid, row_g, m),
            torch.where(a_valid, col_g - row_lo, 0),
            torch.where(a_valid, av2, 0.0),
        )
        return conv, ok_all, failed, p_total, new_state


def build_mcl_sharded_device(plan: ShardedMclPlan, mesh, axes=("x", "y")) -> ShardedMclProgram:
    """This rank's device loop, its shard of the initial state staged on
    ``mesh.device``."""
    ax, i, j = _rank_axes(plan, mesh, axes)
    ay = axes[1] if plan.ny > 1 else None
    state = tuple(torch.from_numpy(x).to(mesh.device) for x in plan.shard(i, j))
    return ShardedMclProgram(plan, mesh, ax, ay, state, _owner_bounds(plan, mesh.device))


def gather_flow(prog: ShardedMclProgram, flow, nnz: int, host: bool = True) -> CSR | None:
    """The rank's ``flow`` (from :meth:`ShardedMclProgram.run`) gathered
    from every rank of the mesh (one all_gather); with ``host``, the
    whole flow's ``nnz`` entries (the flags' count) put in order on the
    device and copied to this rank's host as a CSR, else None."""
    plan = prog.plan
    both = prog.mesh.all_gather(flow, prog.all_axes)  # [ranks, words]
    if not host:
        return None
    kdt, m, dev = plan.key_dtype, plan.m, both.device
    words = plan.nb * (2 if kdt == torch.int64 else 1)
    keys = both[:, :words].contiguous().view(kdt)
    vals = both[:, words:].contiguous().view(torch.float32).reshape(-1)
    # global unsigned keys row·m + col: rank (i, j) holds rows from i·rows_per_x
    x_index = torch.arange(keys.shape[0], device=dev) // plan.ny
    gkey = _ukey(keys) + (x_index * plan.rows_per_x * m)[:, None]
    gkey = torch.where(keys != prog.sentinel, gkey, 2**63 - 1).reshape(-1)
    gkey, order = torch.sort(gkey)
    gkey, vals = gkey[:nnz], vals[order[:nnz]]
    cols = (gkey % m).to(torch.int32)
    indptr = torch.searchsorted(gkey, torch.arange(m + 1, device=dev) * m).to(torch.int32)
    parts = (indptr, cols, vals)
    if dev.type == "cuda":
        pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in parts]
        for h, t in zip(pinned, parts):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        parts = pinned
    return CSR((m, m), *(t.numpy() for t in parts))


def markov_cluster_sharded_device(
    adj,
    mesh,
    axes: tuple[str, str] | str = ("x", "y"),
    kx: int | None = None,
    ny: int = 1,
    inflation: float = 2.0,
    iters: int = 10,
    prune_threshold: float = 1e-4,
    report: dict | None = None,
) -> CSR:
    """MCL with the whole loop resident on the mesh's devices: the host
    sizes the buffers once before (rank 0, or the sizing cache), and
    reads the device twice after (the loop's flags, then the final
    flow); no host planning between iterations. Every rank of the mesh
    calls it and gets the final flow as a host CSR.

    If a budget failed (the device ``ok`` flag), it returns the exact
    host-planned loop's flow, as the JAX package does (see
    :func:`run_to_csr`, whose ``report`` this is)."""
    from outerspace_tpu_torch.formats.coo import COO
    from outerspace_tpu_torch.ops.graph import _mcl_setup, _resolve_mesh_dims

    coo = adj if isinstance(adj, COO) else adj.to_coo()
    kx, ny = _resolve_mesh_dims(mesh, kx, ny)
    plan = plan_mcl_sharded_device(_mcl_setup(coo), kx=kx, ny=ny, inflation=inflation,
                                   iters=iters, prune_threshold=prune_threshold, mesh=mesh)
    return run_to_csr(build_mcl_sharded_device(plan, mesh, axes), report)


def run_to_csr(prog: ShardedMclProgram, report: dict | None = None, *,
               host: bool = True) -> CSR | None:
    """Run ``prog``, read its flags, and return the final flow gathered
    from every rank (None where ``host`` is false: the rank joins the
    gather and keeps nothing), or, if a budget failed, the exact
    host-planned loop's (``ops.graph.markov_cluster_sharded_flow``) from
    the plan's initial flow. ``report`` receives ``fast_path`` (the
    device loop's result was used), ``iterations`` (bodies that ran
    live), ``converged``, ``failed_budgets`` (:data:`BUDGETS` that did
    not hold), ``products`` (the rank's, per live iteration),
    ``host_reads`` (reads of the device by this function: 2 on the fast
    path; collectives staged through host memory under gloo on a card
    are not counted), the budgets, and on the fallback its own report.
    Every rank of the mesh calls it."""
    plan = prog.plan
    wide = plan.key_dtype == torch.int64
    count("mcl.runs")
    if wide:
        count("mcl.wide_runs")
    with span("mcl.run", sharded=True):
        flow, flags = prog.run()
        it, conv, ok, nnz, failed, *products = flags.tolist()
        products = products[:it]
        count("mcl.rank_products", sum(products))
        info = dict(fast_path=bool(ok), iterations=it, converged=bool(conv),
                    failed_budgets=[b for k, b in enumerate(BUDGETS) if failed >> k & 1],
                    products=products, host_reads=1, wide=wide, p_pad=plan.p_pad, cap=plan.cap,
                    ecap=plan.ecap, nb=plan.nb, na=plan.na)
        out = None
        if not ok:
            from outerspace_tpu_torch.ops.graph import markov_cluster_sharded_flow

            count("mcl.fallbacks")
            fallback: dict = {}
            axes = (prog.ax, prog.ay) if prog.ay is not None else prog.ax
            with span("mcl.fallback"):
                out = markov_cluster_sharded_flow(
                    plan.flow0, prog.mesh, axes=axes, kx=plan.kx, ny=plan.ny,
                    inflation=plan.inflation, iters=plan.iters, prune_threshold=plan.threshold,
                    report=fallback)
            info["fallback"] = fallback
    if ok:
        with span("fetch"):
            out = gather_flow(prog, flow, nnz, host)
        info["host_reads"] += host
    if report is not None:
        report.update(info)
    return out if host else None


def _rank_program(plan: ShardedMclPlan, device=None) -> ShardedMclProgram:
    """This rank's program on the plan's mesh, (kx,) along "x" or
    (kx, ny) along ("x", "y"), made (collectively) over the default
    process group."""
    from outerspace_tpu_torch.shard.mesh import make_mesh

    if plan.ny == 1:
        return build_mcl_sharded_device(plan, make_mesh((plan.kx,), ("x",), device=device), "x")
    mesh = make_mesh((plan.kx, plan.ny), ("x", "y"), device=device)
    return build_mcl_sharded_device(plan, mesh, ("x", "y"))


def _rank_step(plan: ShardedMclPlan):
    """A spawned rank of :class:`ShardedMcl`: its program, and the step
    that runs the loop once (the rank keeps no flow) and returns the
    rank's report (:func:`_rank_report`)."""
    prog = _rank_program(plan)

    def step():
        report: dict = {}
        run_to_csr(prog, report, host=False)
        return _rank_report(prog, report)

    return step


def _rank_report(prog: ShardedMclProgram, report: dict) -> dict:
    """What a rank of :class:`ShardedMcl` reports after a call: the run's
    report, the device's memory peak and the rank's counters."""
    from outerspace_tpu_torch.perf.timer import counters

    dev = prog.mesh.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return {**report, "rank": prog.mesh.rank, "memory_peak_bytes": int(peak),
            "counters": counters()}


class ShardedMcl:
    """Markov clustering of one flow over a mesh of ranks kept alive
    across calls (``shard.mesh.LiveWorld``), the plan's (kx,) or
    (kx, ny) mesh: this process is rank 0, on card 0 (or the CPU), the
    others are spawned, each stages its shard of ``plan`` once. Each
    call runs the device loop on every rank (:func:`run_to_csr`) and
    returns the final flow as a host CSR;
    :attr:`reports` holds every rank's report of the last call (its
    run's report, memory peak and counters). :meth:`close` stops the
    ranks.

    ``plan`` comes from :func:`plan_mcl_sharded_device` in this process,
    before any rank is spawned, so a plan that raises leaves no world
    behind."""

    def __init__(self, plan: ShardedMclPlan, *, backend: str = "nccl", device: str = "cuda"):
        from outerspace_tpu_torch.shard.mesh import LiveWorld

        if torch.device(device).type == "cuda":
            from outerspace_tpu_torch.runtime import build

            build.build()  # once here, so that the spawned ranks run no nvcc
        self.world = LiveWorld(plan.kx * plan.ny, _rank_step, (plan,), backend=backend,
                               device=device)
        try:
            self.prog = _rank_program(plan, self.world.device)
            self.world.ready()
        except BaseException:
            self.world.close()
            raise
        self.reports: list[dict] = []

    def __call__(self) -> CSR:
        report: dict = {}
        out, others = self.world.call(lambda: run_to_csr(self.prog, report))
        self.reports = [_rank_report(self.prog, report), *others]
        return out

    def close(self) -> None:
        self.prog = None
        self.world.close()
