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

Every static size comes from one host scipy recurrence before the loop
(:func:`_sharded_mcl_sizing`); a device ``ok`` flag guards the budgets.
JAX's ``lax.while_loop`` stops on the device once the flow converges or
a budget fails; here the loop runs ``iters`` bodies and each body's
carry is taken only where the loop is still live (``torch.where``, so a
converged or failed state stays frozen), and ``(iterations, converged,
ok)`` is read once at the end: the results are the while loop's. If a
budget failed, :func:`markov_cluster_sharded_device` falls back to the
exact host-planned loop, and its ``report`` says so.

The sizing also counts the initial flow (the JAX package sizes the flow
buffer and the re-shard bucket from the iterations' flows only, and
refuses a dense adjacency whose initial flow exceeds them).

k-partition == output-row ownership (uniform ``rows_per_x``), so the
B side of the next iteration is exactly the merge output. Requires the
graph regime m² < 2³² (packed keys) and an expansion of 2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from outerspace_tpu_torch.formats.coo import COO
from outerspace_tpu_torch.formats.csr import CSR
from outerspace_tpu_torch.ops.spgemm import (
    I32_MAX,
    expand_partial_products,
    merge_biased_keys,
    merge_epilogue,
    pack_key_biased,
    unpack_key_biased,
)
from outerspace_tpu_torch.ops.symbolic import round_up_bucket
from outerspace_tpu_torch.shard.spgemm_sharded import _slice_fill_buckets, exchange
from outerspace_tpu_torch.shard.tiled import _rank_axes

HEADROOM = 1.25  # the budgets' margin over the host recurrence's maxima
CONV_TOL = 1e-6  # ops.graph._converged's


@dataclasses.dataclass
class ShardedMclPlan:
    """Static budgets and the staged initial state of the device loop."""

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
    # the staged [kx, ny, ...] initial state:
    flow_k: np.ndarray  # int32: biased (local_row·m + col) keys, sorted
    flow_v: np.ndarray  # f32
    a_rows: np.ndarray  # int32: global rows, sentinel m on padding
    a_k: np.ndarray  # int32: the local outer index (col − k_lo)
    a_vals: np.ndarray  # f32


def _flow_counts(coo, kx, ny, rows_per_x, cols_per_y):
    """(per-(row owner, y) nnz, per-(row owner, y, column owner) re-shard
    counts) of a flow."""
    ox_row = np.minimum(coo.row // rows_per_x, kx - 1)
    oy_col = np.minimum(coo.col // cols_per_y, ny - 1)
    ox_col = np.minimum(coo.col // rows_per_x, kx - 1)
    nbo = np.zeros((kx, ny), dtype=np.int64)
    np.add.at(nbo, (ox_row, oy_col), 1)
    ec = np.zeros((kx, ny, kx), dtype=np.int64)
    np.add.at(ec, (ox_row, oy_col, ox_col), 1)
    return nbo, ec


def _sharded_mcl_sizing(f0, m: int, kx: int, ny: int, rows_per_x: int, cols_per_y: int,
                        inflation: float, iters: int, threshold: float):
    """Run the MCL recurrence on the host in scipy (exact index math) and
    take every static maximum the device loop needs: per-rank products,
    per-(src, dst) counts of both all_to_alls, per-rank flow nnz and the
    longest row. The flow nnz and the re-shard counts start from the
    initial flow's (the JAX package starts them at 1)."""
    import scipy.sparse as sp

    f = f0.to_scipy().tocsr()
    nbo, ec = _flow_counts(f.tocoo(), kx, ny, rows_per_x, cols_per_y)
    stats = dict(p_dev=1, cap=1, ecap=max(1, int(ec.max(initial=0))),
                 nnz_b=max(1, int(nbo.max(initial=0))), max_row=1)
    for _ in range(iters):
        coo = f.tocoo()
        ox_col = np.minimum(coo.col // rows_per_x, kx - 1)
        oy_col = np.minimum(coo.col // cols_per_y, ny - 1)
        ox_row = np.minimum(coo.row // rows_per_x, kx - 1)
        # per-(row k, y-range) nnz of f: the products of each element
        nr2 = np.zeros((m, ny), dtype=np.int64)
        np.add.at(nr2, (coo.row, oy_col), 1)
        # products per (i, j): the A elements (r, k = col) with k in x-range i
        pd = np.zeros((kx, ny), dtype=np.int64)
        np.add.at(pd, ox_col, nr2[coo.col, :])
        # merge-exchange counts per (src i, dst o, j)
        ex = np.zeros((kx, kx, ny), dtype=np.int64)
        np.add.at(ex, (ox_col, ox_row), nr2[coo.col, :])
        stats["p_dev"] = max(stats["p_dev"], int(pd.max(initial=0)))
        stats["cap"] = max(stats["cap"], int(ex.max(initial=0)))
        stats["max_row"] = max(stats["max_row"], int(np.diff(f.indptr).max(initial=1)))
        # the recurrence (ops.graph._mcl_inflate_prune's semantics)
        c = (f @ f).tocoo()
        v = np.power(np.maximum(c.data, 0.0), inflation)
        keep = v > threshold
        c = sp.coo_matrix((v[keep], (c.row[keep], c.col[keep])), shape=(m, m)).tocsr()
        colsum = np.asarray(abs(c).sum(axis=0)).ravel()
        colsum[colsum == 0] = 1.0
        f = (c @ sp.diags(1.0 / colsum)).tocsr()
        nbo, ec = _flow_counts(f.tocoo(), kx, ny, rows_per_x, cols_per_y)
        stats["nnz_b"] = max(stats["nnz_b"], int(nbo.max(initial=0)))
        stats["ecap"] = max(stats["ecap"], int(ec.max(initial=0)))
    return stats


def _pad(x: int, granule: int = 1024) -> int:
    return round_up_bucket(int(np.ceil(x * HEADROOM)) + 64, min_size=granule)


def plan_mcl_sharded_device(flow0: CSR, kx: int, ny: int = 1, inflation: float = 2.0,
                            iters: int = 10, prune_threshold: float = 1e-4) -> ShardedMclPlan:
    """The host stage: one sizing recurrence, the budgets (each maximum
    with :data:`HEADROOM` and 64 slots more, on the ``round_up_bucket``
    grid) and the initial state staged per rank."""
    m = flow0.shape[0]
    if flow0.shape[0] != flow0.shape[1]:
        raise ValueError("MCL flow must be square")
    if m * m >= 2**32:
        raise ValueError("device MCL loop needs m^2 < 2^32 (packed keys)")
    rows_per_x = -(-m // kx)
    cols_per_y = -(-m // ny)
    stats = _sharded_mcl_sizing(flow0, m, kx, ny, rows_per_x, cols_per_y,
                                   inflation, iters, prune_threshold)
    p_pad = _pad(stats["p_dev"], 4096)
    cap = _pad(stats["cap"])
    ecap = _pad(stats["ecap"])
    # a rank's flow nnz ≤ all it received, kx·cap, and the new flow is a
    # slice of the merged stream: nb never needs more (with self loops a
    # squaring keeps every entry of its operand, so the initial flow fits)
    nb = min(_pad(stats["nnz_b"]), kx * cap)
    na = ny * kx * ecap
    max_run = 1 << (max(stats["max_row"], 1) - 1).bit_length()

    coo = flow0.to_coo()
    row = coo.row.astype(np.int64)
    col = coo.col.astype(np.int64)
    ox_row = np.minimum(row // rows_per_x, kx - 1)
    oy_col = np.minimum(col // cols_per_y, ny - 1)
    ox_col = np.minimum(col // rows_per_x, kx - 1)
    flow_k = np.full((kx, ny, nb), I32_MAX, np.int32)
    flow_v = np.zeros((kx, ny, nb), np.float32)
    a_rows = np.full((kx, ny, na), m, np.int32)
    a_k = np.zeros((kx, ny, na), np.int32)
    a_vals = np.zeros((kx, ny, na), np.float32)
    for i in range(kx):
        for j in range(ny):
            # B side: rows in x-range i, columns in y-range j, local-row keys
            sel = (ox_row == i) & (oy_col == j)
            key = ((row[sel] - i * rows_per_x) * m + col[sel] - 2**31).astype(np.int32)
            order = np.argsort(key, kind="stable")
            if key.shape[0] > nb:
                raise ValueError("initial flow exceeds the nb budget")
            flow_k[i, j, :key.shape[0]] = key[order]
            flow_v[i, j, :key.shape[0]] = coo.val[sel][order]
            # A side: columns in x-range i (y-replicated), CSC order
            sela = ox_col == i
            ra = row[sela]
            ca = col[sela] - i * rows_per_x  # local k
            orda = np.lexsort((ra, ca))
            if ra.shape[0] > na:
                raise ValueError("initial flow exceeds the na budget")
            a_rows[i, j, :ra.shape[0]] = ra[orda]
            a_k[i, j, :ra.shape[0]] = ca[orda]
            a_vals[i, j, :ra.shape[0]] = coo.val[sela][orda]
    return ShardedMclPlan(
        m=m, kx=kx, ny=ny, rows_per_x=rows_per_x, cols_per_y=cols_per_y, iters=iters,
        inflation=float(inflation), threshold=float(prune_threshold), p_pad=p_pad, cap=cap,
        ecap=ecap, nb=nb, na=na, max_run=max_run, flow_k=flow_k, flow_v=flow_v,
        a_rows=a_rows, a_k=a_k, a_vals=a_vals,
    )


def _owner_bounds(plan: ShardedMclPlan, device) -> torch.Tensor:
    """The biased keys of the owners' first rows, ``row_start·m``, and the
    end: the merge exchange's bounds in the (row·m + col) key space and
    the re-shard's in the (col·m + row) one (the same arithmetic:
    k-partition == row ownership)."""
    starts = np.minimum(np.arange(plan.kx + 1, dtype=np.int64) * plan.rows_per_x, plan.m)
    return torch.from_numpy((starts * plan.m - 2**31).astype(np.int32)).to(device)


@dataclasses.dataclass
class ShardedMclProgram:
    """One rank's device loop for ``plan`` on ``mesh``, its initial state
    staged on ``mesh.device``; :meth:`run` returns ``(flow, flags)``
    without reading the device: ``flow`` int32[2, nb] (the rank's sorted
    local-row keys, then its values' bits) and ``flags`` int32[3]
    (iterations run, converged, ok)."""

    plan: ShardedMclPlan
    mesh: object
    ax: str
    ay: str | None
    state: tuple
    bounds: torch.Tensor

    @property
    def all_axes(self):
        return (self.ax,) if self.ay is None else (self.ax, self.ay)

    def run(self):
        plan = self.plan
        dev = self.mesh.device
        it = torch.zeros((), dtype=torch.int32, device=dev)
        conv = torch.zeros((), dtype=torch.bool, device=dev)
        ok = torch.ones((), dtype=torch.bool, device=dev)
        state = self.state
        for _ in range(plan.iters):
            live = ~conv & ok
            new_conv, new_ok, new_state = self._body(*state)
            state = tuple(torch.where(live, n, o) for n, o in zip(new_state, state))
            conv = torch.where(live, new_conv, conv)
            ok = torch.where(live, new_ok, ok)
            it = it + live.to(torch.int32)
        fk, fv = state[:2]
        flags = torch.stack([it, conv.to(torch.int32), ok.to(torch.int32)])
        return torch.stack([fk, fv.view(torch.int32)]), flags

    def _body(self, flow_k, flow_v, a_rows, a_k, a_vals):
        """One iteration: (converged, ok, the new state). Every rank runs
        the same collectives in the same order, live or not."""
        plan, mesh = self.plan, self.mesh
        m, kx, dev = plan.m, plan.kx, mesh.device
        row_lo = mesh.index(self.ax) * plan.rows_per_x
        # ---- expand: offsets from the flow's row counts, on the device
        valid_a = a_rows < m
        valid_b = flow_k != I32_MAX
        b_row, b_col = unpack_key_biased(flow_k, m)
        b_counts = torch.zeros(plan.rows_per_x, dtype=torch.int32, device=dev)
        b_counts.index_add_(0, torch.where(valid_b, b_row, 0).long(), valid_b.to(torch.int32))
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        b_indptr = torch.cat([zero, torch.cumsum(b_counts, 0, dtype=torch.int32)])
        b_vals = torch.where(valid_b, flow_v, 0.0)
        ak = a_k.long()
        deg = torch.where(valid_a, b_indptr[ak + 1] - b_indptr[ak], 0)
        offsets = torch.cat([zero, torch.cumsum(deg, 0, dtype=torch.int32)])
        p_total = offsets[-1]
        ok = p_total <= plan.p_pad
        r, c, v = expand_partial_products(
            torch.where(valid_a, a_rows, m), torch.where(valid_a, a_vals, 0.0), a_k, b_indptr,
            b_col, b_vals, offsets, p_total, plan.p_pad, m)
        live = torch.arange(plan.p_pad, device=dev) < p_total
        key = torch.where(live, pack_key_biased(r, c, m), I32_MAX)
        key, order = torch.sort(key)
        v = v[order]
        # ---- exchange to the output rows' owners
        bpos = torch.searchsorted(key, self.bounds)
        ok = ok & torch.all(bpos[1:] - bpos[:-1] <= plan.cap)
        sk, sv = _slice_fill_buckets(bpos[:-1], torch.minimum(bpos[1:], bpos[:-1] + plan.cap),
                                     plan.cap, kx, (key, I32_MAX), (v, 0.0))
        rk, rv = exchange(mesh, self.ax, sk, sv)
        # ---- merge. m² < 2³², so no real key is the sentinel: every
        # sentinel slot is padding, and the buffer's length bounds their
        # count without a host read (the JAX loop counts them on the device)
        pad = rk.numel()
        if kx == 1:  # one sender: the received buffer is already sorted
            mr, mc, mv, mvalid, _ = merge_epilogue(rk, rv, m, m, pad_count=pad)
        else:
            mr, mc, mv, mvalid, _ = merge_biased_keys(rk, rv, m, m, pad_count=pad)
        # ---- inflate / prune / normalise the columns
        pw = torch.pow(torch.clamp(mv, min=0.0), plan.inflation)
        keep = mvalid & (pw > plan.threshold)
        colsum = torch.zeros(m, dtype=torch.float32, device=dev)
        # a dropped slot adds 0 to a column of its own lane's choosing, not
        # all to one: millions of atomic adds on one address serialise
        lane = torch.arange(mc.numel(), device=dev) % m
        colsum.index_add_(0, torch.where(keep, mc.long(), lane), torch.where(keep, pw.abs(), 0.0))
        colsum = mesh.psum(colsum, self.ax)
        colsum = torch.where(colsum == 0.0, 1.0, colsum)
        nv = torch.where(keep, pw / colsum[mc.long()], 0.0)
        # ---- the new flow, row-sharded, local-row keys, sorted
        nk = torch.where(keep, pack_key_biased(mr - row_lo, mc, m), I32_MAX)
        nk, order = torch.sort(nk)
        nv = nv[order]
        ok = ok & ((nk != I32_MAX).sum() <= plan.nb)
        new_k, new_v = nk[:plan.nb], nv[:plan.nb]
        local_conv = torch.all(new_k == flow_k) & ((new_v - flow_v).abs().max() <= CONV_TOL)
        # ---- re-shard the A side for the next iteration: (col·m + global
        # row) keys, the same packed space column-major
        n_row, n_col = unpack_key_biased(nk, m)
        ck = torch.where(nk != I32_MAX, pack_key_biased(n_col, n_row + row_lo, m), I32_MAX)
        ck, order = torch.sort(ck)
        cv = nv[order]
        cpos = torch.searchsorted(ck, self.bounds)
        ok_csc = torch.all(cpos[1:] - cpos[:-1] <= plan.ecap)
        # one all-reduce over the mesh for the three votes
        votes = self.mesh.psum(torch.stack([local_conv, ok, ok_csc]).to(torch.int32),
                               self.all_axes)
        n_dev = kx * plan.ny
        conv = votes[0] == n_dev
        ok_all = (votes[1] == n_dev) & (votes[2] == n_dev)
        csk, csv = _slice_fill_buckets(cpos[:-1], torch.minimum(cpos[1:], cpos[:-1] + plan.ecap),
                                       plan.ecap, kx, (ck, I32_MAX), (cv, 0.0))
        ak2, av2 = exchange(mesh, self.ax, csk, csv)
        if self.ay is not None:
            ak2 = mesh.all_gather(ak2, self.ay).reshape(-1)
            av2 = mesh.all_gather(av2, self.ay).reshape(-1)
        ak2, order = torch.sort(ak2)
        av2 = av2[order]
        a_valid = ak2 != I32_MAX
        col_g, row_g = unpack_key_biased(ak2, m)
        new_state = (
            new_k, new_v,
            torch.where(a_valid, row_g, m),
            torch.where(a_valid, col_g - row_lo, 0),
            torch.where(a_valid, av2, 0.0),
        )
        return conv, ok_all, new_state


def build_mcl_sharded_device(plan: ShardedMclPlan, mesh, axes=("x", "y")) -> ShardedMclProgram:
    """This rank's device loop, its initial state staged on ``mesh.device``."""
    ax, i, j = _rank_axes(plan, mesh, axes)
    ay = axes[1] if plan.ny > 1 else None
    state = tuple(torch.from_numpy(np.ascontiguousarray(x[i, j])).to(mesh.device)
                  for x in (plan.flow_k, plan.flow_v, plan.a_rows, plan.a_k, plan.a_vals))
    return ShardedMclProgram(plan, mesh, ax, ay, state, _owner_bounds(plan, mesh.device))


def sharded_mcl_to_csr(plan: ShardedMclPlan, fk: np.ndarray, fv: np.ndarray) -> CSR:
    """Every rank's row-sharded local-key flow ([kx, ny, nb] keys and
    values, in mesh order) as one host CSR."""
    fk = np.asarray(fk).reshape(plan.kx, plan.ny, -1)
    fv = np.asarray(fv).reshape(plan.kx, plan.ny, -1)
    rows, cols, vals = [], [], []
    for i in range(plan.kx):
        for j in range(plan.ny):
            k = fk[i, j]
            sel = k != I32_MAX
            ku = k[sel].astype(np.int64) + 2**31
            rows.append(ku // plan.m + i * plan.rows_per_x)
            cols.append(ku % plan.m)
            vals.append(fv[i, j][sel])
    return COO((plan.m, plan.m), np.concatenate(rows), np.concatenate(cols),
               np.concatenate(vals)).to_csr()


def gather_flow(prog: ShardedMclProgram, flow) -> CSR:
    """The rank's ``flow`` (from :meth:`ShardedMclProgram.run`) gathered
    from every rank of the mesh and assembled on this rank's host: one
    all_gather and one copy to the host."""
    both = prog.mesh.all_gather(flow, prog.all_axes).cpu().numpy()  # [ranks, 2, nb]
    return sharded_mcl_to_csr(prog.plan, both[:, 0], both[:, 1].view(np.float32))


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
    sizes the buffers once before, and reads the device twice after (the
    loop's three flags, then the final flow); no host planning between
    iterations. Every rank of the mesh calls it and gets the final flow
    as a host CSR.

    If a budget failed (the device ``ok`` flag), it returns the exact
    host-planned :func:`ops.graph.markov_cluster_sharded`, as the JAX
    package does. ``report`` receives ``fast_path`` (the device loop's
    result was used), ``iterations`` (bodies that ran live),
    ``converged``, ``host_reads`` (reads of the device by this function:
    2 on the fast path; collectives staged through host memory under
    gloo on a card are not counted) and the budgets."""
    from outerspace_tpu_torch.ops.graph import _mcl_setup, _resolve_mesh_dims

    coo = adj if isinstance(adj, COO) else adj.to_coo()
    kx, ny = _resolve_mesh_dims(mesh, kx, ny)
    plan = plan_mcl_sharded_device(_mcl_setup(coo), kx=kx, ny=ny, inflation=inflation,
                                   iters=iters, prune_threshold=prune_threshold)
    return run_to_csr(build_mcl_sharded_device(plan, mesh, axes), adj, report)


def run_to_csr(prog: ShardedMclProgram, adj, report: dict | None = None) -> CSR:
    """Run ``prog``, read its flags, and return the final flow gathered
    from every rank, or, if a budget failed, the host-planned loop's
    on ``adj`` (see :func:`markov_cluster_sharded_device`)."""
    plan = prog.plan
    flow, flags = prog.run()
    it, conv, ok = flags.tolist()
    info = dict(fast_path=bool(ok), iterations=it, converged=bool(conv), host_reads=1,
                p_pad=plan.p_pad, cap=plan.cap, ecap=plan.ecap, nb=plan.nb, na=plan.na)
    if ok:
        out = gather_flow(prog, flow)
        info["host_reads"] += 1
    else:
        from outerspace_tpu_torch.ops.graph import markov_cluster_sharded

        fallback: dict = {}
        axes = (prog.ax, prog.ay) if prog.ay is not None else prog.ax
        out = markov_cluster_sharded(adj, prog.mesh, axes=axes, kx=plan.kx, ny=plan.ny,
                                     inflation=plan.inflation, iters=plan.iters,
                                     prune_threshold=plan.threshold, report=fallback)
        info["fallback"] = fallback
    if report is not None:
        report.update(info)
    return out
