"""Graph workloads on SpGEMM: the JAX package's ``ops/graph.py``,
triangle counting and Markov clustering.

Triangles: tri = Σᵢⱼ (A² ∘ A) / 6 for a symmetric 0/1 adjacency without
self-loops. Two routes on the card:

- **dense**: the adjacency scattered into an n_pad × n_pad int8 matrix on
  the card, multiplied block of rows by block of rows (``torch._int_mm``,
  int8 in, int32 out: exact for any count ≤ n), masked by the same block
  of A and summed in int64. A plain large matrix product outside any
  kernel, as the JAX package's ``jnp.dot`` is.
- **sparse**: the tiled SpGEMM pipeline (``plan_tiled`` →
  ``spgemm_padded_tiled``: K3 on tile classes, K1 on the residue, sort,
  K2), then one gather per A² entry into an edge bitmap and a masked sum.

"auto" picks by a cost model whose two weights were measured on the card
(:data:`DENSE_NS_PER_NPAD3`, :data:`SPARSE_NS_PER_PRODUCT`). Over a mesh
of ranks, :func:`triangle_count_sharded` runs the tiled sharded program
(``shard/tiled.py``) and sums each rank's bitmap test.

Markov clustering (:func:`markov_cluster`): square the column-stochastic
flow, raise it to the inflation power, prune, normalise the columns,
repeat. On the card it is staged (:func:`mcl_prepare`, :func:`mcl_run`):
the first squaring over a host plan (K1 or K3, sort, K2), then the loop
of ``ops.chain`` on buffers sized by a host sweep in scipy
(:func:`mcl_size`) and kept in the sizing cache. One host read (the
device ``ok`` flag) per run; if a budget did not hold, the exact
stepwise chain runs and the budgets double. Over a mesh of ranks,
:func:`markov_cluster_sharded` plans every squaring on the host and runs
it by the tiled sharded program; ``shard.mcl`` keeps the whole loop on
the ranks' devices.
"""

from __future__ import annotations

import numpy as np
import torch

from outerspace_tpu_torch.formats.coo import COO
from outerspace_tpu_torch.formats.csr import CSR
from outerspace_tpu_torch.ops.symbolic import round_up_bucket
from outerspace_tpu_torch.perf.timer import count, span

# The selector's weights (ns), from ``chip_smoke.py``'s triangles phase
# on rmat(13, edge_factor=8, seed=4): each route's time, from the
# symmetric adjacency on the host to the count (2.814 ms dense, 59.538
# ms sparse), over n_pad³ = 8192³ (dense) or over Σ deg² = 18,834,246
# (sparse). NVIDIA H100 80GB HBM3, 700.00 W power limit (PERF.md §6).
DENSE_NS_PER_NPAD3 = 5.118739863990466e-06
SPARSE_NS_PER_PRODUCT = 3.161154579801656


def triangle_count(
    adj: COO | CSR,
    strategy: str = "auto",
    backend: str = "torch",
    device: str | torch.device = "cuda",
) -> int:
    """Count triangles in an undirected simple graph (the adjacency is
    binarised, symmetrised and stripped of its diagonal first).

    ``backend="torch"`` runs on ``device`` ("cpu" runs each kernel's
    plain version); ``strategy`` is then "dense", "sparse" or "auto"
    (:func:`_triangle_strategy`). A forced dense route outside its
    exactness envelope (:func:`_dense_triangle_safe`) raises.
    ``backend="scipy"`` is the host reference."""
    if backend not in ("torch", "scipy"):
        raise ValueError(f"unknown backend {backend!r}")
    if strategy not in ("auto", "dense", "sparse"):
        raise ValueError(f"unknown strategy {strategy!r}")
    a = adj if isinstance(adj, CSR) else adj.to_csr()
    sym = _symmetrize_simple(a.to_coo())
    if backend == "scipy":
        from outerspace_tpu_torch.ops.reference import spgemm_scipy

        return _hadamard_count(spgemm_scipy(sym, sym), sym)
    if strategy == "auto":
        strategy = _triangle_strategy(sym)
    if strategy == "dense":
        if not _dense_triangle_safe(sym):
            raise ValueError(
                "dense triangle route unsafe here (n > 32768 or the "
                "Σ(A²∘A) int32 bound is not provable); use "
                "strategy='sparse' or 'auto'"
            )
        return triangle_count_dense(sym, device=device)
    if sym.shape[0] * sym.shape[1] < 2**31:
        return triangle_count_device(triangle_prepare(sym, device=device))
    from outerspace_tpu_torch.ops.spgemm import spgemm

    return _hadamard_count(spgemm(sym, sym, device=device), sym)


def _hadamard_count(a2: CSR, sym: COO) -> int:
    """Σ A²[i, j] over the edges (i, j), / 6, on the host."""
    total = float(a2.to_scipy().tocsr().multiply(sym.to_scipy().tocsr()).sum())
    return int(round(total / 6.0))


def _symmetrize_simple(coo: COO) -> COO:
    """Binarise + symmetrise + drop the diagonal (simple-graph adjacency)."""
    keep = coo.row != coo.col
    coo = COO(
        coo.shape,
        coo.row[keep],
        coo.col[keep],
        np.ones(int(keep.sum()), dtype=np.float32),
    )
    sym = COO(
        coo.shape,
        np.concatenate([coo.row, coo.col]),
        np.concatenate([coo.col, coo.row]),
        np.concatenate([coo.val, coo.val]),
    ).deduplicated()
    return COO(sym.shape, sym.row, sym.col, np.ones(sym.nnz, dtype=np.float32))


def _n_pad(sym: COO) -> int:
    return -(-max(sym.shape[0], sym.shape[1]) // 256) * 256


def _dense_triangle_safe(sym: COO) -> bool:
    """Exactness envelope of the dense route, as the JAX package's: the
    padded matrix has n ≤ 32,768, and Σ(A²∘A) ≤ Σ_edges min(deg_i,
    deg_j) < 2³¹."""
    if _n_pad(sym) > 32768:
        return False
    deg = np.bincount(sym.row, minlength=sym.shape[0]).astype(np.int64)
    return np.minimum(deg[sym.row], deg[sym.col]).sum() < 2**31


def _triangle_strategy(sym: COO) -> str:
    """Dense or sparse route, whichever the model puts faster: the dense
    route's time grows as n_pad³ (the product of the padded dense
    matrix), the sparse route's as its products P = Σ deg². Dense only
    inside :func:`_dense_triangle_safe`."""
    if not _dense_triangle_safe(sym):
        return "sparse"
    deg = np.bincount(sym.row, minlength=sym.shape[0]).astype(np.int64)
    dense_ns = float(_n_pad(sym)) ** 3 * DENSE_NS_PER_NPAD3
    sparse_ns = float((deg * deg).sum()) * SPARSE_NS_PER_PRODUCT
    return "dense" if dense_ns < sparse_ns else "sparse"


def triangle_count_dense(
    sym: COO, block: int = 2048, device: str | torch.device = "cuda"
) -> int:
    """Σ(A²∘A)/6 by blocked dense int8 products on ``device``.

    Exact: the adjacency's 0/1 entries are int8, ``torch._int_mm``
    accumulates in int32 (each entry of A² ≤ n ≤ 32,768), and the masked
    total is summed in int64. The adjacency is scattered into its dense
    form on the device from the edge list; A² is never held whole: each
    row block is multiplied, masked by the same block of A and summed."""
    device = torch.device(device)
    rows = torch.from_numpy(sym.row.astype(np.int64)).to(device)
    cols = torch.from_numpy(sym.col.astype(np.int64)).to(device)
    return int(_tri_dense_total(rows, cols, _n_pad(sym), block)) // 6


def _tri_dense_total(rows, cols, n_pad: int, block: int = 2048) -> torch.Tensor:
    """Σ(A²∘A) on the edges' device, int64, without waiting for it."""
    block = min(block, n_pad)
    while n_pad % block:
        block //= 2
    dense = torch.zeros((n_pad, n_pad), dtype=torch.int8, device=rows.device)
    dense[rows, cols] = 1
    # A is symmetric, so A = Aᵀ: the transposed view is the same matrix in
    # column-major order, which the card's int8 product takes 4.8x faster
    # than a row-major right operand (PERF.md §6)
    a_cols = dense.t()
    total = torch.zeros((), dtype=torch.int64, device=rows.device)
    for i in range(0, n_pad, block):
        blk = dense[i:i + block]
        total += (torch._int_mm(blk, a_cols) * blk).sum(dtype=torch.int64)
    return total


def _edge_bitmap(rows, cols, nrows_pad: int, n_words: int) -> np.ndarray:
    """Dense edge bitmap (1 bit per (i, j)): membership becomes one
    gather per A² entry."""
    bitmap = np.zeros(nrows_pad * n_words, dtype=np.uint32)
    word = rows.astype(np.int64) * n_words + (cols >> 5)
    bit = np.uint32(1) << (cols.astype(np.uint32) & np.uint32(31))
    np.bitwise_or.at(bitmap, word, bit)
    return bitmap


def triangle_prepare(sym: COO, device: str | torch.device = "cuda"):
    """Stage the sparse route on ``device``: the tiled plan of A² and the
    edge bitmap (int32 words). Returns the tuple
    :func:`triangle_count_device` takes."""
    from outerspace_tpu_torch.ops.spgemm import plan_tiled

    n = sym.shape[1]
    if sym.shape[0] * n >= 2**31:
        raise ValueError("the sparse route's packed keys need m*n < 2^31")
    tplan = plan_tiled(sym.to_csc(), sym.to_csr(), device=device)
    n_words = -(-n // 32)
    bitmap = _edge_bitmap(sym.row, sym.col, sym.shape[0], n_words)
    return tplan, torch.from_numpy(bitmap.view(np.int32)).to(device), n, n_words


def _tri_sum(rows, cols, vals, valid, bitmap, n_words: int) -> torch.Tensor:
    """Σ of the merged A² values at the edges of the bitmap, float64 (A²'s
    entries are integers, so the sum is exact)."""
    word = torch.where(valid, rows.long() * n_words + (cols >> 5).long(), 0)
    member = valid & (((bitmap[word] >> (cols & 31)) & 1) != 0)
    return torch.where(member, vals, 0.0).sum(dtype=torch.float64)


def triangle_count_device(prep) -> int:
    """A² by the tiled pipeline, then Hadamard with A through the edge
    bitmap; only the total crosses to the host."""
    return int(round(float(_tri_sparse_total(prep)) / 6.0))


def _tri_sparse_total(prep) -> torch.Tensor:
    """Σ(A²∘A) on the plan's device, float64, without waiting for it."""
    from outerspace_tpu_torch.ops.spgemm import spgemm_padded_tiled

    tplan, bitmap, _, n_words = prep
    merged = spgemm_padded_tiled(tplan)
    return _tri_sum(merged.rows, merged.cols, merged.vals, merged.valid, bitmap, n_words)


def _resolve_mesh_dims(mesh, kx, ny):
    """(kx, ny) for a program on ``mesh``: kx defaults only on a 1-D mesh
    (on a 2-D one a flattened kx would cover the first axis alone). The
    program's build checks both against the mesh's axes."""
    if kx is None:
        if len(mesh.axis_names) != 1:
            raise ValueError("multi-axis mesh needs explicit kx/ny (e.g. kx=4, ny=2)")
        return mesh.size(mesh.axis_names[0]), 1
    return kx, ny


def triangle_count_sharded(
    adj: COO | CSR,
    mesh,
    axes: tuple[str, str] | str = ("x", "y"),
    kx: int | None = None,
    ny: int = 1,
) -> int:
    """Triangles over a mesh of ranks (every rank calls it): A² by the
    tiled sharded program (``shard/tiled.py``: K3, K1, sort, exchange,
    K2), each rank's merged entries tested against its own row block of
    A's edge bitmap (the exchange routed every entry of A² to its row
    owner, so the test is local), the float64 partial sums all-reduced.
    A²'s entries are integers, so the count is exact."""
    import torch.distributed as dist

    from outerspace_tpu_torch.shard.tiled import shard_plan_tiled, spgemm_sharded_tiled

    coo = adj if isinstance(adj, COO) else adj.to_coo()
    sym = _symmetrize_simple(coo)
    kx, ny = _resolve_mesh_dims(mesh, kx, ny)
    plan = shard_plan_tiled(sym.to_csc(), sym.to_csr(), kx=kx, ny=ny)
    merged = spgemm_sharded_tiled(plan, mesh, axes=axes)
    n_words = -(-plan.n // 32)
    lo = mesh.index(axes if isinstance(axes, str) else axes[0]) * plan.rows_per_x
    mine = (sym.row >= lo) & (sym.row < lo + plan.rows_per_x)
    bitmap = _edge_bitmap(sym.row[mine] - lo, sym.col[mine], plan.rows_per_x, n_words)
    bm = torch.from_numpy(bitmap.view(np.int32)).to(mesh.device)
    rows = torch.where(merged.valid, merged.rows - lo, 0)
    total = _tri_sum(rows, merged.cols, merged.vals, merged.valid, bm, n_words)
    if mesh.staged:
        total = total.cpu()
    dist.all_reduce(total)
    return int(round(float(total) / 6.0))


# --------------------------------------------------------------------------
# Markov clustering
# --------------------------------------------------------------------------


def _mcl_setup(coo: COO) -> CSR:
    """MCL preamble shared by every backend: self loops (standard MCL),
    absolute values, duplicates summed, columns normalised."""
    n = coo.shape[0]
    if coo.shape[0] != coo.shape[1]:
        raise ValueError(f"adjacency must be square, got {coo.shape}")
    m = COO(
        coo.shape,
        np.concatenate([coo.row, np.arange(n, dtype=coo.row.dtype)]),
        np.concatenate([coo.col, np.arange(n, dtype=coo.col.dtype)]),
        np.concatenate([np.abs(coo.val), np.ones(n, dtype=np.float32)]),
    ).deduplicated()
    return _col_normalize(m.to_csr())


def _mcl_inflate_prune(expanded: CSR, inflation: float, prune_threshold: float) -> CSR:
    """One MCL inflation step on the host (elementwise power, prune,
    column normalisation), shared by the host-loop backends."""
    c = expanded.to_coo()
    v = np.power(np.maximum(c.val, 0.0), inflation)
    keep = v > prune_threshold
    return _col_normalize(COO(c.shape, c.row[keep], c.col[keep], v[keep]).to_csr())


def markov_cluster_sharded(
    adj: COO | CSR,
    mesh,
    axes: tuple[str, str] | str = ("x", "y"),
    kx: int | None = None,
    ny: int = 1,
    expansion: int = 2,
    inflation: float = 2.0,
    iters: int = 10,
    prune_threshold: float = 1e-4,
    report: dict | None = None,
) -> CSR:
    """Markov clustering over a mesh of ranks (every rank calls it and
    gets the final flow), each squaring planned on the host: per
    iteration every rank plans the product of the current flow
    (``shard_plan_tiled``), runs its part of the tiled sharded program
    (K3, K1, sort, exchange, K2) and gathers the whole product from
    every rank, then inflates, prunes and normalises on the host as
    :func:`markov_cluster` does, with the same preamble and convergence
    test. ``report`` receives the iterations run and whether the flow
    converged."""
    from outerspace_tpu_torch.shard.spgemm_sharded import allgather_to_csr
    from outerspace_tpu_torch.shard.tiled import shard_plan_tiled, spgemm_sharded_tiled

    coo = adj.to_coo() if not isinstance(adj, COO) else adj
    kx, ny = _resolve_mesh_dims(mesh, kx, ny)
    flow = _mcl_setup(coo)

    def mult_sharded(a: CSR, b: CSR) -> CSR:
        plan = shard_plan_tiled(a.to_csc(), b, kx=kx, ny=ny)
        return allgather_to_csr((plan.m, plan.n), spgemm_sharded_tiled(plan, mesh, axes=axes))

    info = dict(loop="host", iterations=0, converged=False)
    for _ in range(iters):
        expanded = flow
        for _ in range(expansion - 1):
            expanded = mult_sharded(expanded, flow)
        new_flow = _mcl_inflate_prune(expanded, inflation, prune_threshold)
        info["iterations"] += 1
        if _converged(flow, new_flow):
            flow, info["converged"] = new_flow, True
            break
        flow = new_flow
    if report is not None:
        report.update(info)
    return flow


def markov_cluster(
    adj: COO | CSR,
    expansion: int = 2,
    inflation: float = 2.0,
    iters: int = 10,
    prune_threshold: float = 1e-4,
    backend: str = "torch",
    device: str | torch.device = "cuda",
    report: dict | None = None,
) -> CSR:
    """Markov clustering: alternate expansion (the flow to the power
    ``expansion``) and inflation (elementwise power, prune, column
    normalisation). Returns the final flow; clusters are read from it by
    :func:`mcl_clusters`.

    ``backend="torch"`` runs on ``device`` ("cpu" runs each kernel's
    plain version): the staged chain (:func:`mcl_prepare`,
    :func:`mcl_run`) for ``expansion=2`` at any n (its keys take int64
    from n² ≥ 2³² on), otherwise a host loop over ``spgemm``, which stops
    early once the flow stops changing.
    ``backend="scipy"`` is that host loop over scipy's product (the
    reference). ``report`` (staged chain only) receives the budgets the
    run used, whether it took the fast path, and its first squaring's
    merged stream length (``stage1_stream``) and row parts
    (``stage1_parts``)."""
    if backend not in ("torch", "scipy"):
        raise ValueError(f"unknown backend {backend!r}")
    coo = adj.to_coo() if not isinstance(adj, COO) else adj
    flow = _mcl_setup(coo)
    if iters <= 0:
        return flow
    if backend == "torch" and expansion == 2:
        prep = mcl_prepare(flow, inflation=inflation, iters=iters,
                           prune_threshold=prune_threshold, device=device)
        out = mcl_run(prep)
        if report is not None:
            # the budgets this run used (a fallback doubles them for the
            # next run; the stepwise chain it ran has no such budgets)
            budgets = prep["ran_with"]
            fast = budgets["p_pad"] == prep["p_pad"]
            slots, parts = _stage1_stream(prep["tplan"])
            report.update(budgets, iters=iters, fast_path=fast, stage1_stream=slots,
                          stage1_parts=parts)
            if not fast:
                report["p_pad"] = None
        return out.to_csr()
    from outerspace_tpu_torch.ops.reference import spgemm_scipy
    from outerspace_tpu_torch.ops.spgemm import spgemm

    def mult(a, b):
        if backend == "torch":
            return spgemm(a, b, device=device)
        return spgemm_scipy(a, b)

    for _ in range(iters):
        expanded = flow
        for _ in range(expansion - 1):
            expanded = mult(expanded, flow)
        new_flow = _mcl_inflate_prune(expanded, inflation, prune_threshold)
        if _converged(flow, new_flow):
            return new_flow
        flow = new_flow
    return flow


def mcl_prepare(flow: CSR, inflation: float = 2.0, iters: int = 10,
                prune_threshold: float = 1e-4, device: str | torch.device = "cuda") -> dict:
    """Stage the chain on ``device``: the first squaring's host plan, for
    the pipeline the cost model picks for the flow (the windowed-gather
    plan for "gather", the tiled row parts otherwise), and the sizing
    cache's key. Returns the ``prep`` dict :func:`mcl_run` takes.

    Any square flow with n < 2³¹ is staged. From n² ≥ 2³² on both
    plans cut the first squaring into row parts whose part-local keys
    fit 32 bits (at n = 2¹⁹, at least 64 parts), and the rest of the
    chain keys its streams in int64 (``ops.kernels.compact.key_dtype``)."""
    from outerspace_tpu_torch.ops.gather_pipeline import plan_spgemm_gather
    from outerspace_tpu_torch.ops.spgemm import plan_tiled_parts
    from outerspace_tpu_torch.sched.planner import choose_strategy
    from outerspace_tpu_torch.sched.sizing_cache import workload_key

    n = flow.shape[0]
    if flow.shape[0] != flow.shape[1] or not 0 < n < 2**31:
        raise ValueError(f"the staged MCL needs a square flow with 0 < n < 2^31, got {flow.shape}")
    if iters < 1:
        raise ValueError("mcl_prepare stages >= 1 iteration; iters=0 is a no-op")
    a_csc = flow.to_csc()
    if choose_strategy(a_csc, flow) == "gather":
        tplan = plan_spgemm_gather(a_csc, flow, device=device)
    else:
        tplan = plan_tiled_parts(a_csc, flow, device=device)
    sizing_key = workload_key(
        (np.asarray(flow.indptr), np.asarray(flow.indices)),
        ("mcl-torch", n, float(inflation), int(iters), float(prune_threshold)),
    )
    return {
        "tplan": tplan,
        "n": n,
        "inflation": float(inflation),
        "iters": int(iters),
        "threshold": float(prune_threshold),
        "sizing_key": sizing_key,
        # for the host sizing sweep; dropped once the budgets are known
        "flow": flow,
    }


def _host_mcl_sizing(flow_scipy, inflation, iters, threshold):
    """Per-squaring product counts P_i and surviving nnz of the MCL
    recurrence, run once in scipy with the device loop's semantics
    (square, prune on the unnormalised powered values, normalise)."""
    import scipy.sparse as sp

    flow = flow_scipy.tocsr()
    n = flow.shape[0]
    p_list, nnz_list = [], []
    for _ in range(iters):
        rownnz = np.diff(flow.indptr)
        coo = flow.tocoo()
        p_list.append(int(rownnz[coo.col].sum()))
        sqm = (flow @ flow).tocsr()
        sqm.sort_indices()  # the column sums below add in this order
        sq = sqm.tocoo()
        vp = np.power(np.maximum(sq.data, 0.0), inflation)
        keep = vp > threshold
        r, c, v = sq.row[keep], sq.col[keep], vp[keep]
        nnz_list.append(int(keep.sum()))
        cs = np.zeros(n)
        np.add.at(cs, c, v)
        cs[cs == 0] = 1.0
        flow = sp.coo_matrix((v / cs[c], (r, c)), shape=(n, n)).tocsr()
    return p_list, nnz_list


def _stage1_stream(tplan) -> tuple[int, int]:
    """(slots, row parts) of the first squaring's merged stream."""
    from outerspace_tpu_torch.ops.gather_pipeline import GatherPipelinePlan
    from outerspace_tpu_torch.ops.spgemm import TiledPartsPlan

    if isinstance(tplan, GatherPipelinePlan):
        return sum(p.merge_pad for p in tplan.parts), len(tplan.parts)
    if isinstance(tplan, TiledPartsPlan):
        return tplan.padded_total, len(tplan.parts)
    return tplan.padded_total, 1


def mcl_size(prep: dict) -> None:
    """The host sizing sweep of a staged MCL (scipy): the exact products
    P_i of every squaring and the survivors of every iteration set the
    loop's budgets, each with a ×1.5 margin: ``elem_pad`` (element
    slots), ``nnz_pad`` (the output), ``p_pads`` (one product budget per
    loop squaring, at most three distinct sizes, each rounded up) and
    ``p_pad`` (their maximum). Fills ``prep`` and stores the budgets in
    the sizing cache under ``prep["sizing_key"]``."""
    from outerspace_tpu_torch.sched import sizing_cache

    p_list, nnz_list = _host_mcl_sizing(prep["flow"].to_scipy().tocsr(), prep["inflation"],
                                        prep["iters"], prep["threshold"])
    elem_pad = round_up_bucket(max(int(1.5 * max(nnz_list)) + 1024, 4096), min_size=4096)
    nnz_pad = round_up_bucket(max(int(1.5 * nnz_list[-1]) + 256, 1024), min_size=1024)
    p_pads = tuple(round_up_bucket(max(int(1.5 * p) + 4096, elem_pad, 4096), min_size=4096)
                   for p in p_list[1:])
    # at most three distinct sizes, each entry rounded UP to a kept size
    # (budgets only grow; ok still guards each)
    distinct = sorted(set(p_pads), reverse=True)
    if len(distinct) > 3:
        kept = {distinct[0], distinct[len(distinct) // 2], distinct[-1]}
        p_pads = tuple(min(s for s in kept if s >= p) for p in p_pads)
    prep["p_pad"] = max(p_pads) if p_pads else elem_pad
    prep["nnz_pad"], prep["elem_pad"] = nnz_pad, elem_pad
    prep["p_pads"] = p_pads or None
    prep.pop("flow", None)
    if "sizing_key" in prep:
        sizing_cache.store(prep["sizing_key"], _budgets(prep))


def _budgets(prep: dict) -> dict:
    """The budgets of ``prep`` as the sizing cache stores them (a caller
    may set only ``p_pad`` and ``nnz_pad``)."""
    pps = prep.get("p_pads")
    return {"p_pad": prep["p_pad"], "nnz_pad": prep["nnz_pad"], "elem_pad": prep.get("elem_pad"),
            "p_pads": list(pps) if pps else None}


def _from_cache(prep: dict) -> bool:
    """Fill ``prep``'s budgets from the sizing cache; False on a miss.
    A schedule of the wrong length (a torn or edited entry) is dropped:
    a bad entry costs speed, never a wrong result. Keys this does not
    read are ignored."""
    from outerspace_tpu_torch.sched import sizing_cache

    cached = sizing_cache.lookup(prep["sizing_key"])
    if not cached or "p_pad" not in cached or "nnz_pad" not in cached:
        return False
    iters = prep["iters"]
    prep["p_pad"], prep["nnz_pad"] = cached["p_pad"], cached["nnz_pad"]
    prep["elem_pad"] = cached.get(
        "elem_pad", round_up_bucket(max(4 * cached["nnz_pad"], 4096), min_size=4096))
    pps = cached.get("p_pads")
    prep["p_pads"] = tuple(pps) if pps and len(pps) == iters - 1 else None
    prep["sizing_cached"] = True
    prep.pop("flow", None)
    return True


def mcl_run(prep: dict):
    """Run the staged MCL: the first squaring, inflation, the loop and the
    final sort (``ops.chain.mcl_whole_traced``), queued with no host read,
    then one read of ``ok``. Returns the flow as a ``MergedCOO``.

    The budgets come from ``prep``, else the sizing cache, else the host
    sweep (:func:`mcl_size`). If ``ok`` is false, the exact stepwise
    chain runs from the first squaring's flow, and the budgets double
    (single-size) for the next run and in the cache.

    A run is an ``mcl.run`` span (attribute ``fallback``) over the
    chain's stages, ``mcl.wait`` (the read of ``ok``) and, when taken,
    ``mcl.fallback``; it counts ``mcl.runs``, ``mcl.wide_runs`` when its
    keys are int64 (n² ≥ 2³²), and ``mcl.fallbacks`` when ``ok`` was
    false."""
    from outerspace_tpu_torch.ops.chain import (
        _stage1_squaring,
        inflate_device,
        markov_cluster_device_fused,
        mcl_whole_traced,
    )
    from outerspace_tpu_torch.ops.kernels.compact import key_dtype
    from outerspace_tpu_torch.ops.spgemm import MergedCOO
    from outerspace_tpu_torch.sched import sizing_cache

    tplan, n = prep["tplan"], prep["n"]
    inflation, iters, threshold = prep["inflation"], prep["iters"], prep["threshold"]
    count("mcl.runs")
    if key_dtype(n) == torch.int64:
        count("mcl.wide_runs")
    with span("mcl.run") as run:
        if "p_pad" not in prep and not ("sizing_key" in prep and _from_cache(prep)):
            mcl_size(prep)
        prep["ran_with"] = _budgets(prep)
        r, c, v, nnz, ok = mcl_whole_traced(
            tplan, p_pad=prep["p_pad"], nnz_pad=prep["nnz_pad"], m=n, n_cols=n,
            iters=iters - 1, inflation=inflation, threshold=threshold,
            elem_pad=prep.get("elem_pad"), p_pads=prep.get("p_pads"),
        )
        with span("mcl.wait"):
            fast = bool(ok)
        run.set(fallback=not fast)
        if fast:
            return MergedCOO((n, n), r, c, v, torch.arange(r.shape[0], device=r.device) < nnz, nnz)
        count("mcl.fallbacks")
        with span("mcl.fallback"):
            sq = _stage1_squaring(tplan)
            v1, valid1, nnz1 = inflate_device(sq.rows, sq.cols, sq.vals, sq.valid, m=n,
                                              inflation=inflation, threshold=threshold)
            out = markov_cluster_device_fused(
                MergedCOO(sq.shape, sq.rows, sq.cols, v1, valid1, nnz1),
                inflation=inflation, iters=iters - 1, prune_threshold=threshold)
    prep["p_pad"] = round_up_bucket(prep["p_pad"] * 2, min_size=4096)
    prep["nnz_pad"] = round_up_bucket(max(prep["nnz_pad"] * 2, int(out.nnz)), min_size=1024)
    prep["elem_pad"] = round_up_bucket(prep.get("elem_pad", prep["nnz_pad"]) * 2, min_size=4096)
    prep["p_pads"] = None
    prep.pop("sizing_cached", None)
    if "sizing_key" in prep:
        sizing_cache.store(prep["sizing_key"], _budgets(prep))
    return out


def mcl_clusters(flow: CSR) -> list[np.ndarray]:
    """Clusters of a final flow: each attractor row (nonzero diagonal)
    and the columns attached to it, each member set once."""
    s = flow.to_scipy().tocsr()
    attractors = np.nonzero(s.diagonal() > 1e-6)[0]
    clusters = []
    seen = set()
    for a in attractors:
        lo, hi = s.indptr[a], s.indptr[a + 1]
        members = s.indices[lo:hi][s.data[lo:hi] != 0]  # the row's stored nonzeros
        key = tuple(sorted(members.tolist()))
        if key not in seen and len(members):
            seen.add(key)
            clusters.append(np.asarray(members))
    return clusters


def _col_normalize(m: CSR) -> CSR:
    s = m.to_scipy().tocsc()
    sums = np.asarray(s.sum(axis=0)).ravel()
    sums[sums == 0] = 1.0
    d = s.multiply(1.0 / sums).tocsr()
    d.sort_indices()
    return CSR.from_scipy(d.astype(np.float32))


def _converged(a: CSR, b: CSR, tol: float = 1e-6) -> bool:
    if a.nnz != b.nnz or a.shape != b.shape:
        return False
    return abs(a.to_scipy() - b.to_scipy()).max() <= tol
