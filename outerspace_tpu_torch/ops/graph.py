"""Triangle counting on SpGEMM: the triangle half of the JAX package's
``ops/graph.py`` (Markov clustering follows with the device chains).

tri = Σᵢⱼ (A² ∘ A) / 6 for a symmetric 0/1 adjacency without self-loops.
Two routes on the card:

- **dense**: the adjacency scattered into an n_pad × n_pad int8 matrix on
  the card, multiplied block of rows by block of rows (``torch._int_mm``,
  int8 in, int32 out: exact for any count ≤ n), masked by the same block
  of A and summed in int64. A plain large matrix product outside any
  kernel, as the JAX package's ``jnp.dot`` is.
- **sparse**: the tiled SpGEMM pipeline (``plan_tiled`` →
  ``spgemm_padded_tiled``: K3 on tile classes, K1 on the residue, sort,
  K2), then one gather per A² entry into an edge bitmap and a masked sum.

"auto" picks by a cost model whose two weights were measured on the card
(:data:`DENSE_NS_PER_NPAD3`, :data:`SPARSE_NS_PER_PRODUCT`).
"""

from __future__ import annotations

import numpy as np
import torch

from outerspace_tpu_torch.formats.coo import COO
from outerspace_tpu_torch.formats.csr import CSR

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
