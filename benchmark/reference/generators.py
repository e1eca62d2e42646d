"""The benchmark's own operand generators: Erdős–Rényi and R-MAT.

A frozen copy of the port's ``formats/generators.py`` (same draws from
``numpy.random.default_rng`` in the same order, so the same arguments
give bit-identical matrices), kept here so that no later change to the
program can change the yardstick's inputs. Each returns a CSR as plain
numpy arrays: ``(shape, indptr int64, indices int32, data float32)``,
rows sorted by column, duplicates summed.
"""

from __future__ import annotations

import numpy as np


def erdos_renyi(n_rows: int, n_cols: int, density: float, seed: int = 0, values: str = "uniform"):
    """ER random matrix with ``round(density * n_rows * n_cols)`` distinct nnz."""
    rng = np.random.default_rng(seed)
    target = min(int(round(density * n_rows * n_cols)), n_rows * n_cols)
    total = n_rows * n_cols
    if total <= 1 << 24:
        lin = rng.choice(total, size=target, replace=False)
    else:
        # oversample and deduplicate: choice without replacement would
        # materialise the whole index range
        lin = np.unique(rng.integers(0, total, size=int(target * 1.2) + 16))
        while lin.shape[0] < target:
            extra = rng.integers(0, total, size=target - lin.shape[0] + 16)
            lin = np.unique(np.concatenate([lin, extra]))
        lin = rng.permutation(lin)[:target]
    rows = (lin // n_cols).astype(np.int32)
    cols = (lin % n_cols).astype(np.int32)
    vals = gen_values(rng, rows.shape[0], values)
    return coo_to_csr((n_rows, n_cols), rows, cols, vals)


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19, c: float = 0.19,
         seed: int = 0, values: str = "uniform"):
    """R-MAT (Graph500 Kronecker) square matrix, ``2**scale`` per side:
    recursive quadrant sampling with probabilities (a, b, c, 1-a-b-c);
    duplicate edges summed."""
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    ab = a + b
    c_norm = c / max(1.0 - ab, 1e-12)
    a_norm = a / max(ab, 1e-12)
    for bit in range(scale):
        r_bit = rng.random(m) > ab
        c_bit = np.where(r_bit, rng.random(m) > c_norm, rng.random(m) > a_norm)
        rows |= r_bit.astype(np.int64) << bit
        cols |= c_bit.astype(np.int64) << bit
    vals = gen_values(rng, m, values)
    return coo_to_csr((n, n), rows.astype(np.int32), cols.astype(np.int32), vals)


def gen_values(rng, n: int, kind: str) -> np.ndarray:
    """``n`` float32 values: ones, uniform in [0.5, 1.5) or standard normal."""
    if kind == "ones":
        return np.ones(n, dtype=np.float32)
    if kind == "uniform":
        return (rng.random(n, dtype=np.float32) + 0.5).astype(np.float32)
    if kind == "normal":
        return rng.standard_normal(n, dtype=np.float32).astype(np.float32)
    raise ValueError(f"unknown value kind {kind!r}")


def coo_to_csr(shape, rows, cols, vals):
    """Row-major CSR of a COO, values at duplicate coordinates summed in
    float32 in row-major order (the port's ``COO.deduplicated``)."""
    p = np.lexsort((cols, rows))
    r, c, v = rows[p], cols[p], vals[p]
    new = np.ones(r.shape[0], dtype=bool)
    new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    seg = np.cumsum(new) - 1
    out_v = np.zeros(int(seg[-1]) + 1 if seg.size else 0, dtype=np.float32)
    np.add.at(out_v, seg, v)
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(r[new], minlength=shape[0]), out=indptr[1:])
    return (int(shape[0]), int(shape[1])), indptr, np.ascontiguousarray(c[new], dtype=np.int32), out_v


def make(config: dict):
    """The CSR a configuration file describes: its graph, drawn from the
    configuration's ``graph_seed``, made undirected where the file says
    ``"symmetric": true`` (:func:`symmetrize`), its vertex labels
    scrambled as Graph 500 scrambles them, by a permutation drawn from
    ``graph_seed`` too. One graph per configuration: the program's padded
    work depends on the labels, so a run's seed does not draw them."""
    kind = config["generator"]
    if kind == "rmat":
        g = rmat(config["scale"], edge_factor=config["edge_factor"], a=config["a"], b=config["b"],
                 c=config["c"], seed=config["graph_seed"], values=config["values"])
    elif kind == "erdos_renyi":
        g = erdos_renyi(config["n_rows"], config["n_cols"], config["density"],
                        seed=config["graph_seed"], values=config["values"])
    else:
        raise ValueError(f"unknown generator {kind!r}")
    if config.get("symmetric", False):
        g = symmetrize(g)
    return relabel(g, np.random.default_rng([config["graph_seed"], 0x9E1A]).permutation(g[0][0]))


def symmetrize(csr):
    """The undirected graph of an edge list, as Graph 500 reads its
    generator's tuples: each stored (i, j) stands for the edges (i, j)
    and (j, i), duplicates summed (a self loop so counts twice)."""
    (n, n2), indptr, indices, data = csr
    if n != n2:
        raise ValueError(f"symmetrizing needs a square matrix, got {(n, n2)}")
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    return coo_to_csr((n, n), np.concatenate([rows, indices]), np.concatenate([indices, rows]),
                      np.concatenate([data, data]))


def mirror(csr) -> np.ndarray:
    """For a CSR whose pattern is symmetric, the position of entry (j, i)
    for each stored entry (i, j), in storage order."""
    (n, _), indptr, indices, _ = csr
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    # sorted by (column, row), the k-th entry sits at the mirror image of
    # the k-th entry in (row, column) order
    return np.lexsort((rows, indices))


def relabel(csr, perm: np.ndarray):
    """The square CSR with vertex ``v`` renamed ``perm[v]`` (rows and
    columns alike)."""
    (n, n2), indptr, indices, data = csr
    if n != n2:
        raise ValueError(f"relabelling needs a square matrix, got {(n, n2)}")
    rows = np.repeat(np.arange(n), np.diff(indptr))
    return coo_to_csr((n, n), perm[rows].astype(np.int32), perm[indices].astype(np.int32), data)


def call_values(seed: int, call: int, nnz: int) -> np.ndarray:
    """The float32 values of call ``call`` (uniform in [0.5, 1.5)),
    drawn from (seed, call) alone, so any call's operand can be made
    again without the ones before it. Warm-up calls take negative
    numbers."""
    rng = np.random.default_rng([seed % (1 << 64), call % (1 << 64), 1 if call < 0 else 0])
    return gen_values(rng, nnz, "uniform")
