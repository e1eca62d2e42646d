"""Inputs the port's tests share, made with numpy from a seed: operands
for the tiled strategy, each built with the COO class it is given (the
JAX package's or the port's: both take (shape, rows, cols, vals)), and
K1 inputs made by hand. Files that must not import JAX use them too."""

import numpy as np


def big_shape_pair(coo, seed=0):
    """m·n = 4.9·10⁹ > 2³² with a few thousand nonzeros: a tall A column
    and four 256-wide B rows give tile classes beside the residue."""
    m = n = 70000
    k = 64
    rng = np.random.default_rng(seed)
    ar = rng.integers(0, m, size=1500)
    ak = rng.integers(0, k, size=1500)
    ak[:64] = 0
    au = np.unique(ar * np.int64(k) + ak)
    a = coo((m, k), au // k, au % k, rng.standard_normal(au.shape[0]).astype(np.float32))
    nb = np.full(k, 20)
    nb[:4] = 256
    bk = np.repeat(np.arange(k), nb)
    bc = np.concatenate([rng.choice(n, size=c, replace=False) for c in nb])
    bu = np.unique(bk * np.int64(n) + bc)
    b = coo((k, n), bu // n, bu % n, rng.standard_normal(bu.shape[0]).astype(np.float32))
    return a, b


def dense_blocks(coo):
    """Columns of 8, 32 and 128 nonzeros (and ragged ones) against B rows
    of 128 and 256 (and ragged ones): tiles in every class."""
    rng = np.random.default_rng(11)
    d = np.zeros((256, 12), np.float32)
    for j, h in enumerate((128, 32, 8, 128, 40, 8, 33, 8, 160, 3, 32, 17)):
        d[rng.choice(256, size=h, replace=False), j] = rng.normal(size=h) + 3
    e = np.zeros((12, 300), np.float32)
    for i, w in enumerate((128, 256, 128, 5, 130, 128, 256, 129, 128, 200, 1, 128)):
        e[i, rng.choice(300, size=w, replace=False)] = rng.normal(size=w) + 3
    return coo.from_dense(d), coo.from_dense(e)


def k1_odd_windows(seed, b_win, bits, ngroups=8, anchors=(0, 128), nab8=3, nbb8=6, shift=0,
                   r_a=(1, 23), r_b=(0, 6)):
    """K1 inputs made by hand (int32 numpy arrays, as ``gather_plan_to_host``
    stages them, plus ``group_bits``) whose windows no planner would
    build: ``cum`` runs at random, is all zero (the blocks that pad a
    commonised part) or increases, block by block; anchors are drawn from
    ``anchors`` (a range past [0, 128) sends the search out of the A
    window); bases reach past the packs' last 8-block ref, so the reads
    clamp; row·n_cols passes 2³², so keys wrap; jb lands before, inside
    and past the B window. Subtile lengths are 0, 1024 or in between, and
    the last group is all padding (a zero table row). ``bits`` is one
    search depth for every group, or None for 4, 6 or 8 per group.
    ``shift`` is added to every jb, nonzero cum and p0 (large values pass
    2³¹ in the window offset's sum). The window refs ``r_a`` and ``r_b``
    are drawn from the ranges given: with 0 and a negative anchor, or a
    negative ``r_b``, a read falls before a pack's start and its index
    wraps once, as a negative torch index does."""
    rng = np.random.default_rng(seed)
    n_cols = 70_001
    a_pack = np.empty((nab8, 8, 4, 128), np.int32)
    a_pack[:, :, 0] = rng.integers(0, 70_000, size=(nab8, 8, 128))
    a_pack[:, :, 1] = rng.standard_normal((nab8, 8, 128)).astype(np.float32).view(np.int32)
    a_pack[:, :, 2] = rng.integers(-100, 1_400, size=(nab8, 8, 128))
    kinds = rng.integers(0, 3, size=(nab8, 8))
    for (r, i), kind in np.ndenumerate(kinds):
        cum = (rng.integers(0, 600, size=128), np.zeros(128),
               np.sort(rng.choice(600, size=128, replace=False)))[kind]
        a_pack[r, i, 3] = cum + (0 if kind == 1 else shift)
    a_pack[:, :, 2] += shift
    b_pack = np.empty((nbb8, 8, 2, 128), np.int32)
    b_pack[:, :, 0] = rng.integers(0, n_cols, size=(nbb8, 8, 128))
    b_pack[:, :, 1] = rng.standard_normal((nbb8, 8, 128)).astype(np.float32).view(np.int32)
    table = np.zeros((ngroups, 8, 128), np.int32)
    bases = np.zeros((ngroups, 2), np.int32)
    live = ngroups - 1
    bases[:live, 0] = rng.integers(0, nab8 + 1, size=live)
    bases[:live, 1] = rng.choice([0, 0, 0, 1, nbb8], size=live)
    table[:live, :, 0] = rng.integers(*r_a, size=(live, 8))
    table[:live, :, 1] = rng.integers(*r_b, size=(live, 8))
    table[:live, :, 2] = rng.integers(0, 300, size=(live, 8)) + shift
    table[:live, :, 3] = rng.choice([0, 1, 1024, 333, 1000], size=(live, 8))
    table[:live, :, 6] = rng.integers(*anchors, size=(live, 8))
    table[:, :, 5] = n_cols
    if bits is None:
        group_bits = rng.choice([4, 6, 8], size=ngroups).astype(np.int32)
    else:
        group_bits = np.full(ngroups, bits, np.int32)
    return dict(bases=bases.reshape(-1), table=table, a_pack=a_pack, b_pack=b_pack,
                group_bits=group_bits)


def k1_reads_before_the_packs(h):
    """Whether some live subtile of ``k1_odd_windows``'s ``h`` reads before
    the A pack's first block (window ref 0 in a group at base 0, searched
    from a negative anchor) and before the B pack's (a negative window
    ref in a group at base 0)."""
    tab = h["table"]
    live = tab[:, :, 3] > 0
    a8, b8 = h["bases"][0::2, None], h["bases"][1::2, None]
    shallow = (h["group_bits"] < 8)[:, None]
    a = live & shallow & (tab[:, :, 0] == 0) & (a8 == 0) & (tab[:, :, 6] < 0)
    b = live & (tab[:, :, 1] < 0) & (b8 == 0)
    return bool(a.any()), bool(b.any())


def set_jax_cost_weights(monkeypatch, jat, tat, tile_classes):
    """Set the port's cost-model weights (``tat``: its ``sched.autotune``)
    to the JAX package's (``jat``), the per-class tile weights to its live
    ``tile_ns``, so that both packages pick the same plans and strategies.
    The port's own weights are the card's."""
    for name in ("SORT_NS", "TILE_NS", "GATHER_NS", "FLAT_NS"):
        monkeypatch.setattr(tat, name, getattr(jat, name))
    monkeypatch.setattr(tat, "TILE_NS_BY_CLASS", {ta: jat.tile_ns(ta) for ta in tile_classes})


def hub_pair_graph(coo, n=700, spokes=600, seed=0):
    """Two adjacent hubs sharing ``spokes`` neighbours (degree > 256, and
    an edge whose two ends have ``spokes`` common neighbours, so A² has
    an entry past bf16's exact integers at an edge), beside a sparse
    random graph on the other vertices."""
    rng = np.random.default_rng(seed)
    rows = [0] + [0] * spokes + [1] * spokes
    cols = [1] + list(range(2, 2 + spokes)) * 2
    r = rng.integers(2, n, size=3 * n)
    c = rng.integers(2, n, size=3 * n)
    rows = np.concatenate([rows, r])
    cols = np.concatenate([cols, c])
    return coo((n, n), rows, cols, np.ones(rows.shape[0], np.float32))
