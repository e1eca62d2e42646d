"""Operands the tiled strategy's tests share, made with numpy from a seed.
Each takes the COO class to build with (the JAX package's or the
port's: both take (shape, rows, cols, vals)), so the files that must not
import JAX can use them too."""

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
