"""K5's plain version and the padded entry point ``spmm(device="cpu")``
against the JAX package's Pallas block-ELL SpMM (interpret mode) and the
dense product in float64, on the cases of ``tests/test_spmm.py``; and the
wrapper's checks.

Tolerance: max |Δ| ≤ 1e-6 · max |y|. The sums are taken in another order
than the Pallas kernel's dots (a batched product per slot here), so the
results are not bit-comparable.
"""

import numpy as np
import pytest
import torch

from outerspace_tpu.formats import BlockELL as JBlockELL
from outerspace_tpu.formats import COO as JCOO
from outerspace_tpu.ops.pallas.spmm_kernel import spmm as j_spmm
from outerspace_tpu_torch.formats import COO, BlockELL
from outerspace_tpu_torch.ops.kernels import spmm as k5

REL = 1e-6


def sparse_w(m, k, density, seed, block=(8, 128)):
    """A random W (numpy, from a seed) as both packages' BlockELL and as
    a float64 dense matrix."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, k)).astype(np.float32)
    d[rng.random((m, k)) >= density] = 0.0
    r, c = np.nonzero(d)
    w = BlockELL.from_coo(COO((m, k), r, c, d[r, c]), block_shape=block)
    jw = JBlockELL.from_coo(JCOO((m, k), r, c, d[r, c]), block_shape=block)
    return w, jw, d.astype(np.float64)


def few_blocks():
    m, k = 128, 512
    d = np.zeros((m, k), dtype=np.float32)
    d[3:11, 130:140] = 1.5  # one block neighbourhood
    d[77, 400] = -2.0
    r, c = np.nonzero(d)
    return (BlockELL.from_coo(COO((m, k), r, c, d[r, c]), block_shape=(8, 128)),
            JBlockELL.from_coo(JCOO((m, k), r, c, d[r, c]), block_shape=(8, 128)),
            d.astype(np.float64))


def empty_columns_and_zero_blocks():
    """Blocks whose columns are mostly empty, a block with all 128
    columns nonempty, and two stored blocks of explicit zeros (one
    beside the dense block, one alone in its row block)."""
    m, k = 24, 384
    rng = np.random.default_rng(12)
    d = np.zeros((m, k), dtype=np.float32)
    cols = rng.choice(k, size=12, replace=False)
    d[8:16, cols] = rng.standard_normal((8, 12))
    d[0:8, 128:256] = rng.standard_normal((8, 128))
    r, c = np.nonzero(d)
    zr, zc = (a.reshape(-1) for a in np.meshgrid(np.r_[0:8, 16:24], np.arange(128), indexing="ij"))
    zc = zc + np.where(zr < 8, 0, 256)
    rows, cols_, vals = np.r_[r, zr], np.r_[c, zc], np.r_[d[r, c], np.zeros(zr.size, np.float32)]
    w = BlockELL.from_coo(COO((m, k), rows, cols_, vals), block_shape=(8, 128))
    assert w.block_mask[0].sum() == 2 and w.block_mask[2].sum() == 1
    return (w, JBlockELL.from_coo(JCOO((m, k), rows, cols_, vals), block_shape=(8, 128)),
            d.astype(np.float64))


def assert_close(got, want, scale):
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want), initial=0.0))
    assert err <= REL * max(scale, 1e-30), (err, scale)


CASES = {
    "64x256x32": lambda: (*sparse_w(64, 256, 0.05, seed=320), 32),
    "100x784x17": lambda: (*sparse_w(100, 784, 0.05, seed=884), 17),
    "few_blocks": lambda: (*few_blocks(), 64),
    "unaligned_n77": lambda: (*sparse_w(40, 256, 0.08, seed=4), 77),
    "dense_1pct_wide": lambda: (*sparse_w(200, 1000, 0.01, seed=5), 130),
    "empty_cols_zero_blocks": lambda: (*empty_columns_and_zero_blocks(), 96),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spmm_cpu_matches_pallas_and_dense(case):
    w, jw, d, n = CASES[case]()
    x = np.random.default_rng(n).standard_normal((w.shape[1], n)).astype(np.float32)
    want = d @ x.astype(np.float64)
    got = k5.spmm(w, x, device="cpu").numpy()
    pallas = np.asarray(j_spmm(jw, x, interpret=True))
    assert got.shape == pallas.shape == want.shape
    scale = float(np.abs(want).max())
    assert_close(got, want, scale)
    assert_close(got, pallas.astype(np.float64), scale)


def test_spmm_empty_w_is_zero():
    w = BlockELL.from_coo(COO((64, 128), [], [], []), block_shape=(8, 128))
    jw = JBlockELL.from_coo(JCOO((64, 128), [], [], []), block_shape=(8, 128))
    x = np.ones((128, 32), dtype=np.float32)
    got = k5.spmm(w, x, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.zeros((64, 32), np.float32))
    np.testing.assert_array_equal(got, np.asarray(j_spmm(jw, x, interpret=True)))


def test_spmm_shape_mismatch_raises():
    w = sparse_w(16, 128, 0.1, seed=3)[0]
    with pytest.raises(ValueError):
        k5.spmm(w, np.ones((64, 4), dtype=np.float32), device="cpu")


@pytest.mark.parametrize("block,tn", [((8, 8), 32), ((16, 128), 64), ((5, 32), 128)])
def test_plain_other_blocks_and_tiles(block, tn):
    """K5's contract takes bm, bn and tn at run time: other block shapes
    and column tiles give the dense product too."""
    w, _, d = sparse_w(37, 200, 0.1, seed=block[0] + tn, block=block)
    x = np.random.default_rng(tn).standard_normal((200, 50)).astype(np.float32)
    want = d @ x.astype(np.float64)
    assert_close(k5.spmm(w, x, tn=tn, device="cpu").numpy(), want, float(np.abs(want).max()))


def test_device_wrapper_on_cpu_runs_plain_and_counts_nothing():
    w, _, d = sparse_w(24, 256, 0.1, seed=9)
    dev = k5.blockell_to_device(w, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((256, 128)).astype(np.float32))
    before = k5.KERNEL.launches
    got = k5.spmm_blockell_device(dev["meta"], dev["blocks"], x)
    assert k5.KERNEL.launches == before
    assert torch.equal(got, k5.spmm_blockell_plain(dev["meta"], dev["blocks"], x))
    assert got.shape == (24, 128)
    assert_close(got.numpy(), d @ x.numpy().astype(np.float64), float(np.abs(got.numpy()).max()))


def test_device_wrapper_checks():
    w = sparse_w(16, 256, 0.1, seed=2)[0]
    dev = k5.blockell_to_device(w, "cpu")
    meta, blocks = dev["meta"], dev["blocks"]
    x = torch.zeros((256, 128))
    with pytest.raises(TypeError):
        k5.spmm_blockell_device(meta.long(), blocks, x)
    with pytest.raises(TypeError):
        k5.spmm_blockell_device(meta, blocks, x.double())
    with pytest.raises(ValueError, match="bn | K_pad"):
        k5.spmm_blockell_device(meta, blocks, torch.zeros((200, 128)))
    with pytest.raises(ValueError, match="tn | N_pad"):
        k5.spmm_blockell_device(meta, blocks, torch.zeros((256, 100)))
    with pytest.raises(ValueError, match="does not match"):
        k5.spmm_blockell_device(meta[:-1], blocks, x)
    with pytest.raises(ValueError, match="contiguous"):
        k5.spmm_blockell_device(meta, blocks, torch.zeros((128, 256)).T)
    with pytest.raises(ValueError, match="x on meta"):
        k5.spmm_blockell_device(meta, blocks, x.to("meta"))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        k5.spmm_blockell_device(meta.to("meta"), blocks.to("meta"), x.to("meta"))
