"""The port's block-ELL staging against the JAX package's: ``COO``'s dense
round trip and transpose, ``BlockELL.from_coo`` and its views, and K5's
meta from ``blockell_to_device``. All host numpy, so array for array
equal. Inputs are made with numpy from a seed and handed to both."""

import numpy as np
import pytest

from outerspace_tpu.formats.compact import BlockELL as JBlockELL
from outerspace_tpu.formats.coo import COO as JCOO
from outerspace_tpu.ops.pallas.spmm_kernel import blockell_to_device as j_to_device
from outerspace_tpu_torch.formats import COO, BlockELL
from outerspace_tpu_torch.ops.kernels.spmm import blockell_to_device


def random_triples(shape, nnz, seed, dup=0):
    """Random coordinates (with ``dup`` repeated ones) and normal values."""
    rng = np.random.default_rng(seed)
    m, n = shape
    r = rng.integers(0, m, size=nnz)
    c = rng.integers(0, n, size=nnz)
    if dup:
        r = np.concatenate([r, r[:dup]])
        c = np.concatenate([c, c[:dup]])
    v = rng.standard_normal(r.shape[0]).astype(np.float32)
    return shape, r, c, v


def ragged_triples():
    """Row stripes of very different block counts: one full stripe, one
    with a single block, one empty, one with blocks far apart."""
    d = np.zeros((40, 700), np.float32)
    d[0:8, :] = np.random.default_rng(3).standard_normal((8, 700))
    d[9, 5] = 2.0
    d[33, 650] = -1.0
    d[35, 0] = 4.0
    r, c = np.nonzero(d)
    return d.shape, r, c, d[r, c]


CASES = {
    "random": lambda: random_triples((100, 784), 900, 0),
    "duplicates": lambda: random_triples((64, 300), 200, 1, dup=50),
    "ragged": ragged_triples,
    "empty": lambda: ((64, 128), np.zeros(0, int), np.zeros(0, int), np.zeros(0, np.float32)),
    "tiny_ragged_edge": lambda: random_triples((13, 29), 40, 2),
}


def assert_blockell_equal(got, want):
    assert got.shape == want.shape and tuple(got.block_shape) == tuple(want.block_shape)
    for name in ("block_cols", "block_mask", "blocks"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("tol", [0.0, 0.5])
def test_coo_from_dense_to_dense_and_transpose(tol):
    rng = np.random.default_rng(7)
    d = rng.standard_normal((17, 23)).astype(np.float32)
    d[rng.random(d.shape) < 0.6] = 0.0
    got, want = COO.from_dense(d, tol=tol), JCOO.from_dense(d, tol=tol)
    for name in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
    t, jt = got.T, want.T
    assert t.shape == jt.shape == (23, 17)
    np.testing.assert_array_equal(t.to_dense(), jt.to_dense())
    np.testing.assert_array_equal(t.to_dense(), got.to_dense().T)


def test_coo_to_dense_sums_duplicates():
    shape, r, c, v = random_triples((9, 11), 30, 4, dup=10)
    np.testing.assert_array_equal(
        COO(shape, r, c, v).to_dense(), JCOO(shape, r, c, v).to_dense()
    )


@pytest.mark.parametrize("block", [(8, 128), (8, 8), (128, 128)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_blockell_from_coo_equal(case, block):
    shape, r, c, v = CASES[case]()
    got = BlockELL.from_coo(COO(shape, r, c, v), block_shape=block)
    want = JBlockELL.from_coo(JCOO(shape, r, c, v), block_shape=block)
    assert_blockell_equal(got, want)
    assert got.stored_blocks == want.stored_blocks
    assert got.density() == want.density()
    assert (got.num_row_blocks, got.max_blocks_per_row) == (
        want.num_row_blocks, want.max_blocks_per_row)
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
    gc, wc = got.to_coo(), want.to_coo()
    for name in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(gc, name), getattr(wc, name))


@pytest.mark.parametrize("pad", [1, 9])
def test_blockell_pad_blocks_to_equal(pad):
    shape, r, c, v = ragged_triples()
    got = BlockELL.from_coo(COO(shape, r, c, v), block_shape=(8, 128), pad_blocks_to=pad)
    want = JBlockELL.from_coo(JCOO(shape, r, c, v), block_shape=(8, 128), pad_blocks_to=pad)
    assert_blockell_equal(got, want)
    assert got.max_blocks_per_row == max(pad, 6)


def test_blockell_to_dense_is_the_matrix():
    shape, r, c, v = CASES["duplicates"]()
    coo = COO(shape, r, c, v)
    np.testing.assert_array_equal(
        BlockELL.from_coo(coo, block_shape=(8, 128)).to_dense(), coo.to_dense()
    )


@pytest.mark.parametrize("block", [(8, 128), (8, 8)])
@pytest.mark.parametrize("case", ["random", "ragged", "empty", "duplicates"])
def test_blockell_to_device_meta_equal(case, block):
    shape, r, c, v = CASES[case]()
    w = BlockELL.from_coo(COO(shape, r, c, v), block_shape=block, pad_blocks_to=3)
    jw = JBlockELL.from_coo(JCOO(shape, r, c, v), block_shape=block, pad_blocks_to=3)
    got, want = blockell_to_device(w, "cpu"), j_to_device(jw)
    np.testing.assert_array_equal(got["meta"].numpy(), np.asarray(want["meta"]))
    np.testing.assert_array_equal(got["blocks"].numpy(), np.asarray(want["blocks"]))
    assert str(got["meta"].dtype) == "torch.int32"


def test_masked_slots_reuse_neighbour_indices():
    """The case of the JAX package's own test: a masked slot carries the
    previous valid slot's (block col, w-slot)."""
    rng = np.random.default_rng(0)
    dense = np.zeros((24, 32), np.float32)
    dense[0, :8] = 1.0  # row block 0: one valid block
    dense[8:16, :] = rng.random((8, 32)).astype(np.float32)  # full row
    dense[16, 24] = 3.0  # row block 2: only its last block
    w = BlockELL.from_coo(COO.from_dense(dense), block_shape=(8, 8))
    meta = blockell_to_device(w, "cpu")["meta"].numpy().reshape(3, -1, 3)
    np.testing.assert_array_equal(
        meta, np.asarray(j_to_device(JBlockELL.from_coo(
            JCOO.from_dense(dense), block_shape=(8, 8)))["meta"]).reshape(3, -1, 3)
    )
    for rb in range(meta.shape[0]):
        prev = None
        for col, mask, slot in meta[rb]:
            if mask:
                prev = (col, slot)
            elif prev is not None:
                assert (col, slot) == prev, rb
    assert meta[2, 0].tolist() == [3, 1, 0] and meta[2, 1].tolist() == [3, 0, 0]
