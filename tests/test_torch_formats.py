"""The port's formats layer vs the JAX package's: generators bit-identical
for the same seed, compressed containers and the Matrix Market reader
array-equal, and ``convert`` carrying an operand across."""

import os

import numpy as np
import pytest

from outerspace_tpu import formats as jf
from outerspace_tpu.formats.mtx import _read_mtx_python
from outerspace_tpu_torch import formats as tf
from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays

MTX_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "mtx")


def assert_coo_equal(t, j):
    assert t.shape == j.shape
    for f in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
        assert getattr(t, f).dtype == getattr(j, f).dtype


@pytest.mark.parametrize(
    "args", [(64, 64, 0.08, 1), (48, 96, 0.1, 3), (5000, 4000, 1e-3, 7), (100_000, 100_000, 1e-6, 3)],
    ids=lambda a: f"er{a[0]}x{a[1]}",
)
def test_erdos_renyi_bit_identical(args):
    m, n, d, seed = args
    assert_coo_equal(tf.erdos_renyi(m, n, d, seed=seed), jf.erdos_renyi(m, n, d, seed=seed))


@pytest.mark.parametrize("scale,ef,seed", [(6, 8, 5), (10, 8, 1), (9, 16, 41)])
def test_rmat_bit_identical(scale, ef, seed):
    assert_coo_equal(tf.rmat(scale, edge_factor=ef, seed=seed), jf.rmat(scale, edge_factor=ef, seed=seed))


@pytest.mark.parametrize("kind", ["ones", "uniform", "normal"])
def test_value_kinds_bit_identical(kind):
    assert_coo_equal(tf.erdos_renyi(30, 40, 0.2, seed=2, values=kind),
                     jf.erdos_renyi(30, 40, 0.2, seed=2, values=kind))
    with pytest.raises(ValueError):
        tf.erdos_renyi(4, 4, 0.5, values="bogus")


def test_compressed_containers_equal():
    j = jf.rmat(7, edge_factor=4, seed=9)
    t = tf.COO(j.shape, j.row, j.col, j.val)
    for conv in ("to_csr", "to_csc"):
        tc, jc = getattr(t, conv)(), getattr(j, conv)()
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f), err_msg=f"{conv}.{f}")
    back = t.to_csr().to_csc().to_csr().to_coo()
    np.testing.assert_array_equal(back.to_scipy().toarray(), j.to_scipy().toarray())
    assert_coo_equal(tf.COO.from_scipy(j.to_scipy()), jf.COO.from_scipy(j.to_scipy()))
    assert t.transpose().shape == (j.shape[1], j.shape[0])
    with pytest.raises(ValueError):
        tf.COO((2, 2), [0, 2], [0, 0], [1.0, 1.0])


@pytest.mark.parametrize("name", sorted(os.listdir(MTX_DIR)) if os.path.isdir(MTX_DIR) else [])
def test_read_mtx_matches_python_reader(name):
    path = os.path.join(MTX_DIR, name)
    assert_coo_equal(tf.read_mtx(path), _read_mtx_python(path))


def test_read_mtx_symmetric_pattern_and_gzip(tmp_path):
    import gzip

    text = "%%MatrixMarket matrix coordinate pattern symmetric\n% c\n3 3 2\n1 2\n3 3\n"
    p = tmp_path / "s.mtx"
    p.write_text(text)
    with gzip.open(tmp_path / "s.mtx.gz", "wt") as f:
        f.write(text)
    for path in (str(p), str(tmp_path / "s.mtx.gz")):
        got = tf.read_mtx(path)
        assert got.shape == (3, 3)
        assert sorted(zip(got.row.tolist(), got.col.tolist())) == [(0, 1), (1, 0), (2, 2)]
        np.testing.assert_array_equal(got.val, np.ones(3, np.float32))
    assert_coo_equal(tf.read_mtx(str(p)), _read_mtx_python(str(p)))


def test_convert_carries_operands():
    j = jf.erdos_renyi(50, 40, 0.1, seed=4)
    jr, jc = j.to_csr(), j.to_csc()
    tr = csr_from_arrays(jr.shape, jr.indptr, jr.indices, jr.data)
    tc = csc_from_arrays(jc.shape, jc.indptr, jc.indices, jc.data)
    assert isinstance(tr, tf.CSR) and isinstance(tc, tf.CSC)
    for t, src in ((tr, jr), (tc, jc)):
        assert t.shape == src.shape
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(t, f), getattr(src, f))
            assert not np.shares_memory(getattr(t, f), getattr(src, f))
