"""The port's native host routines and format pieces against the JAX
package's: the C++ Matrix Market reader equal to the port's Python
reader and to the JAX package's ``read_mtx`` on general, symmetric,
skew-symmetric, pattern and gzipped files this test writes and on
``data/mtx``; its failures raise (no fallback to Python);
``ref_spgemm_native`` equal to the JAX package's and to scipy;
``COO.dupcheck``, ``CompactCOO`` and ``banded`` equal to the JAX
package's."""

import gzip
import os

import numpy as np
import pytest

from outerspace_tpu import formats as jf
from outerspace_tpu.formats.compact import CompactCOO as JCompactCOO
from outerspace_tpu.runtime import native as jnative
from outerspace_tpu_torch import formats as tf
from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays
from outerspace_tpu_torch.ops.reference import spgemm_scipy
from outerspace_tpu_torch.runtime import native

MTX_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "mtx")

FILES = {
    "general": "%%MatrixMarket matrix coordinate real general\n% a comment\n4 5 4\n"
               "1 1 1.5\n2 5 -2.25e-3\n\n4 3 3.4e38\n% inside\n3 2 7\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n3 3 3\n1 1 2\n2 1 0.5\n3 2 -1\n",
    "skew": "%%MatrixMarket matrix coordinate real skew-symmetric\n3 3 2\n2 1 4\n3 1 -0.125\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n2 3 3\n1 2\n2 3\n1 1\n",
    "no_banner": "% plain header\n2 2 2\n1 2 0.1\n2 1\n",
    "crlf": "%%MatrixMarket matrix coordinate real general\r\n2 2 2\r\n1 1 3.25\r\n2 2 1e-40\r\n",
}


def assert_coo_equal(got, want):
    assert got.shape == want.shape
    for f in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def write(tmp_path, name, text, gz=False):
    path = tmp_path / (name + (".mtx.gz" if gz else ".mtx"))
    if gz:
        with gzip.open(path, "wt", newline="") as f:
            f.write(text)
    else:
        path.write_bytes(text.encode())
    return str(path)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("expand", [True, False], ids=["expand", "as_stored"])
@pytest.mark.parametrize("name", sorted(FILES))
def test_native_reader_equal_python_and_jax(tmp_path, name, expand, gz):
    path = write(tmp_path, name, FILES[name], gz)
    got = tf.read_mtx(path, expand_symmetric=expand)
    assert_coo_equal(got, tf.read_mtx(path, expand_symmetric=expand, native=False))
    assert_coo_equal(got, jf.read_mtx(path, expand_symmetric=expand))
    if not gz:
        assert_coo_equal(got, native.read_mtx_native(path, expand_symmetric=expand))


@pytest.mark.parametrize("name", sorted(os.listdir(MTX_DIR)) if os.path.isdir(MTX_DIR) else [])
def test_native_reader_on_fixtures(name):
    path = os.path.join(MTX_DIR, name)
    got = tf.read_mtx(path)
    assert_coo_equal(got, tf.read_mtx(path, native=False))
    assert_coo_equal(got, jf.read_mtx(path))


def test_native_reader_failures_raise(tmp_path, monkeypatch):
    missing = str(tmp_path / "none.mtx")
    for path in (missing, missing + ".gz"):
        with pytest.raises(FileNotFoundError):
            tf.read_mtx(path)
    bad = write(tmp_path, "bad", "%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n")
    with pytest.raises(OSError, match="refused"):
        tf.read_mtx(bad)
    with pytest.raises(ValueError):  # the Python reader refuses it too
        tf.read_mtx(bad, native=False)
    # a failed build is not hidden behind the Python reader
    good = write(tmp_path, "good", FILES["general"])

    def broken(name):
        raise RuntimeError(f"g++ failed on {name}.cpp")

    monkeypatch.setattr(native, "host_library", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on mtx_reader.cpp"):
        tf.read_mtx(good)
    assert tf.read_mtx(good, native=False).nnz == 4


@pytest.mark.parametrize("pair", ["rmat7", "er_rect", "banded"])
def test_ref_spgemm_native_equal_jax_and_scipy(pair):
    a, b = {
        "rmat7": lambda: (jf.rmat(7, edge_factor=8, seed=2),) * 2,
        "er_rect": lambda: (jf.erdos_renyi(50, 40, 0.08, seed=1), jf.erdos_renyi(40, 70, 0.1, seed=2)),
        "banded": lambda: (jf.banded(90, 3, seed=1), jf.erdos_renyi(90, 90, 0.05, seed=5)),
    }[pair]()
    ja, jb = a.to_csc(), b.to_csr()
    got = native.ref_spgemm_native(csc_from_arrays(ja.shape, ja.indptr, ja.indices, ja.data),
                                   csr_from_arrays(jb.shape, jb.indptr, jb.indices, jb.data))
    want = jnative.ref_spgemm_native(ja, jb)
    assert want is not None, "the JAX package's native library did not build"
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    pa, pb = (tf.COO(x.shape, x.row, x.col, x.val) for x in (a, b))
    sc = spgemm_scipy(pa, pb)
    np.testing.assert_array_equal(got.indptr, sc.indptr)
    np.testing.assert_array_equal(got.indices, sc.indices)
    np.testing.assert_allclose(got.data, sc.data, rtol=1e-5)


def test_ref_spgemm_native_refuses_mismatch():
    a = tf.erdos_renyi(8, 5, 0.5, seed=1)
    with pytest.raises(ValueError, match="inner dimensions"):
        native.ref_spgemm_native(a.to_csc(), a.to_csr())


@pytest.mark.parametrize("dup", [None, (3, 4), (0, 0)])
def test_dupcheck_equal_jax(dup):
    j = jf.erdos_renyi(20, 30, 0.2, seed=6)
    row, col, val = j.row, j.col, j.val
    if dup is not None:
        row = np.concatenate([row, [dup[0]], row[:1]])
        col = np.concatenate([col, [dup[1]], col[:1]])
        val = np.concatenate([val, [1.0], val[:1]])
    t, jj = tf.COO(j.shape, row, col, val), jf.COO(j.shape, row, col, val)
    try:
        jj.dupcheck()
    except jf.DuplicateCoordinateError as e:
        with pytest.raises(tf.DuplicateCoordinateError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
            t.dupcheck()
        assert issubclass(tf.DuplicateCoordinateError, ValueError)
    else:
        assert dup is None
        t.dupcheck()


@pytest.mark.parametrize("coo", ["er", "rmat", "empty"])
def test_compact_coo_equal_jax(coo):
    j = {"er": lambda: jf.erdos_renyi(40, 25, 0.15, seed=2),
         "rmat": lambda: jf.rmat(6, edge_factor=4, seed=8),
         "empty": lambda: jf.COO((5, 4), [], [], [])}[coo]()
    t = tf.COO(j.shape, j.row, j.col, j.val)
    got, want = tf.CompactCOO.from_csr(t.to_csr()), JCompactCOO.from_csr(j.to_csr())
    assert got.shape == want.shape and got.nnz == want.nnz == j.nnz
    assert len(got.groups) == len(want.groups)
    for g, w in zip(got.groups, want.groups):
        for gi, wi in zip(g, w):
            np.testing.assert_array_equal(gi, wi)
    assert_coo_equal(got.to_coo(), want.to_coo())
    assert got.sanity_check(t.to_csr()) and want.sanity_check(j.to_csr())
    if t.nnz:  # a changed value fails the round trip
        got.groups[0][2][0] += 1.0
        assert not got.sanity_check(t.to_csr())


@pytest.mark.parametrize("n,bw,seed", [(1, 0, 0), (16, 2, 3), (100, 7, 1), (5, 9, 2)])
def test_banded_bit_identical(n, bw, seed):
    assert_coo_equal(tf.banded(n, bw, seed=seed), jf.banded(n, bw, seed=seed))
