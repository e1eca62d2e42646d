"""The port's whole slice on the CPU: ``spgemm(A, B, device="cpu")`` vs the
JAX package's ``spgemm_gather`` (Pallas kernels in interpret mode) and
vs scipy. indptr and indices exact; data within rtol 1e-5 (the JAX
package's own gather-pipeline tolerance)."""

import functools

import numpy as np
import pytest

import outerspace_tpu.ops.gather_pipeline as jgp
import outerspace_tpu_torch.ops.gather_pipeline as tgp
from outerspace_tpu.formats import COO, erdos_renyi
from outerspace_tpu.ops.reference import spgemm_scipy as j_scipy
from outerspace_tpu.sched import gplanner as jplanner
from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays
from outerspace_tpu_torch.formats import COO as TCOO
from outerspace_tpu_torch.ops import assert_csr_allclose, spgemm, spgemm_scipy
from outerspace_tpu_torch.sched import gplanner as tplanner

RTOL = 1e-5


def port(a, b):
    a_csc, b_csr = a.to_csc(), b.to_csr()
    return (
        csc_from_arrays(a_csc.shape, a_csc.indptr, a_csc.indices, a_csc.data),
        csr_from_arrays(b_csr.shape, b_csr.indptr, b_csr.indices, b_csr.data),
    )


def check_slice(a, b):
    ta, tb = port(a, b)
    got = spgemm(ta, tb, device="cpu")
    want_jax = jgp.spgemm_gather(a, b, interpret=True)
    assert_csr_allclose(got, want_jax, rtol=RTOL)
    assert_csr_allclose(got, spgemm_scipy(ta, tb), rtol=RTOL)
    return got


def test_slice_matches_jax_and_scipy_zoo(operand_pair):
    check_slice(*operand_pair)


def test_slice_multipart_matches_jax(monkeypatch):
    monkeypatch.setattr(
        jgp, "row_partition",
        lambda x, y: jplanner.row_partition(x, y, key_space=12_000),
    )
    monkeypatch.setattr(
        tgp, "row_partition",
        functools.partial(tplanner.row_partition, key_space=12_000),
    )
    a = erdos_renyi(300, 260, 0.02, seed=44)
    ta, tb = port(a, a.transpose())
    assert len(tgp.plan_spgemm_gather(ta, tb, device="cpu").parts) > 1
    check_slice(a, a.transpose())


@pytest.mark.parametrize("side", [50_000, 70_000])
def test_slice_big_key_space(side):
    # 50k²: one part whose biased keys span all of int32; 70k² > 2³²:
    # two parts by the key-space split
    a = erdos_renyi(side, side, 4e-6, seed=side)
    check_slice(a, a)


def test_slice_exact_2e32_corner():
    # m·n = 2³² with real products at (m-1, n-1), whose packed key is
    # the sentinel's bit pattern: recovered through pad_count
    m = 65536
    a = COO((m, 4), [m - 1, m - 1, 3], [0, 1, 2], [1.5, 2.0, 3.0])
    b = COO((4, m), [0, 1, 2], [m - 1, m - 1, 7], [2.0, 0.5, 1.0])
    got = check_slice(a, b)
    assert got.nnz == 2
    assert got.to_coo().col.tolist() == [7, m - 1]
    np.testing.assert_allclose(got.data[-1], 1.5 * 2.0 + 2.0 * 0.5)


def test_merged_stream_layout_matches_jax():
    # Valid slots sit at run ends of the sorted stream, which depend only
    # on the key multiset: the padded streams agree slot for slot.
    g = erdos_renyi(64, 64, 0.08, seed=1)
    ta, tb = port(g, g)
    jm = jgp.spgemm_gather_padded(jgp.plan_spgemm_gather(g.to_csc(), g.to_csr()), interpret=True)
    tm = tgp.spgemm_gather_padded(tgp.plan_spgemm_gather(ta, tb, device="cpu"))
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_array_equal(tm.cols.numpy(), np.asarray(jm.cols))
    np.testing.assert_allclose(tm.vals.numpy(), np.asarray(jm.vals), rtol=RTOL, atol=1e-6)
    assert int(tm.nnz) == int(jm.nnz)


def test_spgemm_strategies_and_empty():
    g = erdos_renyi(64, 64, 0.08, seed=1)
    ta, tb = port(g, g)
    a = spgemm(ta, tb, strategy="gather", device="cpu")
    b = spgemm(ta, tb, strategy="auto", device="cpu")
    np.testing.assert_array_equal(a.indices, b.indices)
    t = spgemm(ta, tb, strategy="tiles", device="cpu")
    np.testing.assert_array_equal(a.indptr, t.indptr)
    np.testing.assert_array_equal(a.indices, t.indices)
    f = spgemm(ta, tb, strategy="flat", device="cpu")
    np.testing.assert_array_equal(a.indptr, f.indptr)
    np.testing.assert_array_equal(a.indices, f.indices)
    np.testing.assert_allclose(a.data, f.data, rtol=RTOL)
    with pytest.raises(ValueError):
        spgemm(ta, tb, strategy="bogus", device="cpu")
    empty = TCOO((5, 3), [], [], [])
    c = spgemm(empty, TCOO((3, 4), [0], [1], [1.0]), device="cpu")
    assert c.shape == (5, 4) and c.nnz == 0 and c.indptr.shape == (6,)
    with pytest.raises(ValueError):
        spgemm(TCOO((2, 3), [0], [0], [1.0]), TCOO((2, 2), [0], [0], [1.0]), device="cpu")


def test_scipy_oracles_agree():
    g = erdos_renyi(48, 96, 0.1, seed=3)
    h = erdos_renyi(96, 32, 0.07, seed=4)
    ta, tb = port(g, h)
    t = spgemm_scipy(ta, tb)
    j = j_scipy(g, h)
    np.testing.assert_array_equal(t.indptr, j.indptr)
    np.testing.assert_array_equal(t.indices, j.indices)
    np.testing.assert_array_equal(t.data, j.data)
