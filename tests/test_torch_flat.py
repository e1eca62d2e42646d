"""The flat strategy: ``spgemm(strategy="flat", device="cpu")`` against
the JAX package's flat ``spgemm`` and scipy (nnz, indptr and indices
exact; values within rtol 1e-5: the merge sums in another order), its
merged stream slot for slot, the two-key merge past m·n = 2³², the
m·n = 2³² corner, ``p_pad`` and ``spgemm_coo``."""

import functools
import importlib

import numpy as np
import pytest
import torch

from outerspace_tpu.formats import COO, erdos_renyi, rmat
from outerspace_tpu.formats import read_mtx as j_read_mtx
from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays
from outerspace_tpu_torch.formats import COO as TCOO
from outerspace_tpu_torch.formats import read_mtx
from outerspace_tpu_torch.ops import assert_csr_allclose, spgemm_scipy

import torch_cases  # tests/ is on sys.path under pytest

# the modules (each package's ``ops`` also exports the function ``spgemm``)
jsp = importlib.import_module("outerspace_tpu.ops.spgemm")
tsp = importlib.import_module("outerspace_tpu_torch.ops.spgemm")

RTOL, ATOL = 1e-5, 1e-6
big_shape_pair = functools.partial(torch_cases.big_shape_pair, COO)


def port(a, b):
    a_csc, b_csr = a.to_csc(), b.to_csr()
    return (
        csc_from_arrays(a_csc.shape, a_csc.indptr, a_csc.indices, a_csc.data),
        csr_from_arrays(b_csr.shape, b_csr.indptr, b_csr.indices, b_csr.data),
    )


def check_flat(a, b, **kw):
    ta, tb = port(a, b)
    got = tsp.spgemm(ta, tb, strategy="flat", device="cpu", **kw)
    assert_csr_allclose(got, jsp.spgemm(a, b, strategy="flat", **kw), rtol=RTOL, atol=ATOL)
    assert_csr_allclose(got, spgemm_scipy(ta, tb), rtol=RTOL, atol=ATOL)
    return got


def test_flat_matches_jax_and_scipy_zoo(operand_pair):
    check_flat(*operand_pair)


CASES = {
    "rmat8_ef16": lambda: (rmat(8, edge_factor=16, seed=1),) * 2,
    "er_rect": lambda: (erdos_renyi(200, 300, 0.03, seed=5), erdos_renyi(300, 150, 0.04, seed=6)),
    "mesh2d_48": lambda: (j_read_mtx("data/mtx/mesh2d_48.mtx"),) * 2,
}


@pytest.mark.parametrize("packed", [None, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flat_matches_jax_and_scipy(name, packed):
    check_flat(*CASES[name](), packed=packed)


def test_flat_fixture_reads_equal():
    # the port's reader gives the operand the JAX bench forces onto flat
    a = read_mtx("data/mtx/band2048_p5.mtx")
    j = j_read_mtx("data/mtx/band2048_p5.mtx")
    np.testing.assert_array_equal(a.to_csr().indices, j.to_csr().indices)
    got = tsp.spgemm(a, a, strategy="flat", device="cpu")
    assert_csr_allclose(got, spgemm_scipy(a, a), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("packed", [None, False])
def test_merged_stream_matches_jax(packed):
    # the sorted stream's valid slots sit at run ends, which depend only on
    # the key multiset: both packages' merged streams agree slot for slot
    g = erdos_renyi(80, 80, 0.08, seed=2)
    ta, tb = port(g, g)
    jm = jsp.spgemm_padded(jsp.expansion_plan(g.to_csc(), g.to_csr()), packed=packed)
    tm = tsp.spgemm_padded(tsp.expansion_plan(ta, tb), packed=packed, device="cpu")
    for name in ("valid", "rows", "cols"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
    np.testing.assert_allclose(tm.vals.numpy(), np.asarray(jm.vals), rtol=RTOL, atol=ATOL)
    assert int(tm.nnz) == int(jm.nnz)


def test_twokey_merge_past_2e32():
    a, b = big_shape_pair(seed=3)
    ta, tb = port(a, b)
    plan = tsp.expansion_plan(ta, tb)
    assert plan.m * plan.n > 2**32 and not tsp.can_pack(plan)
    assert tsp.can_pack(plan) == jsp.can_pack(jsp.expansion_plan(a.to_csc(), b.to_csr()))
    check_flat(a, b)
    with pytest.raises(ValueError, match="2\\^32"):
        tsp.spgemm_padded(plan, packed=True, device="cpu")


def test_exact_2e32_corner():
    # m·n = 2³² with real products at (m-1, n-1), whose packed key is the
    # sentinel's bit pattern: K2 recovers it through pad_count = p_pad - P
    m = 65536
    a = COO((m, 4), [m - 1, m - 1, 3], [0, 1, 2], [1.5, 2.0, 3.0])
    b = COO((4, m), [0, 1, 2], [m - 1, m - 1, 7], [2.0, 0.5, 1.0])
    got = check_flat(a, b)
    assert got.nnz == 2 and got.to_coo().col.tolist() == [7, m - 1]
    np.testing.assert_allclose(got.data[-1], 1.5 * 2.0 + 2.0 * 0.5)
    for p_pad in (3, 4, 1000):  # no padding slot, one, many
        got = tsp.spgemm(*port(a, b), p_pad=p_pad, device="cpu")
        assert_csr_allclose(got, jsp.spgemm(a, b, p_pad=p_pad), rtol=RTOL, atol=ATOL)


def test_p_pad_rules(monkeypatch):
    g = erdos_renyi(64, 64, 0.08, seed=1)
    ta, tb = port(g, g)
    p = tsp.expansion_plan(ta, tb).expansion_size
    assert p == jsp.expansion_plan(g.to_csc(), g.to_csr()).expansion_size
    calls = []
    real = tsp.spgemm_padded
    with monkeypatch.context() as mp:
        mp.setattr(tsp, "spgemm_padded",
                   lambda plan, p_pad=None, **kw: calls.append(p_pad) or real(plan, p_pad, **kw))
        got = tsp.spgemm(ta, tb, p_pad=p + 7, device="cpu")  # "auto" + p_pad: flat
    assert calls == [p + 7]
    assert_csr_allclose(got, jsp.spgemm(g, g, p_pad=p + 7), rtol=RTOL, atol=ATOL)
    merged = tsp.spgemm_padded(tsp.expansion_plan(ta, tb), p_pad=p + 7, device="cpu")
    assert merged.rows.shape == (p + 7,)
    for strategy in ("tiles", "gather"):
        with pytest.raises(ValueError, match="p_pad"):
            tsp.spgemm(ta, tb, strategy=strategy, p_pad=p + 7, device="cpu")
        with pytest.raises(ValueError, match="p_pad"):
            jsp.spgemm(g, g, strategy=strategy, p_pad=p + 7)
    with pytest.raises(ValueError, match="smaller than expansion size"):
        tsp.spgemm(ta, tb, p_pad=p - 1, device="cpu")
    with pytest.raises(ValueError, match="smaller than expansion size"):
        jsp.spgemm(g, g, p_pad=p - 1)


def test_spgemm_coo_matches_jax():
    g = erdos_renyi(90, 70, 0.06, seed=8)
    h = erdos_renyi(70, 90, 0.06, seed=9)
    ta, tb = port(g, h)
    for p_pad in (None, 4096):
        got = tsp.spgemm_coo(ta, tb, p_pad=p_pad, device="cpu")
        want = jsp.spgemm_coo(g, h, p_pad=p_pad)
        np.testing.assert_array_equal(got.row, want.row)
        np.testing.assert_array_equal(got.col, want.col)
        np.testing.assert_allclose(got.val, want.val, rtol=RTOL, atol=ATOL)


def test_flat_empty_product():
    a = TCOO((6, 5), [0, 3], [1, 2], [1.0, 2.0])
    b = TCOO((5, 4), [0, 4], [1, 3], [1.0, 1.0])
    got = tsp.spgemm(a, b, strategy="flat", device="cpu")
    assert got.nnz == 0 and got.shape == (6, 4) and got.indptr.shape == (7,)
    assert torch.equal(torch.from_numpy(got.indptr), torch.zeros(7, dtype=torch.int64))
