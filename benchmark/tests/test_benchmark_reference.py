"""The plain reference against dense NumPy at tiny sizes, its frozen
generators against the port's, and the comparisons that decide
``correct``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import generators
from benchmark.reference import mcl as ref_mcl
from benchmark.reference.compare import compare_csr, compare_flows
from benchmark.reference.spgemm import csr_matmul


def _dense(csr):
    (m, n), indptr, indices, data = csr
    indptr, indices, data = (np.asarray(torch.as_tensor(x).cpu()) for x in (indptr, indices, data))
    d = np.zeros((m, n))
    rows = np.repeat(np.arange(m), np.diff(indptr))
    np.add.at(d, (rows, indices), data.astype(np.float64))
    return d


def _random_csr(m, n, density, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random((m, n)) < density) * (rng.random((m, n)) + 0.5)
    d[m // 2] = 0.0  # an empty row
    rows, cols = np.nonzero(d)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
    return (m, n), indptr, cols.astype(np.int32), d[rows, cols].astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("block", [1 << 24, 7, 1])
@pytest.mark.parametrize("shape", [(30, 40, 20), (64, 64, 64), (1, 5, 1)])
def test_csr_matmul_equals_dense(shape, block):
    m, k, n = shape
    *a, da = _random_csr(m, k, 0.2, 1)
    *b, db = _random_csr(k, n, 0.2, 2)
    c = csr_matmul(tuple(a), tuple(b), block_products=block)
    want = da.astype(np.float64) @ db.astype(np.float64)
    np.testing.assert_allclose(_dense(c), want, rtol=1e-12, atol=0)
    # exactly the structure of the products that exist (values are positive)
    assert int(c[2].shape[0]) == int(np.count_nonzero(want))


def test_bfloat16_control_rounds_values():
    *a, da = _random_csr(50, 50, 0.2, 3)
    ref = csr_matmul(tuple(a), tuple(a))
    ctl = csr_matmul(tuple(a), tuple(a), precision="bfloat16")
    got = compare_csr(tuple(x.numpy() if torch.is_tensor(x) else x for x in ctl), ref)
    assert got["struct_mismatch"] == 0 and 1e-4 < got["val_rel_err"] < 2e-2
    with pytest.raises(ValueError):
        csr_matmul(tuple(a), tuple(a), precision="float16")


def test_generators_equal_the_ports():
    from outerspace_tpu_torch.formats.generators import erdos_renyi, rmat

    for mine, port in (
        (generators.rmat(9, edge_factor=8, seed=11), rmat(9, edge_factor=8, seed=11).to_csr()),
        (generators.erdos_renyi(700, 900, 0.01, seed=12), erdos_renyi(700, 900, 0.01, seed=12).to_csr()),
        (generators.erdos_renyi(5000, 5000, 1e-3, seed=13), erdos_renyi(5000, 5000, 1e-3, seed=13).to_csr()),
    ):
        assert mine[0] == port.shape
        for x, y in zip(mine[1:], (port.indptr, port.indices, port.data)):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_call_values_depend_on_seed_and_call_alone():
    a = generators.call_values(2**31 + 5, 3, 100)
    assert np.array_equal(a, generators.call_values(2**31 + 5, 3, 100))
    assert not np.array_equal(a, generators.call_values(2**31 + 5, 4, 100))
    assert not np.array_equal(a, generators.call_values(2**31 + 6, 3, 100))
    assert not np.array_equal(generators.call_values(7, -1, 100), generators.call_values(7, 1, 100))
    assert a.dtype == np.float32 and a.min() >= 0.5 and a.max() < 1.5


def _dense_mcl(flow_dense, iters, inflation, threshold):
    m = flow_dense.astype(np.float64)
    for _ in range(iters):
        s = m @ m
        p = np.maximum(s, 0.0) ** inflation
        p[p <= threshold] = 0.0
        cs = p.sum(0)
        cs[cs == 0] = 1.0
        m = p / cs
    return m


def test_flow_and_mcl_equal_dense():
    g = generators.rmat(6, edge_factor=4, seed=3)
    flow = ref_mcl.flow_of(g)
    d = _dense(g)
    d = np.abs(d) + np.eye(d.shape[0])
    np.testing.assert_allclose(_dense(flow), d / d.sum(0), rtol=1e-6)
    out, uncertain, near = ref_mcl.mcl(flow, iters=3, inflation=2.0, threshold=1e-3, band=1e-6)
    want = _dense_mcl(_dense(flow), 3, 2.0, 1e-3)
    np.testing.assert_allclose(_dense(out), want, rtol=1e-12, atol=1e-15)
    assert int(out[2].shape[0]) == int(np.count_nonzero(want))
    assert len(near) == 3 and not bool(uncertain.any())


def test_uncertain_columns_spread_through_the_squaring():
    # a threshold that one entry of the first squaring equals exactly
    g = generators.rmat(5, edge_factor=4, seed=4)
    flow = ref_mcl.flow_of(g)
    sq = _dense(flow).astype(np.float64) @ _dense(flow).astype(np.float64)
    v = np.unique(sq[sq > 0])[len(np.unique(sq[sq > 0])) // 2]
    _, uncertain, near = ref_mcl.mcl(flow, iters=2, inflation=2.0, threshold=float(v) ** 2, band=1e-9)
    assert near[0] >= 1
    col = int(np.nonzero(np.isclose(sq, v, rtol=1e-12))[1][0])
    assert bool(uncertain[col])
    # the next squaring mixes that column into the columns of its row
    first = ref_mcl.mcl(flow, iters=1, inflation=2.0, threshold=float(v) ** 2)[0]
    row = _dense(first)[col]
    assert all(bool(uncertain[j]) for j in np.nonzero(row)[0])


def test_compare_csr_counts_and_errors():
    *a, _ = _random_csr(20, 20, 0.3, 5)
    a = tuple(a)
    assert compare_csr(a, a) == {"struct_mismatch": 0, "val_rel_err": 0.0}
    (shape, indptr, indices, data) = a
    bumped = (shape, indptr, indices, data * np.float32(1.001))
    assert compare_csr(bumped, a)["val_rel_err"] == pytest.approx(1e-3, rel=1e-3)
    # the first row's first entry dropped
    r0 = int(indptr[1] - indptr[0])
    assert r0 > 0
    fewer = (shape, np.concatenate([[0], indptr[1:] - 1]), np.delete(indices, 0), np.delete(data, 0))
    got = compare_csr(fewer, a)
    assert got["struct_mismatch"] == 1 and got["val_rel_err"] == 0.0
    assert compare_csr(((21, 20),) + a[1:], a)["struct_mismatch"] > 0


def test_compare_flows_leaves_out_uncertain_columns():
    g = generators.rmat(6, edge_factor=4, seed=6)
    flow = ref_mcl.flow_of(g)
    want, _, _ = ref_mcl.mcl(flow, iters=2, inflation=2.0, threshold=1e-4)
    (shape, indptr, indices, data) = (want[0],) + tuple(np.asarray(x) for x in want[1:])
    # a value changed in column c: a mismatch unless c is uncertain
    c = int(indices[0])
    changed = data.copy()
    changed[0] *= 1.01
    got = (shape, indptr, indices, changed)
    none = torch.zeros(shape[0], dtype=torch.bool)
    assert compare_flows(got, want, none)["val_rel_err"] == pytest.approx(0.01, rel=1e-6)
    only_c = none.clone()
    only_c[c] = True
    out = compare_flows(got, want, only_c)
    assert out["val_rel_err"] < 1e-12 and out["uncertain_share"] == pytest.approx(1 / shape[0])
    assert out["struct_mismatch"] == 0 and out["cluster_mismatch"] == 0


def test_make_scrambles_one_graph_per_configuration():
    import json

    from benchmark.tests.conftest import REPO
    from benchmark.work.a2 import a2_work

    config = json.loads((REPO / "benchmark" / "configs" / "rmat15_ef16.json").read_text())
    config["scale"] = 7
    a = generators.make(config)
    raw = generators.symmetrize(generators.rmat(7, edge_factor=16, seed=config["graph_seed"]))
    assert a[2].shape == raw[2].shape and not np.array_equal(a[2], raw[2])
    assert sorted(np.diff(a[1])) == sorted(np.diff(raw[1]))
    assert np.array_equal(np.sort(a[3]), np.sort(raw[3]))
    assert a2_work(*a[:3], 0) == a2_work(*raw[:3], 0)
    assert np.array_equal(generators.make(config)[2], a[2])


def test_symmetrize_and_mirror():
    g = generators.rmat(7, edge_factor=4, seed=5)
    s = generators.symmetrize(g)
    n = s[0][0]
    dense = np.zeros((n, n), np.float32)
    rows = np.repeat(np.arange(n), np.diff(g[1]))
    np.add.at(dense, (rows, g[2]), g[3])
    want = dense + dense.T
    got = np.zeros((n, n), np.float32)
    got[np.repeat(np.arange(n), np.diff(s[1])), s[2]] = s[3]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert s[2].shape[0] == np.count_nonzero(want)
    m = generators.mirror(s)
    r = np.repeat(np.arange(n), np.diff(s[1]))
    assert np.array_equal(r[m], s[2]) and np.array_equal(s[2][m], r)
    assert np.array_equal(m[m], np.arange(m.shape[0]))


def test_symmetric_cell_values_are_symmetric():
    import json

    from benchmark.entries.a2 import Entry
    from benchmark.tests.conftest import REPO

    config = json.loads((REPO / "benchmark" / "configs" / "rmat15_ef16.json").read_text())
    config["scale"] = 6
    e = Entry(config, {"strategy": "auto", "check_calls": 1}, 2**31 + 9, "cpu", program=lambda op: None)
    e.stage(2)
    (n, _), indptr, indices, vals = e.operand(0)
    dense = np.zeros((n, n), np.float32)
    dense[np.repeat(np.arange(n), np.diff(indptr)), indices] = vals
    assert np.array_equal(dense, dense.T)
    assert np.array_equal(vals, e.values(0)) and not np.array_equal(vals, e.operand(1)[3])
    assert e.drawn_in_window == 0
    e.operand(2)
    assert e.drawn_in_window == 1
