"""The port's host reference (``ops/reference.py``) against the JAX
package's: ``spgemm_tasks``'s C, FLOP count and multiply / merge task
lists, ``spgemm_reference``, ``spgemm_flops`` and ``compare_coo``'s
verdicts in its relative and absolute modes, all equal."""

import numpy as np
import pytest

from outerspace_tpu.formats import COO as JCOO
from outerspace_tpu.formats import erdos_renyi, rmat
from outerspace_tpu.ops import reference as jref
from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays
from outerspace_tpu_torch.formats import COO
from outerspace_tpu_torch.ops import reference as ref

PAIRS = {
    "rmat6": lambda: (rmat(6, edge_factor=8, seed=5),) * 2,
    "er_rect": lambda: (erdos_renyi(40, 30, 0.1, seed=1), erdos_renyi(30, 50, 0.12, seed=2)),
    "empty_rows": lambda: (erdos_renyi(64, 64, 0.02, seed=3), rmat(6, edge_factor=2, seed=4)),
}


def port_operands(a, b):
    ja, jb = a.to_csc(), b.to_csr()
    return (csc_from_arrays(ja.shape, ja.indptr, ja.indices, ja.data),
            csr_from_arrays(jb.shape, jb.indptr, jb.indices, jb.data), ja, jb)


def assert_csr_equal(got, want):
    assert got.shape == want.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_spgemm_tasks_equal_jax(name):
    a_csc, b_csr, ja, jb = port_operands(*PAIRS[name]())
    got, want = ref.spgemm_tasks(a_csc, b_csr), jref.spgemm_tasks(ja, jb)
    assert_csr_equal(got.c, want.c)
    assert got.flops == want.flops == ref.spgemm_flops(a_csc, b_csr) == jref.spgemm_flops(ja, jb)
    assert len(got.multiply_tasks) == len(want.multiply_tasks)
    for g, w in zip(got.multiply_tasks, want.multiply_tasks):
        assert (g.k, g.out_row, g.a_val, g.flops) == (w.k, w.out_row, w.a_val, w.flops)
        np.testing.assert_array_equal(g.b_cols, w.b_cols)
        np.testing.assert_array_equal(g.b_vals, w.b_vals)
    assert [(t.out_row, t.input_sizes, t.output_nnz, t.ways) for t in got.merge_tasks] == \
        [(t.out_row, t.input_sizes, t.output_nnz, t.ways) for t in want.merge_tasks]
    # without task capture: the same C, no lists
    bare = ref.spgemm_tasks(a_csc, b_csr, with_tasks=False)
    assert_csr_equal(bare.c, got.c)
    assert bare.multiply_tasks == bare.merge_tasks == []


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_spgemm_reference_equal_jax_and_scipy(name):
    a, b = PAIRS[name]()
    pa, pb = (COO(x.shape, x.row, x.col, x.val) for x in (a, b))
    got = ref.spgemm_reference(pa, pb)
    assert_csr_equal(got, jref.spgemm_reference(a, b))
    ref.assert_csr_allclose(got, ref.spgemm_scipy(pa, pb), rtol=1e-5)


def test_spgemm_tasks_refuses_mismatch():
    a, b = erdos_renyi(8, 5, 0.5, seed=1), erdos_renyi(6, 8, 0.5, seed=2)
    a_csc, b_csr, _, _ = port_operands(a, b)
    with pytest.raises(ValueError, match="inner dimensions"):
        ref.spgemm_tasks(a_csc, b_csr)


def perturbed(coo, how):
    row, col, val = coo.row.copy(), coo.col.copy(), coo.val.copy()
    shape = coo.shape
    if how == "scale_1e-7":
        val = val * np.float32(1 + 1e-7)
    elif how == "add_1e-5":
        val = val + np.float32(1e-5)
    elif how == "move":
        col[0] = (col[0] + 1) % shape[1]
    elif how == "drop":
        row, col, val = row[1:], col[1:], val[1:]
    elif how == "shape":
        shape = (shape[0] + 1, shape[1])
    elif how == "zero_both":
        val[0] = 0.0
    elif how == "permuted":
        p = np.random.default_rng(0).permutation(row.size)
        row, col, val = row[p], col[p], val[p]
    return shape, row, col, val


@pytest.mark.parametrize("how", ["same", "scale_1e-7", "add_1e-5", "move", "drop", "shape",
                                 "zero_both", "permuted"])
def test_compare_coo_verdicts_equal_jax(how):
    base = rmat(5, edge_factor=4, seed=3, values="normal")
    if how == "zero_both":
        base.val[0] = 0.0
    other = perturbed(base, how)
    pa, pb = COO(base.shape, base.row, base.col, base.val), COO(*other)
    ja, jb = JCOO(base.shape, base.row, base.col, base.val), JCOO(*other)
    for kw in ({}, {"eps": 1e-8}, {"eps": 1e-4}, {"relative": False}, {"relative": False, "eps": 1e-3}):
        assert ref.compare_coo(pa, pb, **kw) == jref.compare_coo(ja, jb, **kw), kw
    assert ref.compare_coo(pa, pa)
