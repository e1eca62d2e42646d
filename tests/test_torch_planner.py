"""The port's tile planner, cost model and tiled plans vs the JAX
package's, field for field and array for array.

Both planners pick tile classes and the waste limit with the cost
model's weights. The port's are times measured on the card; the JAX
package's per-class weights come from its native event model when that
library is built and from one flat weight otherwise. Every test here
first sets the port's weights to the JAX package's (its live
``tile_ns`` per class), so the plans must agree either way.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from outerspace_tpu.formats import COO, rmat
from outerspace_tpu.sched import autotune as jat
from outerspace_tpu.sched import planner as jpl
from outerspace_tpu.shard.mesh import balanced_contiguous_partition as j_partition
from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays, tiled_plan_from_arrays
from outerspace_tpu_torch.sched import autotune as tat
from outerspace_tpu_torch.sched import planner as tpl
from outerspace_tpu_torch.shard.mesh import balanced_contiguous_partition as t_partition

import torch_cases  # tests/ is on sys.path under pytest

big_shape_pair = functools.partial(torch_cases.big_shape_pair, COO)
dense_blocks = functools.partial(torch_cases.dense_blocks, COO)

# the modules (each package's ``ops`` also exports the function ``spgemm``)
jsp = importlib.import_module("outerspace_tpu.ops.spgemm")
tsp = importlib.import_module("outerspace_tpu_torch.ops.spgemm")


@pytest.fixture(autouse=True)
def jax_weights(monkeypatch):
    torch_cases.set_jax_cost_weights(monkeypatch, jat, tat, tpl.TILE_A_CLASSES)


def port_operands(a, b):
    a_csc, b_csr = a.to_csc(), b.to_csr()
    return (
        (a_csc, b_csr),
        (
            csc_from_arrays(a_csc.shape, a_csc.indptr, a_csc.indices, a_csc.data),
            csr_from_arrays(b_csr.shape, b_csr.indptr, b_csr.indices, b_csr.data),
        ),
    )


CASES = {
    "rmat8_ef16": lambda: (rmat(8, edge_factor=16, seed=1),) * 2,
    "rmat10_ef8": lambda: (rmat(10, edge_factor=8, seed=1),) * 2,
    "dense_blocks": dense_blocks,
    "big_shape": big_shape_pair,
}


@pytest.fixture(params=sorted(CASES), ids=str)
def case(request):
    return CASES[request.param]()


def assert_schedules_equal(js, ts):
    for f in ("tile_a", "heavy_p", "ntasks", "ntasks_padded", "slab_layout"):
        assert getattr(js, f) == getattr(ts, f), f
    for f in ("a_start", "a_len", "b_block", "b_lo", "b_hi", "a_rows_t", "a_vals_t", "heavy_k"):
        np.testing.assert_array_equal(getattr(js, f), getattr(ts, f), err_msg=f)
        assert getattr(js, f).dtype == getattr(ts, f).dtype, f


def assert_class_plans_equal(jcp, tcp):
    assert len(jcp.classes) == len(tcp.classes)
    for js, ts in zip(jcp.classes, tcp.classes):
        assert_schedules_equal(js, ts)
    assert jcp.light_p == tcp.light_p
    for f in ("light_k", "edge_k", "edge_jb", "edge_len"):
        np.testing.assert_array_equal(getattr(jcp, f), getattr(tcp, f), err_msg=f)


def assert_arrays_equal(jd, td, name):
    assert jd.keys() <= td.keys(), name
    for k in jd:
        np.testing.assert_array_equal(np.asarray(jd[k]), np.asarray(td[k]), err_msg=f"{name}.{k}")


def assert_tiled_plans_equal(jp, tp):
    assert type(jp).__name__ == type(tp).__name__
    if hasattr(jp, "parts"):
        for f in ("m", "n", "merge_pad", "rebased", "padded_total"):
            assert getattr(jp, f) == getattr(tp, f), f
        assert [(lo, hi) for lo, hi, _ in jp.parts] == [(lo, hi) for lo, hi, _ in tp.parts]
        for (_, _, jpart), (_, _, tpart) in zip(jp.parts, tp.parts):
            assert_tiled_plans_equal(jpart, tpart)
        return
    for f in ("m", "n", "light_pad", "gather_ngroups", "gather_p_out",
              "gather_p_real", "gather_b_win", "gather_call_bits", "padded_total"):
        assert getattr(jp, f) == getattr(tp, f), f
    assert jsp.tiled_pad_count(jp) == tsp.tiled_pad_count(tp)
    assert_class_plans_equal(jp.class_plan, tp.class_plan)
    jd, td = jp.device_args, tp.device_args
    assert jd.keys() == td.keys()
    for i, (jc, tc) in enumerate(zip(jd["classes"], td["classes"])):
        assert (jc is None) == (tc is None)
        if jc is not None:
            assert_arrays_equal(jc, tc, f"class{i}")
    if "gather" in jd:
        assert_arrays_equal(jd["gather"], td["gather"], "gather")
    if "light" in jd:
        assert_arrays_equal(jd["light"], td["light"], "light")
        for f in ("a_rows", "a_k", "offsets", "b_cols"):
            np.testing.assert_array_equal(getattr(jp.light_plan, f), getattr(tp.light_plan, f))


@pytest.mark.parametrize("waste_limit", [1.05, 1.1, 2.0])
def test_plan_outer_classes_equal(case, waste_limit):
    (ja, jb), (ta, tb) = port_operands(*case)
    assert_class_plans_equal(
        jpl.plan_outer_classes(ja, jb, waste_limit=waste_limit),
        tpl.plan_outer_classes(ta, tb, waste_limit=waste_limit),
    )


@pytest.mark.parametrize("waste_limit", [1.05, 1.1, 2.0])
def test_plan_outer_classes_equal_zoo(operand_pair, waste_limit):
    (ja, jb), (ta, tb) = port_operands(*operand_pair)
    for gather_edges in (None, False):
        assert_class_plans_equal(
            jpl.plan_outer_classes(ja, jb, waste_limit=waste_limit, gather_edges=gather_edges),
            tpl.plan_outer_classes(ta, tb, waste_limit=waste_limit, gather_edges=gather_edges),
        )


def test_plan_outer_classes_rescue_pass_equal():
    # the rescue pass (no gather edges): wide B rows take whole-row tiles
    (ja, jb), (ta, tb) = port_operands(*dense_blocks())
    jcp = jpl.plan_outer_classes(ja, jb, gather_edges=False)
    tcp = tpl.plan_outer_classes(ta, tb, gather_edges=False)
    assert_class_plans_equal(jcp, tcp)
    assert tcp.edge_k.shape[0] == 0 and sum(c.ntasks for c in tcp.classes) > 0


def test_autotune_equal(case, operand_pair):
    for a, b in (case, operand_pair):
        (ja, jb), (ta, tb) = port_operands(a, b)
        assert jat.autotune(ja, jb)[1] == tat.best_waste_limit(ta, tb)
        na = ta.major_nnz().astype(np.int64)
        nb = tb.major_nnz().astype(np.int64)
        b_mis = np.asarray(tb.indptr)[:-1].astype(np.int64) % 128
        for wl in tat.WASTE_GRID:
            for edges in (True, False):
                kw = dict(gather_edges=edges, b_mis=b_mis)
                assert jat.modeled_cost_ns(na, nb, wl, **kw) == tat.modeled_cost_ns(na, nb, wl, **kw)
                assert jat._class_totals(na, nb, wl, **kw) == tuple(tat._class_totals(na, nb, wl, **kw))


def test_cost_model_constants_equal():
    # the weights equal under the fixture; the rest of the model is shared
    for f in ("SORT_NS", "TILE_NS", "GATHER_NS", "FLAT_NS", "GATHER_MAX_NB", "WASTE_GRID"):
        assert getattr(jat, f) == getattr(tat, f), f
    assert {ta: tat.tile_ns(ta) for ta in tpl.TILE_A_CLASSES} == {
        ta: jat.tile_ns(ta) for ta in tpl.TILE_A_CLASSES}
    assert tpl.TILE_A_CLASSES == jpl.TILE_A_CLASSES and tpl.TILE_B == jpl.TILE_B


def test_trim_split_equal():
    rng = np.random.default_rng(3)
    na = rng.integers(0, 300, size=2000)
    nb = rng.integers(0, 1200, size=2000)
    b_mis = rng.integers(0, 128, size=2000)
    cand = rng.random(2000) < 0.7
    for j, t in zip(jpl.trim_split(na, nb, b_mis, cand), tpl.trim_split(na, nb, b_mis, cand)):
        np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 7])
def test_balanced_partition_equal(parts):
    rng = np.random.default_rng(parts)
    w = rng.integers(0, 50, size=300).astype(np.float64)
    w[100:150] = 0
    np.testing.assert_array_equal(j_partition(w, parts), t_partition(w, parts))


def both_plans(a, b, fn_j, fn_t, **kw):
    (ja, jb), (ta, tb) = port_operands(a, b)
    return fn_j(ja, jb, **kw), fn_t(ta, tb, device="cpu", **kw)


@pytest.mark.parametrize("waste_limit", [None, 1.05, 1.1, 2.0])
def test_plan_tiled_equal(case, waste_limit):
    jp, tp = both_plans(*case, jsp.plan_tiled, tsp.plan_tiled, waste_limit=waste_limit)
    assert_tiled_plans_equal(jp, tp)


def test_plan_tiled_equal_zoo(operand_pair):
    assert_tiled_plans_equal(*both_plans(*operand_pair, jsp.plan_tiled, tsp.plan_tiled))


PARTS = {
    # forced splits of small rmats, with tile tasks inside the parts
    "forced2": (lambda: (rmat(9, edge_factor=16, seed=1),) * 2,
                dict(nparts=2, min_part_stream=1, budget=10.0)),
    "forced4": (lambda: (rmat(9, edge_factor=16, seed=1),) * 2,
                dict(nparts=4, min_part_stream=1, budget=10.0)),
    "waste105": (lambda: (rmat(8, edge_factor=16, seed=1),) * 2,
                 dict(nparts=2, min_part_stream=1, budget=10.0, waste_limit=1.05)),
    # the fragmentation guard: kept at a loose budget, refused at 1.0
    "guard_kept": (lambda: (rmat(10, edge_factor=8, seed=1),) * 2,
                   dict(nparts=4, min_part_stream=1, budget=10.0)),
    "guard_refused": (lambda: (rmat(10, edge_factor=8, seed=1),) * 2,
                      dict(nparts=4, min_part_stream=1, budget=1.0)),
    # too small to split: the single plan
    "single": (lambda: (rmat(7, edge_factor=8, seed=11).deduplicated(),) * 2, {}),
    # m·n > 2³²: rebased row parts
    "rebased": (big_shape_pair, {}),
    "rebased_wide": (lambda: big_shape_pair(seed=1), dict(budget=10.0)),
}


@pytest.mark.parametrize("name", sorted(PARTS))
def test_plan_tiled_parts_equal(name):
    make, kw = PARTS[name]
    jp, tp = both_plans(*make(), jsp.plan_tiled_parts, tsp.plan_tiled_parts, **kw)
    assert_tiled_plans_equal(jp, tp)
    if name.startswith("rebased"):
        assert tp.rebased and all(p.m * p.n <= 2**32 for _, _, p in tp.parts)
    if name.startswith(("forced", "guard_kept")):
        assert len(tp.parts) >= 2
        assert sum(c.ntasks for _, _, p in tp.parts for c in p.class_plan.classes) > 0
    if name in ("single", "guard_refused"):
        assert isinstance(tp, tsp.TiledPlan)


def test_converter_reproduces_jax_plans():
    for make, kw in (PARTS["forced4"], PARTS["rebased"]):
        jp = jsp.plan_tiled_parts(*(x for x in port_operands(*make())[0]), **kw)
        tp = tiled_plan_from_arrays(jp, device="cpu")
        assert_tiled_plans_equal(jp, tp)
        assert all(
            t.device == torch.device("cpu")
            for _, _, p in tp.parts for d in p.device_args["classes"] if d for t in d.values()
        )
    (ja, jb), _ = port_operands(*big_shape_pair())
    jp = jsp.plan_tiled(ja, jb)
    assert jp.light_plan is not None
    assert_tiled_plans_equal(jp, tiled_plan_from_arrays(jp, device="cpu"))
