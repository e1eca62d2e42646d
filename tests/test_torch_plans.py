"""The port's host plans and staging vs the JAX package's, array for array.

Identical plans are what let K1 be checked stream for stream, so every
part's scalars and every staged array must be equal. The JAX planner may
run its native C++ core; the port always runs the Python definitions.
"""

import functools

import numpy as np
import pytest

import outerspace_tpu.ops.gather_pipeline as jgp
import outerspace_tpu_torch.ops.gather_pipeline as tgp
from outerspace_tpu.formats import erdos_renyi
from outerspace_tpu.ops.pallas.gexpand import gather_plan_to_host as j_to_host
from outerspace_tpu.sched import gplanner as jplanner
from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays
from outerspace_tpu_torch.ops.kernels.gexpand import (
    gather_plan_to_host as t_to_host,
    group_search_bits,
)
from outerspace_tpu_torch.sched import gplanner as tplanner


def port_operands(a, b):
    """The same operands as the port's containers, through ``convert``."""
    a_csc, b_csr = a.to_csc(), b.to_csr()
    return (
        (a_csc, b_csr),
        (
            csc_from_arrays(a_csc.shape, a_csc.indptr, a_csc.indices, a_csc.data),
            csr_from_arrays(b_csr.shape, b_csr.indptr, b_csr.indices, b_csr.data),
        ),
    )


def force_parts(monkeypatch, key_space):
    """Shrink the key space in both packages' partitioners so small
    operands split into several row parts."""
    monkeypatch.setattr(
        jgp, "row_partition",
        lambda a, b, key_space_=2**32: jplanner.row_partition(a, b, key_space=key_space),
    )
    monkeypatch.setattr(
        tgp, "row_partition",
        functools.partial(tplanner.row_partition, key_space=key_space),
    )


def extra_cases():
    """Beyond the conftest zoo: a forced multi-part plan (the wide B
    window), and two key spaces past 2³¹ (one part; and two parts by
    the 2³² key-space split)."""
    g = erdos_renyi(600, 500, 0.01, seed=44)
    return [
        ("multipart", g, g.transpose(), 60_000),
        ("keys_2e31", erdos_renyi(50_000, 50_000, 4e-6, seed=45), None, None),
        ("keys_2e32", erdos_renyi(70_000, 70_000, 2e-6, seed=46), None, None),
    ]


@pytest.fixture(params=extra_cases(), ids=lambda c: c[0])
def extra_case(request, monkeypatch):
    _, a, b, key_space = request.param
    if key_space is not None:
        force_parts(monkeypatch, key_space)
    return a, (a if b is None else b)


def assert_plans_equal(jp, tp):
    assert (jp.m, jp.n) == (tp.m, tp.n)
    assert len(jp.parts) == len(tp.parts)
    for pj, pt in zip(jp.parts, tp.parts):
        for f in ("row_base", "span", "b_win", "ngroups", "p_out", "p_real",
                  "merge_pad", "call_bits"):
            assert getattr(pj, f) == getattr(pt, f), f
        for k in ("bases", "table", "a_pack", "b_pack"):
            np.testing.assert_array_equal(np.asarray(pj.dev[k]), pt.dev[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(
            pt.dev["group_bits"].numpy(), group_search_bits(pj.call_bits, pj.ngroups)
        )


def plans(a, b):
    (ja, jb), (ta, tb) = port_operands(a, b)
    return jgp.plan_spgemm_gather(ja, jb), tgp.plan_spgemm_gather(ta, tb, device="cpu")


def test_pipeline_plans_equal_zoo(operand_pair):
    assert_plans_equal(*plans(*operand_pair))


def test_pipeline_plans_equal_extra(extra_case):
    jp, tp = plans(*extra_case)
    assert_plans_equal(jp, tp)
    assert len(tp.parts) >= 1


def test_forced_split_plans_wide_window(monkeypatch):
    g = erdos_renyi(600, 500, 0.01, seed=44)
    force_parts(monkeypatch, 60_000)
    jp, tp = plans(g, g.transpose())
    assert len(tp.parts) > 2
    assert {p.b_win for p in tp.parts} == {tplanner.WIDE_B_WIN}
    assert_plans_equal(jp, tp)


@pytest.mark.parametrize("pad", [False, True])
def test_gather_plan_to_host_equal(operand_pair, pad):
    (ja, jb), (ta, tb) = port_operands(*operand_pair)
    jplan, jfb = jplanner.plan_gather_from_csr(ja, jb)
    tplan, tfb = tplanner.plan_gather_from_csr(ta, tb)
    assert (jplan is None) == (tplan is None)
    assert (jfb is None) == (tfb is None)
    if jplan is None:
        return
    for f in ("m", "n", "b_win", "ngroups", "p_out", "p_real"):
        assert getattr(jplan, f) == getattr(tplan, f), f
    for f in ("a_pack", "b_pack", "bases", "table", "group_width"):
        np.testing.assert_array_equal(getattr(jplan, f), getattr(tplan, f), err_msg=f)
    kw = {}
    if pad:
        kw = dict(
            ngroups_pad=jplan.ngroups + 3,
            nab8_pad=jplan.a_pack.shape[0] // 8 + 2,
            nbb8_pad=jplan.b_pack.shape[0] // 8 + 1,
        )
    jh, th = j_to_host(jplan, **kw), t_to_host(tplan, **kw)
    assert jh.keys() == th.keys()
    for k in jh:
        np.testing.assert_array_equal(jh[k], th[k], err_msg=k)
        assert th[k].dtype == np.int32


def test_gather_plan_to_host_returns_copies():
    g = erdos_renyi(64, 64, 0.08, seed=1)
    (_, _), (ta, tb) = port_operands(g, g)
    plan, _ = tplanner.plan_gather_from_csr(ta, tb)
    a_before, b_before = plan.a_pack.copy(), plan.b_pack.copy()
    host = t_to_host(plan)
    host["a_pack"][...] = -1
    host["b_pack"][...] = -1
    np.testing.assert_array_equal(plan.a_pack, a_before)
    np.testing.assert_array_equal(plan.b_pack, b_before)
    with pytest.raises(ValueError):
        t_to_host(plan, ngroups_pad=plan.ngroups - 1)


@pytest.mark.parametrize("ngroups", [1, 5, 31, 32, 100, 128, 129, 300])
def test_slab_layout_helpers_equal(ngroups):
    rng = np.random.default_rng(ngroups)
    assert tplanner.group_slab_layout(ngroups) == jplanner.group_slab_layout(ngroups)
    assert tplanner.padded_group_count(ngroups) == jplanner.padded_group_count(ngroups)
    assert tplanner.slabbed_stream_len(ngroups) == jplanner.slabbed_stream_len(ngroups)
    padded = tplanner.padded_group_count(ngroups)
    width = rng.integers(1, 200, size=padded)
    bits = tplanner.call_search_bits(width, padded)
    assert bits == jplanner.call_search_bits(width, padded)
    per_group = group_search_bits(bits, padded)
    assert per_group.shape == (padded,) and set(per_group) <= {4, 6, 8}


def test_row_partition_equal():
    g = erdos_renyi(3000, 3000, 0.002, seed=41)
    (ja, jb), (ta, tb) = port_operands(g, g)
    for kw in ({}, {"key_space": 2_000_000}, {"max_part_products": 2000, "part_cap": 3}):
        np.testing.assert_array_equal(
            jplanner.row_partition(ja, jb, **kw), tplanner.row_partition(ta, tb, **kw)
        )
