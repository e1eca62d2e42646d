"""The port's tiled strategy on the CPU vs the JAX package's (Pallas
kernels in interpret mode) and vs scipy.

- The flat pieces (segment broadcast, flat expand) are bit-equal; the
  two-key merge has exact structure and values within rtol 1e-5.
- The packed expand stream of one plan (K3 per class, K1 on the residue)
  is bit-equal to the JAX package's slab calls over the same plan.
- Whole products (``spgemm(strategy="tiles", device="cpu")``): nnz,
  indptr and indices exact; values within rtol 1e-5 (run sums are taken
  in another order), for packed None, True and False, row parts, rebased
  parts and an unsplit m·n > 2³² plan that runs the flat residue and K4.

Every test sets the port's cost-model weights to the JAX package's
first, so both packages cut the same plans.
"""

import functools
import importlib
import inspect

import numpy as np
import pytest
import torch

from outerspace_tpu.config import Config as JConfig
from outerspace_tpu.formats import COO, rmat
from outerspace_tpu.ops.symbolic import expansion_plan_subset as j_subset
from outerspace_tpu.sched import autotune as jat
from outerspace_tpu_torch.config import Config as TConfig
from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays, tiled_plan_from_arrays
from outerspace_tpu_torch.formats import COO as TCOO
from outerspace_tpu_torch.ops import assert_csr_allclose, spgemm, spgemm_scipy
from outerspace_tpu_torch.ops.kernels import expand as texp
from outerspace_tpu_torch.ops.symbolic import expansion_plan_subset as t_subset
from outerspace_tpu_torch.sched import autotune as tat
from outerspace_tpu_torch.sched.planner import TILE_A_CLASSES

import torch_cases  # tests/ is on sys.path under pytest

big_shape_pair = functools.partial(torch_cases.big_shape_pair, COO)
dense_blocks = functools.partial(torch_cases.dense_blocks, COO)

jsp = importlib.import_module("outerspace_tpu.ops.spgemm")
tsp = importlib.import_module("outerspace_tpu_torch.ops.spgemm")
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def jax_weights(monkeypatch):
    torch_cases.set_jax_cost_weights(monkeypatch, jat, tat, TILE_A_CLASSES)


def port(a, b):
    a_csc, b_csr = a.to_csc(), b.to_csr()
    return (
        csc_from_arrays(a_csc.shape, a_csc.indptr, a_csc.indices, a_csc.data),
        csr_from_arrays(b_csr.shape, b_csr.indptr, b_csr.indices, b_csr.data),
    )


CASES = {
    "rmat8_ef16": lambda: (rmat(8, edge_factor=16, seed=1),) * 2,
    "rmat10_ef8": lambda: (rmat(10, edge_factor=8, seed=1),) * 2,
    "dense_blocks": dense_blocks,
    "big_shape": big_shape_pair,
}


def bits(t):
    t = torch.as_tensor(np.array(t))
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# ---- the flat pieces ------------------------------------------------------


@pytest.mark.parametrize("p_extra", [0, 37])
def test_segment_broadcast_bits_equal(p_extra):
    rng = np.random.default_rng(p_extra)
    lens = rng.integers(0, 5, size=200)
    lens[-3:] = 0  # empty trailing segments start at P
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    p_pad = int(lens.sum()) + p_extra
    payload = rng.integers(-(2**31), 2**31, size=200, dtype=np.int64).astype(np.int32)
    payload[:3] = [2**31 - 1, -(2**31), 0]
    want = jsp._segment_broadcast_bits(payload, starts, p_pad)
    got = tsp._segment_broadcast_bits(torch.from_numpy(payload), torch.from_numpy(starts), p_pad)
    assert got.dtype == torch.int32
    assert torch.equal(got, bits(want))


def flat_inputs(name):
    a, b = CASES[name]()
    (ja, jb), (ta, tb) = (a.to_csc(), b.to_csr()), port(a, b)
    nb = np.diff(jb.indptr)
    light = np.nonzero(nb[np.arange(ja.shape[1])] > 0)[0][::3].astype(np.int32)
    return j_subset(ja, jb, light), t_subset(ta, tb, light)


@pytest.mark.parametrize("name", ["rmat10_ef8", "big_shape"])
def test_expand_partial_products_equal(name):
    jplan, tplan = flat_inputs(name)
    p_pad = -(-jplan.padded_size(min_size=1024) // 1024) * 1024
    want = jsp.expand_partial_products(
        **jsp.plan_to_device(jplan), p_pad=p_pad, sentinel_row=jplan.m
    )
    got = tsp.expand_partial_products(
        **tsp.plan_to_device(tplan, "cpu"), p_pad=p_pad, sentinel_row=tplan.m
    )
    for g, w in zip(got, want):
        assert torch.equal(bits(g), bits(w))


@pytest.mark.parametrize("name", ["rmat10_ef8", "big_shape"])
def test_merge_twokey_matches_jax(name):
    jplan, tplan = flat_inputs(name)
    p_pad = tplan.padded_size(min_size=1024)
    r, c, v = tsp.expand_partial_products(
        **tsp.plan_to_device(tplan, "cpu"), p_pad=p_pad, sentinel_row=tplan.m
    )
    perm = torch.from_numpy(np.random.default_rng(0).permutation(p_pad))
    r, c, v = r[perm], c[perm], v[perm]
    want = jsp.merge_twokey(r.numpy(), c.numpy(), v.numpy(), tplan.m)
    got = tsp.merge_twokey(r, c, v, tplan.m)
    valid = got[3].numpy()
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[2].numpy()[valid], np.asarray(want[2])[valid], rtol=RTOL, atol=ATOL)
    assert int(got[4]) == int(valid.sum()) > 0


# ---- one plan, both packages' streams ------------------------------------


@pytest.mark.parametrize("name,waste_limit", [
    ("rmat8_ef16", None), ("rmat8_ef16", 2.0), ("rmat10_ef8", 2.0), ("dense_blocks", None),
])
def test_packed_stream_bit_equal_on_one_plan(name, waste_limit):
    a, b = CASES[name]()
    jplan = jsp.plan_tiled(a.to_csc(), b.to_csr(), waste_limit=waste_limit)
    tplan = tiled_plan_from_arrays(jplan, device="cpu")
    assert tplan.class_tables()
    jk, jv, jpad = jsp.tiled_expand_packed(jplan, interpret=True)
    tk, tv, tpad = tsp.tiled_expand_packed(tplan)
    assert tpad == jpad
    # one launch over every class, written in place, vs one Pallas call
    # per slab: the same stream
    assert tk.shape == tv.shape == (tplan.padded_total,)
    assert torch.equal(tk, bits(np.concatenate([np.asarray(k) for k in jk])))
    assert torch.equal(bits(tv), bits(np.concatenate([np.asarray(v) for v in jv])))


# ---- whole products -------------------------------------------------------


def check_tiles(a, b, packed):
    ta, tb = port(a, b)
    got = spgemm(ta, tb, strategy="tiles", packed=packed, device="cpu")
    assert_csr_allclose(got, jsp.spgemm(a, b, strategy="tiles", packed=packed, interpret=True),
                        rtol=RTOL, atol=ATOL)
    assert_csr_allclose(got, spgemm_scipy(ta, tb), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("packed", [None, True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tiles_match_jax_and_scipy(name, packed):
    if name == "big_shape" and packed is True:
        packed = None  # its rebased parts pack; True is the same run
    check_tiles(*CASES[name](), packed)


@pytest.mark.parametrize("packed", [None, False])
def test_tiles_match_jax_and_scipy_zoo(operand_pair, packed):
    check_tiles(*operand_pair, packed)


@pytest.mark.parametrize("packed", [None, False])
def test_row_parts_match_jax_and_scipy(packed):
    g = rmat(9, edge_factor=16, seed=1)
    kw = dict(nparts=4, min_part_stream=1, budget=10.0)
    jplan = jsp.plan_tiled_parts(g.to_csc(), g.to_csr(), **kw)
    tplan = tsp.plan_tiled_parts(*port(g, g), device="cpu", **kw)
    assert isinstance(tplan, tsp.TiledPartsPlan) and len(tplan.parts) == 4
    got = tsp.spgemm_padded_tiled_parts(tplan, packed=packed)
    if packed is None:
        assert got.rows.shape[0] == tplan.merge_pad * 4
    want = jsp.spgemm_padded_tiled_parts(jplan, packed=packed, interpret=True)
    assert_csr_allclose(got.to_csr(), want.to_csr(), rtol=RTOL, atol=ATOL)
    assert_csr_allclose(got.to_csr(), spgemm_scipy(*port(g, g)), rtol=RTOL, atol=ATOL)


def test_unsplit_big_plan_runs_flat_residue_and_k4(monkeypatch):
    a, b = big_shape_pair(seed=2)
    calls = {"light": 0, "coords": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(tsp, "expand_partial_products",
                        counted("light", tsp.expand_partial_products))
    monkeypatch.setattr(tsp, "expand_part_coords", counted("coords", tsp.expand_part_coords))
    jplan = jsp.plan_tiled(a.to_csc(), b.to_csr())
    tplan = tsp.plan_tiled(*port(a, b), device="cpu")
    assert tplan.light_plan is not None and tplan.m * tplan.n > 2**32
    got = tsp.spgemm_padded_tiled(tplan).to_csr()
    # K4 once over all the class tables
    assert calls == {"light": 1, "coords": 1} and tplan.class_tables()
    want = jsp.spgemm_padded_tiled(jplan, interpret=True).to_csr()
    assert_csr_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert_csr_allclose(got, spgemm_scipy(*port(a, b)), rtol=RTOL, atol=ATOL)


def test_packed_light_residue_keys_equal():
    jplan, tplan = flat_inputs("rmat10_ef8")
    p_pad = tplan.padded_size(min_size=1024)
    kw = dict(p_pad=p_pad, sentinel_row=tplan.m, n_cols=tplan.n)
    want = jsp._expand_light_packed(**jsp.plan_to_device(jplan), **kw)
    got = tsp._expand_light_packed(**tsp.plan_to_device(tplan, "cpu"), **kw)
    for g, w in zip(got, want):
        assert torch.equal(bits(g), bits(w))


def test_empty_product_and_strategy_checks():
    a = TCOO((6, 5), [0, 3], [1, 2], [1.0, 2.0])
    b = TCOO((5, 4), [0, 4], [1, 3], [1.0, 1.0])  # A's columns meet empty B rows
    got = spgemm(a, b, strategy="tiles", device="cpu")
    assert got.nnz == 0 and got.shape == (6, 4) and got.indptr.shape == (7,)
    flat = spgemm(a, b, strategy="flat", device="cpu")
    assert flat.nnz == 0 and flat.shape == (6, 4) and flat.indptr.shape == (7,)
    with pytest.raises(ValueError):
        spgemm(a, b, strategy="nope", device="cpu")
    for fn in (spgemm, tsp.plan_tiled, tsp.plan_tiled_parts):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_config_waste_limit_reaches_the_planner():
    g = rmat(10, edge_factor=8, seed=1)
    ta, tb = port(g, g)
    cfg = TConfig(waste_limit=2.0)
    got = spgemm(ta, tb, strategy="tiles", config=cfg, device="cpu")
    want = jsp.spgemm(g, g, strategy="tiles", interpret=True, config=JConfig(waste_limit=2.0))
    assert_csr_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert tsp.plan_tiled(ta, tb, waste_limit=2.0, device="cpu").class_plan.classes[0].ntasks > 0


def test_packed_keys_refused_past_2e32():
    # row·n + col would wrap mod 2³² and merge distinct coordinates
    a, b = big_shape_pair(seed=2)
    tplan = tsp.plan_tiled(*port(a, b), device="cpu")
    assert tplan.m * tplan.n > 2**32
    with pytest.raises(ValueError, match="2\\^32"):
        tsp.spgemm_padded_tiled(tplan, packed=True)
    with pytest.raises(ValueError, match="2\\^32"):
        tsp.spgemm_padded_tiled_parts(tplan, packed=True)


def test_gather_residue_twokey_refuses_the_2e32_corner():
    m = n = 65536
    a = TCOO((m, 2), [m - 1, 3], [0, 1], [1.5, 2.0])
    b = TCOO((2, n), [0, 1], [n - 1, 7], [2.0, 1.0])
    tplan = tsp.plan_tiled(*port(a, b), device="cpu")
    assert tplan.gather_ngroups
    with pytest.raises(ValueError, match="corner"):
        tsp.spgemm_padded_tiled(tplan, packed=False)
    got = tsp.spgemm_padded_tiled(tplan).to_csr()
    assert_csr_allclose(got, spgemm_scipy(a, b), rtol=RTOL, atol=ATOL)
    assert texp.KERNEL_PACKED.launches == 0
