"""The device chain of the port (``outerspace_tpu_torch/ops/chain.py``)
on the CPU against the JAX package's: ranks and column starts exact, the
compaction of the fused chain's entry, one loop iteration (keys, column
starts and ``ok`` exact, values within rtol 1e-5 / atol 1e-6; where the
JAX package's per-block survivor cap fails, the port, which has none,
against the JAX iteration without it), the same iteration on int64 keys
bit-equal to the int32 one, the CSC state's conversions and the stats;
the stepwise and fused chains and ``square_device`` against scipy
(structure exact, values within rtol 5e-4 / atol 1e-5, the JAX
package's MCL tolerance)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import outerspace_tpu.ops.chain as jc
import outerspace_tpu.ops.graph as jg
import outerspace_tpu_torch.ops.chain as tc
import outerspace_tpu_torch.ops.graph as tg
from outerspace_tpu.formats import COO, erdos_renyi, rmat
from outerspace_tpu_torch.formats import COO as TCOO
from outerspace_tpu_torch.ops.kernels.scan import merge_epilogue_plain
from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_scipy
from outerspace_tpu_torch.ops.spgemm import MergedCOO

I32_MAX = 2**31 - 1
BIAS = -(2**31)
MCL_TOL = dict(rtol=5e-4, atol=1e-5)
MERGE_TOL = dict(rtol=1e-5, atol=1e-6)


def t(x):
    return torch.from_numpy(np.asarray(x))


def tcoo(c):
    return TCOO(c.shape, c.row, c.col, c.val)


def csc_state(g, elem_pad):
    """The column-normalised MCL flow of ``g`` as the loop's state
    (numpy): sorted biased ``col·m + row`` keys with a sentinel tail,
    values, column starts."""
    flow = jg._mcl_setup(g).to_scipy().tocsc()
    flow.sort_indices()
    m = flow.shape[0]
    cols = np.repeat(np.arange(m, dtype=np.int64), np.diff(flow.indptr))
    key = np.full(elem_pad, I32_MAX, np.int32)
    vals = np.zeros(elem_pad, np.float32)
    key[: flow.nnz] = cols * m + flow.indices + BIAS
    vals[: flow.nnz] = flow.data
    starts = np.searchsorted(key, (np.arange(m + 1) * m + BIAS).astype(np.int32)).astype(np.int32)
    return key, vals, starts


def merged_of(coo, pad_extra=0):
    """A port ``MergedCOO`` holding ``coo`` row-major, padded."""
    c = coo.to_csr().to_coo()
    n = c.shape[0]
    pad = -(-max(c.nnz, 1) // 1024) * 1024 + pad_extra
    rows = np.full(pad, n, np.int32)
    cols = np.zeros(pad, np.int32)
    vals = np.zeros(pad, np.float32)
    rows[: c.nnz], cols[: c.nnz], vals[: c.nnz] = c.row, c.col, c.val
    return MergedCOO(c.shape, t(rows), t(cols), t(vals), t(rows < n), torch.tensor(c.nnz, dtype=torch.int32))


def flow_merged(g):
    """The column-normalised flow of ``g`` as a port ``MergedCOO``."""
    return merged_of(tg._mcl_setup(tcoo(g)).to_coo())


def scipy_mcl(g, iters):
    return tg.markov_cluster(tcoo(g), iters=iters, backend="scipy")


def assert_flow(got, want):
    assert got.nnz == want.nnz
    np.testing.assert_allclose(got.to_dense(), want.to_dense(), **MCL_TOL)


# ---------------------------------------------------------------- ranks


def test_ranks_in_sorted_equals_jax():
    rng = np.random.default_rng(1)
    keys = np.sort(np.concatenate([
        rng.integers(-(2**31), 2**31 - 1, size=3000), np.full(200, I32_MAX),
        np.full(40, -5), np.full(30, 2**31 - 2)])).astype(np.int32)
    # strictly ascending probes below the JAX rank trick's packing bound,
    # some on keys, some between
    probes = np.unique(np.concatenate([
        keys[keys < -3][::7], rng.integers(-(2**31), -3, size=500), [-(2**31), -4]])).astype(np.int32)
    want = np.asarray(jc.ranks_in_sorted(jnp.asarray(keys), jnp.asarray(probes)))
    got = tc.ranks_in_sorted(t(keys), t(probes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.searchsorted(keys, probes, side="left"))


@pytest.mark.parametrize("m, nnz", [(120, 700), (50_000, 3000)])
def test_column_starts_equal_jax(m, nnz):
    # m = 50,000: m² passes the JAX rank trick's bound, so the JAX package
    # takes its binary search there
    rng = np.random.default_rng(m)
    u = np.unique(rng.integers(0, m * m, size=nnz))
    key = np.full(nnz + 64, I32_MAX, np.int32)
    key[: u.size] = (u + BIAS).astype(np.int32)
    want = np.asarray(jc._column_starts(jnp.asarray(key), m))
    np.testing.assert_array_equal(tc._column_starts(t(key), m).numpy(), want)


# ----------------------------------------------------------- compaction


def test_slice_compact_equals_jax():
    rng = np.random.default_rng(3)
    n = 3000
    valid = rng.random(n) < 0.3
    rows = np.where(valid, np.sort(rng.integers(0, 90, size=n)), 90).astype(np.int32)
    cols = rng.integers(0, 90, size=n).astype(np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    nnz_pad = int(valid.sum()) + 17
    want = jc._slice_compact_jit(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                                 jnp.asarray(valid), p_pad=n, nnz_pad=nnz_pad)
    got = tc._slice_compact(t(rows), t(cols), t(vals), t(valid), nnz_pad=nnz_pad)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))


# ------------------------------------------------------- the loop pieces


def p_total(key, starts):
    """P of the loop squaring of a CSC state (numpy): each element
    (k, c) pairs with CSC column k."""
    m = starts.shape[0] - 1
    valid = key != I32_MAX
    row = (key.astype(np.int64) - BIAS) % m
    return int(np.diff(starts)[row[valid]].sum())


ITER_CASES = {
    # (graph, elem_pad, p_pad or None for P + 2,000, the JAX package's
    # blk_cap, ok)
    "fits": ("er120", 4096, None, None, True),
    "capped": ("rmat8", 8192, None, 2048, True),
    "p_over_budget": ("er120", 1024, 2048, None, False),
    "elems_over_budget": ("rmat8", 2048, None, None, False),
    "block_over_cap": ("rmat8", 8192, None, 8, True),
}
GRAPHS = {"er120": lambda: erdos_renyi(120, 120, 0.04, seed=55),
          "rmat8": lambda: rmat(8, edge_factor=8, seed=11)}


def iter_case(case):
    """(state as numpy, the iteration's keywords, the JAX package's
    blk_cap, ok) of an ``ITER_CASES`` entry."""
    graph, elem_pad, p_pad, blk_cap, ok = ITER_CASES[case]
    g = GRAPHS[graph]()
    key, vals, starts = csc_state(g, elem_pad)
    p_pad = p_pad or p_total(key, starts) + 2000
    kw = dict(p_pad=p_pad, elem_pad=elem_pad, m=g.shape[0], inflation=2.0, threshold=1e-4)
    return (key, vals, starts), kw, blk_cap, ok


def jax_iteration(state, kw, blk_cap):
    """The JAX package's iteration by its gather join, with ``blk_cap``."""
    step = jax.jit(functools.partial(jc._mcl_iteration, blk_cap=blk_cap, join="gather", **kw))
    return step((*map(jnp.asarray, state), jnp.bool_(True)))


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_mcl_iteration_equals_jax(case):
    state, kw, blk_cap, ok = iter_case(case)
    want = jax_iteration(state, kw, blk_cap)
    got = tc._mcl_iteration((*map(t, state), torch.ones((), dtype=torch.bool)), **kw)
    assert bool(got[3]) == ok
    if case == "block_over_cap":
        # the JAX package's blocked compaction is exact only under its cap,
        # so it falls back; the port's compaction keeps every survivor
        # that fits, and equals the JAX iteration with no cap
        assert not bool(want[3])
        want = jax_iteration(state, kw, None)
    assert bool(want[3]) == ok
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **MERGE_TOL)


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_mcl_iteration_int64_keys_equal_int32(case):
    """The same state keyed in plain int64 ``col·m + row`` (INT64_MAX
    tail), as the chain keys it from m² ≥ 2³² on: every helper reads the
    key type from its keys, so the iteration gives the same keys,
    unpacked, the same column starts and ``ok``, and the same values bit
    for bit."""
    (key, vals, starts), kw, _, ok = iter_case(case)
    wide = np.where(key == I32_MAX, np.iinfo(np.int64).max, key.astype(np.int64) - BIAS)
    ones = torch.ones((), dtype=torch.bool)
    narrow = tc._mcl_iteration((t(key), t(vals), t(starts), ones), **kw)
    got = tc._mcl_iteration((t(wide), t(vals), t(starts), ones), **kw)
    assert got[0].dtype == torch.int64 and bool(got[3]) == bool(narrow[3]) == ok
    real = narrow[0] != I32_MAX
    assert torch.equal(got[0] != np.iinfo(np.int64).max, real)
    for a, b in zip(tc._unpack(got[0], kw["m"]), tc._unpack(narrow[0], kw["m"])):
        assert torch.equal(a[real], b[real])
    assert torch.equal(got[2], narrow[2])
    assert torch.equal(got[1].view(torch.int32), narrow[1].view(torch.int32))


def test_csc_colnorm_equals_jax():
    key, vals, starts = csc_state(rmat(8, edge_factor=8, seed=11), 8192)
    m = starts.shape[0] - 1
    kcol = ((key.astype(np.int64) - BIAS) // m + BIAS).astype(np.int32)
    probes = (np.arange(m + 1) + BIAS).astype(np.int32)
    searched = tc.ranks_in_sorted(t(kcol), t(probes))
    for s in (starts, None):  # the starts given, and searched (the port by ranks_in_sorted)
        want = jc._csc_colnorm_sorted(jnp.asarray(kcol), jnp.asarray(vals), m,
                                      None if s is None else jnp.asarray(s))
        got = tc._csc_colnorm_sorted(t(kcol), t(vals), m, searched if s is None else t(s))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MERGE_TOL)


def test_loop_merge_pad_count_bound():
    """The loop's merges pass the stream length as K2's ``pad_count``:
    below m·n = 2³² no real key is the sentinel, so the output equals the
    one with the exact count of padding slots."""
    key, vals, _ = csc_state(rmat(8, edge_factor=8, seed=11), 8192)
    rng = np.random.default_rng(0)
    dup = np.sort(np.concatenate([key, key[rng.integers(0, 2000, size=6000)]]))
    v = rng.random(dup.size).astype(np.float32)
    pads = int((dup == I32_MAX).sum())
    exact = merge_epilogue_plain(t(dup), t(v), pads, n_cols=256, sentinel_row=256)
    bound = merge_epilogue_plain(t(dup), t(v), dup.size, n_cols=256, sentinel_row=256)
    for a, b in zip(exact, bound):
        assert torch.equal(a, b)
    assert not bool(bound[3][dup == I32_MAX].any())


def test_csc_state_round_trip_equals_jax():
    merged = flow_merged(rmat(8, edge_factor=8, seed=11))
    m = merged.shape[0]
    args = (merged.rows.numpy(), merged.cols.numpy(), merged.vals.numpy(), merged.valid.numpy())
    for p_pad in (2048, 8192):  # cut and padded
        wk, wv = jc._to_csc_state_jit(*map(jnp.asarray, args), p_pad=p_pad, m=m)
        gk, gv = tc._to_csc_state(*map(t, args), p_pad=p_pad, m=m)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    want = jc._from_csc_state_jit(wk, wv, m=m, n=m, nnz_pad=4096)
    got = tc._from_csc_state(gk, gv, m=m, n=m, nnz_pad=4096)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))


def test_chain_and_flow_stats_equal_jax():
    merged = flow_merged(erdos_renyi(100, 100, 0.05, seed=51))
    rows, cols, vals, indptr, _ = tc.compact_to_csr_device(
        merged.rows, merged.cols, merged.vals, merged.valid, nnz_pad=1024, m=100)
    raw = np.asarray(jc._chain_stats_jit(jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy()),
                                         jnp.asarray(indptr.numpy()), m=100))
    assert int(tc._chain_stats(rows, cols, indptr, m=100)) == int(raw[0])
    want = jc._decode_flow_stats(jc._flow_stats_jit(
        jnp.asarray(merged.rows.numpy()), jnp.asarray(merged.cols.numpy()),
        jnp.asarray(merged.valid.numpy()), m=100))
    assert tuple(tc._flow_stats(merged.rows, merged.cols, merged.valid, m=100).tolist()) == want


def test_inflate_device_equals_jax():
    merged = flow_merged(rmat(7, edge_factor=6, seed=2))
    sq = tc.square_device(merged)
    args = (sq.rows.numpy(), sq.cols.numpy(), sq.vals.numpy(), sq.valid.numpy())
    kw = dict(m=merged.shape[0], inflation=2.0, threshold=1e-3)
    wv, wvalid, wnnz = jc.inflate_device(*map(jnp.asarray, args), **kw)
    gv, gvalid, gnnz = tc.inflate_device(*map(t, args), **kw)
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid))
    assert int(gnnz) == int(wnnz)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **MERGE_TOL)


# ----------------------------------------------------------- the chains


def heavy_column_graph():
    """A heavy row referenced by many light rows' elements: P gathered by
    rows would under-size p_pad (the JAX package's regression case)."""
    n, h, k = 64, 4, 48
    rows = [0] * h + list(range(1, k + 1))
    cols = list(range(1, h + 1)) + [0] * k
    return COO((n, n), np.asarray(rows), np.asarray(cols), np.ones(h + k, np.float32))


@pytest.mark.parametrize("graph", ["er200", "rmat7", "heavy_column"])
def test_square_device_equals_scipy(graph):
    g = {"er200": lambda: erdos_renyi(200, 200, 0.03, seed=52),
         "rmat7": lambda: rmat(7, edge_factor=6, seed=53),
         "heavy_column": heavy_column_graph}[graph]()
    a = tcoo(g)
    assert_csr_allclose(tc.square_device(merged_of(a)).to_csr(), spgemm_scipy(a, a), rtol=1e-5)


def test_spgemm_from_device_csr_twice_equals_scipy():
    a = tcoo(erdos_renyi(150, 150, 0.02, seed=54))
    sq = tc.square_device(tc.square_device(merged_of(a)))
    s = a.to_scipy().tocsr()
    want = (s @ s) @ (s @ s)
    got = sq.to_csr().to_scipy()
    assert got.nnz == want.nnz
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("chain", ["stepwise", "fused", "fused_padded", "fused_fallback"])
def test_device_chains_equal_scipy(chain, monkeypatch):
    g = erdos_renyi(50, 50, 0.08, seed=3)
    # one fused iteration fits its budgets (P of the first squaring); over
    # three the flow grows past them, ok is false and the stepwise chain
    # runs, as in the JAX package
    iters = 1 if chain in ("fused", "fused_padded") else 3
    merged0 = flow_merged(g)
    stepwise = []
    real = tc.markov_cluster_device
    monkeypatch.setattr(tc, "markov_cluster_device", lambda *a, **k: stepwise.append(1) or real(*a, **k))
    if chain == "stepwise":
        out = tc.markov_cluster_device(merged0, iters=iters)
    elif chain == "fused_padded":  # past the loop budget: compacted first
        out = tc.markov_cluster_device_fused(merged_of(merged0.to_csr().to_coo(), 200_000), iters=iters)
    else:
        out = tc.markov_cluster_device_fused(merged0, iters=iters)
    assert len(stepwise) == (chain in ("stepwise", "fused_fallback"))
    assert_flow(out.to_csr(), scipy_mcl(g, iters))
