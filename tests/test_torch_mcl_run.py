"""Markov clustering through the port's entry points on the CPU
(``outerspace_tpu_torch/ops/graph.py``): the host sizing sweep and the
budgets of ``mcl_size`` equal to the JAX package's under its cost-model
weights (both packages then pick the same plan; the port sets no
per-block survivor caps), ``mcl_whole_traced`` against the JAX
package's, and ``markov_cluster`` against the JAX package's staged chain
and against scipy (nnz exact, cluster sets equal, values within rtol
5e-4 / atol 1e-5); the fallback when ``ok`` is false, the report, the
warm sizing cache, a torn cache entry, and entries that carry the JAX
package's caps, which the port ignores: it stays on the fast path where
those caps would fail."""

import json

import jax
import numpy as np
import pytest

import outerspace_tpu.ops.graph as jg
import outerspace_tpu.sched.autotune as jat
import outerspace_tpu_torch.ops.graph as tg
import outerspace_tpu_torch.sched.autotune as tat
import torch_cases
from outerspace_tpu.formats import erdos_renyi, rmat
from outerspace_tpu.ops.chain import mcl_whole_traced as jax_whole
from outerspace_tpu_torch.convert import csr_from_arrays
from outerspace_tpu_torch.formats import COO as TCOO
from outerspace_tpu_torch.ops.chain import mcl_whole_traced
from outerspace_tpu_torch.ops.symbolic import round_up_bucket
from outerspace_tpu_torch.perf import timer
from outerspace_tpu_torch.sched.planner import TILE_A_CLASSES

MCL_TOL = dict(rtol=5e-4, atol=1e-5)
BUDGETS = ("p_pad", "nnz_pad", "elem_pad", "p_pads")


@pytest.fixture
def jax_weights(monkeypatch):
    torch_cases.set_jax_cost_weights(monkeypatch, jat, tat, TILE_A_CLASSES)


@pytest.fixture(autouse=True)
def own_cache(tmp_path, monkeypatch):
    """Every test starts from an empty sizing cache of its own."""
    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(tmp_path / "sizing.json"))
    return tmp_path / "sizing.json"


def tcoo(c):
    return TCOO(c.shape, c.row, c.col, c.val)


def flows(g):
    """The column-normalised flow of ``g`` in each package."""
    jf = jg._mcl_setup(g)
    return jf, csr_from_arrays(jf.shape, jf.indptr, jf.indices, jf.data)


def clusters(flow):
    return {tuple(sorted(c.tolist())) for c in tg.mcl_clusters(flow)}


def assert_flow(got, want):
    """nnz and structure exact, values within the MCL tolerance, cluster
    sets equal."""
    g, w = got.to_scipy().tocsr(), want.to_scipy().tocsr()
    g.sort_indices()
    w.sort_indices()
    assert g.nnz == w.nnz
    np.testing.assert_array_equal(g.indptr, w.indptr)
    np.testing.assert_array_equal(g.indices, w.indices)
    np.testing.assert_allclose(g.data, w.data, **MCL_TOL)
    assert clusters(got) == clusters(want)


GRAPHS = {
    "er120": lambda: erdos_renyi(120, 120, 0.04, seed=55),
    "rmat8": lambda: rmat(8, edge_factor=8, seed=11),
}


def tiles_plan(monkeypatch):
    """Both packages plan the first squaring in tiled row parts."""
    monkeypatch.setattr("outerspace_tpu_torch.sched.planner.choose_strategy", lambda *a: "tiles")
    monkeypatch.setattr("outerspace_tpu.sched.planner.choose_strategy", lambda *a: "tiles")


@pytest.mark.parametrize("plan", ["auto", "tiles"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_mcl_size_budgets_equal_jax(graph, plan, jax_weights, monkeypatch):
    jf, tf = flows(GRAPHS[graph]())
    if plan == "tiles":
        tiles_plan(monkeypatch)
    jprep, tprep = jg.mcl_prepare(jf, iters=4), tg.mcl_prepare(tf, iters=4, device="cpu")
    assert type(tprep["tplan"]).__name__ == type(jprep["tplan"]).__name__
    sweep = (jf.to_scipy().tocsr(), 2.0, 4, 1e-4)
    assert tg._host_mcl_sizing(*sweep) == jg._host_mcl_sizing(*sweep)
    jg.mcl_size(jprep)
    tg.mcl_size(tprep)
    assert {k: tprep[k] for k in BUDGETS} == {k: jprep[k] for k in BUDGETS}
    assert "blk_caps" not in tprep
    assert tprep["sizing_key"] != jprep["sizing_key"]  # the port's keys carry their prefix


@pytest.mark.parametrize("elem_pad", [None, 4096])
def test_mcl_whole_traced_equals_jax(elem_pad, jax_weights):
    """A hand schedule (JAX ``tests/test_chain.py``'s); elem_pad 4096 is
    too small for the survivors, so ``ok`` is false in both."""
    g = rmat(8, edge_factor=8, seed=12)
    jf, tf = flows(g)
    p_list, nnz_list = jg._host_mcl_sizing(jf.to_scipy().tocsr(), 2.0, 3, 1e-4)
    elem = elem_pad or round_up_bucket(int(1.5 * max(nnz_list)) + 1024, min_size=4096)
    p_pads = tuple(round_up_bucket(max(int(1.5 * p) + 4096, elem), min_size=4096) for p in p_list[1:])
    kw = dict(p_pad=max(p_pads), nnz_pad=round_up_bucket(int(1.5 * nnz_list[-1]) + 256, min_size=1024),
              m=g.shape[0], n_cols=g.shape[0], iters=2, inflation=2.0, threshold=1e-4,
              elem_pad=elem, p_pads=p_pads)
    jplan = jg.mcl_prepare(jf, iters=3)["tplan"]
    want = jax.jit(lambda: jax_whole(jplan, **kw))()
    got = mcl_whole_traced(tg.mcl_prepare(tf, iters=3, device="cpu")["tplan"], **kw)
    assert bool(got[4]) == bool(want[4]) == (elem_pad is None)
    if elem_pad:
        return
    nnz = int(want[3])
    assert int(got[3]) == nnz
    for i in (0, 1):
        np.testing.assert_array_equal(got[i].numpy()[:nnz], np.asarray(want[i])[:nnz])
    np.testing.assert_allclose(got[2].numpy()[:nnz], np.asarray(want[2])[:nnz], **MCL_TOL)


def test_markov_cluster_equals_jax_staged_chain():
    """The whole run against the JAX package's staged chain (its first
    squaring's Pallas kernel in interpret mode)."""
    g = erdos_renyi(40, 40, 0.1, seed=9)
    want = jg.markov_cluster(g, iters=3, backend="tpu")
    got = tg.markov_cluster(tcoo(g), iters=3, backend="torch", device="cpu")
    assert_flow(got, want)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_markov_cluster_equals_scipy(graph):
    g = tcoo(GRAPHS[graph]())
    report = {}
    got = tg.markov_cluster(g, iters=4, device="cpu", report=report)
    assert_flow(got, tg.markov_cluster(g, iters=4, backend="scipy"))
    assert report["fast_path"] and report["p_pad"] and len(report["p_pads"]) == 3


def test_markov_cluster_host_loops():
    """expansion 3, and n² ≥ 2³² (the staged chain's keys would not
    fit): the host loop over ``spgemm`` equals the one over scipy."""
    g = tcoo(erdos_renyi(60, 60, 0.06, seed=8))
    kw = dict(expansion=3, iters=3)
    assert_flow(tg.markov_cluster(g, device="cpu", **kw), tg.markov_cluster(g, backend="scipy", **kw))
    rng = np.random.default_rng(2)
    n = 70_000
    r, c = rng.integers(0, n, size=300), rng.integers(0, n, size=300)
    big = TCOO((n, n), r, c, np.ones(300, np.float32))
    assert_flow(tg.markov_cluster(big, iters=2, device="cpu"), tg.markov_cluster(big, iters=2, backend="scipy"))


def sabotaged(flow, iters, prepare=tg.mcl_prepare):
    """A prep sized by the sweep, then given an element budget too small
    for the survivors, single-size."""
    prep = prepare(flow, iters=iters, device="cpu")
    tg.mcl_size(prep)
    prep.update(elem_pad=4096, p_pads=None)
    return prep


def test_mcl_run_falls_back_when_ok_is_false(own_cache):
    g = rmat(8, edge_factor=8, seed=12)
    _, tf = flows(g)
    assert max(tg._host_mcl_sizing(tf.to_scipy(), 2.0, 3, 1e-4)[1]) > 4096
    prep = sabotaged(tf, 3)
    before = dict(prep)
    out = tg.mcl_run(prep)
    assert_flow(out.to_csr(), tg.markov_cluster(tcoo(g), iters=3, backend="scipy"))
    assert prep["p_pad"] > before["p_pad"] and prep["elem_pad"] == 8192
    assert prep["p_pads"] is None
    stored = json.loads(own_cache.read_text())[prep["sizing_key"]]
    assert stored == {k: prep[k] for k in BUDGETS}
    # the doubled budgets hold: the next run takes the fast path
    again = tg.mcl_run(prep)
    assert prep["p_pad"] == stored["p_pad"]
    assert_flow(again.to_csr(), out.to_csr())


def test_markov_cluster_report_on_fallback(monkeypatch):
    g = tcoo(rmat(8, edge_factor=8, seed=12))
    real = tg.mcl_prepare
    monkeypatch.setattr(tg, "mcl_prepare", lambda flow, **kw: sabotaged(flow, kw["iters"], real))
    report = {}
    out = tg.markov_cluster(g, iters=3, device="cpu", report=report)
    assert report["fast_path"] is False and report["p_pad"] is None
    assert report["elem_pad"] == 4096  # the budgets the run used, not the doubled ones
    assert_flow(out, tg.markov_cluster(g, iters=3, backend="scipy"))


def test_warm_cache_and_torn_entry(own_cache, monkeypatch):
    g = rmat(8, edge_factor=8, seed=11)
    _, tf = flows(g)
    want = tg.markov_cluster(tcoo(g), iters=4, backend="scipy")
    cold = tg.mcl_prepare(tf, iters=4, device="cpu")
    assert_flow(tg.mcl_run(cold).to_csr(), want)
    assert "sizing_cached" not in cold
    good = json.loads(own_cache.read_text())
    sweeps = []
    real_size = tg.mcl_size
    monkeypatch.setattr(tg, "mcl_size", lambda prep: sweeps.append(1) or real_size(prep))

    def run(edit=None):
        """A fresh prep's run from the good entry after ``edit``."""
        d = json.loads(json.dumps(good))
        if edit:
            edit(d[cold["sizing_key"]])
        own_cache.write_text(json.dumps(d))
        sweeps.clear()
        prep = tg.mcl_prepare(tf, iters=4, device="cpu")
        assert_flow(tg.mcl_run(prep).to_csr(), want)
        return prep

    warm = run()
    assert not sweeps and warm["sizing_cached"] and "flow" not in warm
    assert {k: warm[k] for k in BUDGETS} == {k: cold[k] for k in BUDGETS}
    # torn entries cost speed only: schedules of the wrong length or a
    # corrupt value drop the schedule, a corrupt budget the entry
    for tear in ({"p_pads": good[cold["sizing_key"]]["p_pads"][:1]}, {"p_pads": "torn"}):
        torn = run(lambda e: e.update(tear))
        assert not sweeps and torn["sizing_cached"] and torn["p_pads"] is None
    run(lambda e: e.update(nnz_pad=None))
    assert sweeps
    run(lambda e: e.pop("elem_pad"))  # elem_pad falls back to 4 x nnz_pad
    assert not sweeps


def test_mcl_run_with_only_p_pad_and_nnz_pad():
    """A prep given only ``p_pad`` and ``nnz_pad`` runs with the default
    element budget (4 x nnz_pad) and one product budget, exactly, as the
    JAX package's does."""
    g = rmat(8, edge_factor=8, seed=11)
    _, tf = flows(g)
    prep = tg.mcl_prepare(tf, iters=4, device="cpu")
    tg.mcl_size(prep)
    for k in ("elem_pad", "p_pads", "sizing_key"):
        prep.pop(k)
    assert_flow(tg.mcl_run(prep).to_csr(), tg.markov_cluster(tcoo(g), iters=4, backend="scipy"))
    assert prep["ran_with"]["elem_pad"] is None


def cached_run(tf, entry, own_cache, monkeypatch, iters=4):
    """A fresh prep's ``mcl_run`` from the sizing-cache ``entry``, with no
    sweep: (the prep, the flow, the fallbacks counted)."""
    probe = tg.mcl_prepare(tf, iters=iters, device="cpu")
    own_cache.write_text(json.dumps({probe["sizing_key"]: entry}))
    monkeypatch.setattr(tg, "mcl_size", lambda prep: pytest.fail("the sweep ran"))
    before = timer.counters().get("mcl.fallbacks", 0)
    out = tg.mcl_run(probe)
    return probe, out.to_csr(), timer.counters().get("mcl.fallbacks", 0) - before


@pytest.mark.parametrize("plan", ["auto", "tiles"])
def test_mcl_run_stays_fast_where_jax_caps_fail(plan, jax_weights, monkeypatch, own_cache):
    """Per-block survivor caps one below the most survivors a block of
    each squaring's merged stream holds, as the JAX package's host sweep
    counts them on its stage-1 layout: the JAX package's blocked
    compaction would not be exact under them, and it would fall back.
    The port checks no such bound: from an entry that carries those
    caps, its run takes the fast path and equals scipy."""
    g = rmat(8, edge_factor=8, seed=11)
    jf, tf = flows(g)
    if plan == "tiles":
        tiles_plan(monkeypatch)
    jprep = jg.mcl_prepare(jf, iters=4)
    _, _, raw = jg._host_mcl_sizing_full(jf.to_scipy().tocsr(), 2.0, 4, 1e-4,
                                         stage1_layout=jg._stage1_stream_layout(jprep["tplan"]))
    tight = [c - 1 if c else 0 for c in raw]
    assert sum(c > 0 for c in tight) >= 2  # the first squaring's and the loop's
    sized = tg.mcl_prepare(tf, iters=4, device="cpu")
    tg.mcl_size(sized)
    prep, got, fallbacks = cached_run(tf, dict(tg._budgets(sized), blk_caps=tight), own_cache,
                                      monkeypatch)
    assert fallbacks == 0 and prep["ran_with"] == tg._budgets(sized)
    assert type(prep["tplan"]).__name__ == type(jprep["tplan"]).__name__
    assert_flow(got, tg.markov_cluster(tcoo(g), iters=4, backend="scipy"))


def test_sizing_cache_entry_of_the_caps_format_loads(jax_weights, monkeypatch, own_cache):
    """An entry as the sizing sweep stored it when it also set caps
    (``p_pads`` and ``blk_caps``, the JAX package's margins over its
    per-block maxima) loads to the budgets a cold sweep gives, with no
    sweep, and runs the fast path."""
    g = rmat(8, edge_factor=8, seed=12)
    jf, tf = flows(g)
    jprep = jg.mcl_prepare(jf, iters=4)
    jg.mcl_size(jprep)
    assert jprep["p_pads"] and jprep["blk_caps"]
    cold = tg.mcl_prepare(tf, iters=4, device="cpu")
    tg.mcl_size(cold)
    entry = dict(tg._budgets(cold), blk_caps=list(jprep["blk_caps"]))
    prep, got, fallbacks = cached_run(tf, entry, own_cache, monkeypatch)
    assert prep["sizing_cached"] and fallbacks == 0
    assert tg._budgets(prep) == prep["ran_with"] == tg._budgets(cold)
    assert "blk_caps" not in prep
    assert_flow(got, tg.markov_cluster(tcoo(g), iters=4, backend="scipy"))
