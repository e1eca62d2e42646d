"""The LFR configuration's generator (``reference/lfr.py``) against its
configuration's bounds, the MCL work counts and roofline readers
(``work/mcl.py``) on cases worked out by hand, and the ``mcl_lfr`` entry
driven on the CPU at test size, with the bfloat16 control failing its
limits."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import control
from benchmark import trace as tracing
from benchmark.manifest import Manifest
from benchmark.reference import generators, lfr
from benchmark.reference import mcl as ref_mcl
from benchmark.run import run_cell
from benchmark.sample import Sample
from benchmark.tests.conftest import REPO
from benchmark.work.mcl import kernel_share, mcl_work, recurrence

CONFIG = "lfr19_k20_mu03"
CELL = "lfr19_k20_mu03.mcl4"


def _config(n):
    c = json.loads((REPO / "benchmark" / "configs" / f"{CONFIG}.json").read_text())
    c["n_vertices"] = n
    return c


def _graph(n, seed=None):
    c = _config(n)
    return lfr.lfr_graph(n, mean_degree=c["mean_degree"], max_degree=c["max_degree"],
                         tau1=c["tau1"], tau2=c["tau2"], min_community=c["min_community"],
                         max_community=c["max_community"], mixing=c["mixing"],
                         seed=c["graph_seed"] if seed is None else seed)


@pytest.fixture(scope="module")
def graph8k():
    return _graph(8192)


def test_generator_is_deterministic_symmetric_and_simple():
    a = lfr.make(_config(2048))
    b = lfr.make(_config(2048))
    assert all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))
    other = _config(2048)
    other["graph_seed"] += 1
    assert not np.array_equal(lfr.make(other)[2], a[2])
    (n, _), indptr, indices, data = a
    rows = np.repeat(np.arange(n), np.diff(indptr))
    assert not np.any(rows == indices)
    dense = np.zeros((n, n), np.float32)
    dense[rows, indices] = data
    assert np.array_equal(dense, dense.T) and set(np.unique(data)) == {1.0}
    # one entry per edge: no repeats left in the CSR
    assert np.unique(rows * n + indices).shape[0] == indices.shape[0]


def test_degrees_and_communities_within_the_configuration(graph8k):
    c = _config(8192)
    (n, _), indptr, indices, _ = graph8k[0]
    member = graph8k[1]
    deg = np.diff(indptr)
    assert deg.max() <= c["max_degree"]
    # the swaps keep every drawn degree (reference/lfr.py): the law's mean and floor
    assert deg.mean() == pytest.approx(c["mean_degree"], rel=0.01)
    assert deg.min() >= round(lfr.min_degree(c["mean_degree"], c["max_degree"], c["tau1"]))
    sizes = np.bincount(member)
    assert sizes.sum() == n and sizes.min() >= c["min_community"]
    assert sizes.max() <= c["max_community"]
    # every vertex fits its internal degree into its community
    rows = np.repeat(np.arange(n), deg)
    k_in = np.bincount(rows[member[rows] == member[indices]], minlength=n)
    assert np.all(k_in < sizes[member])


def test_mixing_share_near_mu(graph8k):
    (n, _), indptr, indices, _ = graph8k[0]
    member = graph8k[1]
    rows = np.repeat(np.arange(n), np.diff(indptr))
    share = float(np.mean(member[rows] != member[indices]))
    assert abs(share - _config(8192)["mixing"]) < 0.01


def test_power_law_mean_and_min_degree():
    k_min = lfr.min_degree(20, 50, 2.0)
    assert lfr._power_law_mean(2.0, k_min, 50) == pytest.approx(20.0, rel=1e-9)
    x = lfr._power_law(np.random.default_rng(0), 200_000, 2.0, k_min, 50)
    assert x.min() >= k_min and x.max() <= 50 and x.mean() == pytest.approx(20.0, rel=0.01)
    with pytest.raises(ValueError):
        lfr.min_degree(60, 50, 2.0)


def test_recurrence_counts_match_a_dense_walk():
    g = generators.rmat(6, edge_factor=4, seed=3)
    flow = ref_mcl.flow_of(g)
    counts = recurrence(flow, iters=3, inflation=2.0, threshold=1e-3)
    (n, _), indptr, indices, data = flow
    m = np.zeros((n, n))
    m[np.repeat(np.arange(n), np.diff(indptr)), indices] = data
    for i in range(3):
        s = m @ m
        assert counts["products"][i] == int(((m != 0).sum(0) * (m != 0).sum(1)).sum())
        assert counts["nnz"][i] == int(np.count_nonzero(s))
        p = np.maximum(s, 0) ** 2
        p[p <= 1e-3] = 0
        assert counts["survivors"][i] == int(np.count_nonzero(p))
        cs = p.sum(0)
        cs[cs == 0] = 1
        m = p / cs
    w = mcl_work(counts)
    assert w["K2_64_bytes"] == 25 * sum(counts["products"][1:])
    assert w["prune_compact_64_bytes"] == 5 * counts["products"][0] + 20 * counts["survivors"][0]


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


def test_kernel_share_sums_the_named_kernels():
    trace = {"traceEvents": [
        _x("user_annotation", tracing.CALL_SPAN, 0, 1000),
        _x("user_annotation", tracing.CALL_SPAN, 1000, 1000),
        _x("kernel", "void scan_tile_kernel_wide<true>(long long const*)", 100, 300),
        _x("kernel", "void scan_carry_kernel_wide(long long const*)", 400, 100),
        _x("kernel", "void scan_tile_kernel<true>(int const*)", 500, 50),
        _x("kernel", "void scan_tile_kernel_wide<true>(long long const*)", 1100, 200),
    ]}
    peaks = {"hbm_bytes_per_s": 1e12, "fp32_flops_per_s": 1.0}
    rec = tracing.parse(trace, {"K2_64_bytes": 3e5}, peaks)
    # 300 µs a call; 3e5 B at 1e12 B/s is 0.3 µs
    got = kernel_share(rec, "K2_64", ("scan_tile_kernel_wide", "scan_carry_kernel_wide"))
    assert got == pytest.approx(0.1)
    assert kernel_share(rec, "K2_64", ("prune_compact_kernel_wide",)) is None
    no_bytes = tracing.parse(trace, {}, peaks)
    assert kernel_share(no_bytes, "K2_64", ("scan_tile_kernel_wide",)) is None
    assert kernel_share(tracing.parse(trace, {"K2_64_bytes": 1}, None), "K2_64",
                        ("scan_tile_kernel_wide",)) is None
    m = Manifest(REPO)
    assert m.reader("K2_64_roofline")(rec) == pytest.approx(0.1)
    assert m.reader("prune_compact_64_roofline")(rec) is None


def test_lfr_cell_runs_on_the_cpu(tiny_repo):
    m = Manifest(tiny_repo)
    plain = run_cell(m, CELL, 2**31 + 23, 1.5, False, "cpu")
    assert plain["correct"] and plain["attempted"] > 3 and plain["failed"] == 0
    assert set(plain["metrics"]) == {"mcl_ms", "mcl_p95_ms", "setup_s"}
    # unit weights tie values at the prune threshold (PERF.md): most columns are left out
    assert plain["info"]["uncertain_share"] < 0.95
    traced = run_cell(m, CELL, 2**31 + 23, 0.5, True, "cpu")
    assert traced["correct"]
    got = traced["metrics"]
    # no card: no peaks, so no roofline; a flow this small keeps 32-bit keys
    assert {"mcl.fallback_pct", "mcl.compact_ms", "mcl.loop_ms"} <= set(got)
    assert "mcl.wide_pct" not in got and "K2_64_roofline" not in got
    assert got["mcl.fallback_pct"]["value"] == 0.0
    work = traced["info"]["work"]
    assert len(work["products"]) == 4 and work["K2_64_bytes"] == 25 * sum(work["products"][1:])


def test_control_fails_and_program_passes(tiny_repo):
    m = Manifest(tiny_repo)
    cell = m.cell(CELL)
    traffic = m.traffic(cell["traffic"])
    limits = m.cell_file(CELL)["limits"]
    check = m.cell_file(CELL)["check"]
    Entry = m.entry(traffic["entry"])
    for seed in (5, 2**31 + 5):
        prog = control.readings(m, CELL, seed, "program", None, "cpu")
        assert all(prog[k] <= v for k, v in limits.items()), prog
        # the bfloat16 control of the mcl entry, on this entry's flow
        entry = Entry(m.config(cell["config"]), traffic, seed, "cpu", program=lambda op: None,
                      **check)
        entry.program = control.control_program("mcl", traffic, entry, "cpu")
        entry.sample = Sample(3, seed, 3)
        for i in range(3):
            entry.observe(i, entry.call(None))
        entry.release()
        ctl = entry.check()
        assert any(ctl[k] > v for k, v in limits.items()), ctl

