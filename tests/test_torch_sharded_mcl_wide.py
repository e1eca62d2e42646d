"""The device-resident sharded MCL loop past m² = 2³², where its keys
take int64 (``ops.kernels.compact.key_dtype``), on the CPU: one world of
4 gloo ranks clusters a community graph of 65,600 vertices (the one of
``tests/test_torch_mcl_wide.py``) on the (4,) mesh:

- the flow against scipy's MCL and the benchmark's plain reference:
  structure and cluster sets exact, values within the wide tests'
  tolerances; the same flow on every rank; K2 handed int64 keys; rank 0
  alone ran the sizing recurrence; the counters (runs, wide runs, no
  fallback, the exchange's bytes, the rank's products);
- a starved expansion budget falls back to the exact host-planned loop
  (rebased to part-local keys), its report naming the budget;
- the plan's keys: int64 from m² ≥ 2³², int32 below, and its per-rank
  shards equal to slices of the stacked arrays;
- ``shard.mcl.ShardedMcl``: a world of 4 kept alive across calls
  (``shard.mesh.LiveWorld``), each call's flow exact (a smaller graph,
  on 32-bit keys), every rank's
  report, no rank left after ``close``; a rank that raises ends the
  process within seconds, and no rank outlives it.

It imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_sharded_mcl_wide.py
"""

import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import mcl as ref_mcl
from benchmark.reference.compare import compare_flows
from outerspace_tpu_torch.formats.csr import CSR
from outerspace_tpu_torch.ops import graph
from outerspace_tpu_torch.shard import mcl as smcl
from outerspace_tpu_torch.shard.mesh import run_world

from test_torch_mcl_wide import ITERS, N_WIDE, assert_flows_equal, community_graph

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sizing") / "sizing.json")


@pytest.fixture(autouse=True)
def sizing_cache(cache, monkeypatch):
    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", cache)


@pytest.fixture(scope="module")
def wide():
    g = community_graph(N_WIDE)
    return g, graph.markov_cluster(g, iters=ITERS, backend="scipy")


@pytest.fixture(scope="module")
def world(wide, cache):
    """One gloo world of 4 CPU ranks: the fast path, then the starved run."""
    import os

    from torch_rank_fns import wide_mcl  # noqa: F401  (importable by name in the ranks)

    old = os.environ.get("OUTERSPACE_SIZING_CACHE")
    os.environ["OUTERSPACE_SIZING_CACHE"] = cache
    try:
        return run_world(_both, 4, backend="gloo", device="cpu", args=(wide[0],), timeout=600)
    finally:
        if old is None:
            os.environ.pop("OUTERSPACE_SIZING_CACHE")
        else:
            os.environ["OUTERSPACE_SIZING_CACHE"] = old


def _both(adj):
    from torch_rank_fns import wide_mcl

    return wide_mcl(adj, ITERS, device="cpu"), wide_mcl(adj, ITERS, starve=True, device="cpu")


def test_wide_device_loop_equals_scipy_and_the_reference(wide, world):
    g, want = wide
    c = g.to_csr()
    flow = ref_mcl.flow_of((c.shape, c.indptr, c.indices, c.data))
    ref, uncertain, _ = ref_mcl.mcl(flow, iters=ITERS, inflation=2.0, threshold=1e-4, band=1e-4)
    first = None
    for rank, ((got, report, k2_dtypes, delta), _) in enumerate(world):
        got = CSR(*got)
        assert report["fast_path"] and report["wide"] and report["failed_budgets"] == []
        assert report["iterations"] == ITERS and report["host_reads"] == 2
        assert k2_dtypes == ["torch.int64"]
        assert report["sized_here"] == (rank == 0)
        assert_flows_equal(got, want)
        r = compare_flows((got.shape, got.indptr, got.indices, got.data), ref, uncertain)
        assert r["struct_mismatch"] == 0 and r["cluster_mismatch"] == 0
        assert r["val_rel_err"] < 1e-4 and r["uncertain_share"] < 0.5
        if first is None:
            first = got
        else:  # the same flow on every rank
            np.testing.assert_array_equal(got.indptr, first.indptr)
            np.testing.assert_array_equal(got.indices, first.indices)
            np.testing.assert_array_equal(got.data, first.data)
        assert delta["mcl.runs"] == 1 and delta["mcl.wide_runs"] == 1
        assert "mcl.fallbacks" not in delta
        assert delta["mcl.rank_products"] == sum(report["products"]) > 0
        # two all_to_alls an iteration, 3 of the 4 buckets to other ranks,
        # 12 B a slot (int64 key, float32 value)
        slots = 3 * (report["cap"] + report["ecap"]) * ITERS
        assert delta["mcl.exchange_bytes_sent"] == delta["mcl.exchange_bytes_received"] \
            == 12 * slots


def test_starved_budget_falls_back_exact(wide, world):
    _, want = wide
    for _, (got, report, _, delta) in world:
        assert_flows_equal(CSR(*got), want)
        assert report["fast_path"] is False and report["failed_budgets"] == ["p_pad"]
        assert report["host_reads"] == 1 and report["fallback"]["loop"] == "host"
        assert delta["mcl.fallbacks"] == 1


@pytest.mark.parametrize("m,dtype", [(65_535, torch.int32), (65_536, torch.int64),
                                     (N_WIDE, torch.int64), (4_096, torch.int32)])
def test_plan_keys_from_m_alone(m, dtype):
    from outerspace_tpu_torch.formats import erdos_renyi

    flow = graph._mcl_setup(erdos_renyi(m, m, 3.0 / m, seed=5))
    plan = smcl.plan_mcl_sharded_device(flow, kx=4, iters=2)
    assert plan.key_dtype == dtype
    assert plan.flow_k.dtype == (np.int64 if dtype == torch.int64 else np.int32)
    sentinel = 2**63 - 1 if dtype == torch.int64 else 2**31 - 1
    assert (plan.flow_k != sentinel).sum() == flow.nnz
    for i in range(4):
        for f, x in enumerate(plan.shard(i, 0)):
            np.testing.assert_array_equal(x, plan._stacked[f][i, 0])
    bounds = smcl._owner_bounds(plan, "cpu")
    assert bounds.dtype == dtype and bool((bounds[1:] >= bounds[:-1]).all())


def test_sizing_runs_once_then_comes_from_the_cache(monkeypatch):
    from outerspace_tpu_torch.formats import erdos_renyi

    flow = graph._mcl_setup(erdos_renyi(300, 300, 0.02, seed=9))
    calls = []
    real = smcl._sharded_mcl_sizing
    monkeypatch.setattr(smcl, "_sharded_mcl_sizing", lambda *a: calls.append(a) or real(*a))
    a = smcl.plan_mcl_sharded_device(flow, kx=4, iters=3)
    b = smcl.plan_mcl_sharded_device(flow, kx=4, iters=3)
    c = smcl.plan_mcl_sharded_device(flow, kx=2, iters=3)  # another mesh: another key
    assert len(calls) == 2
    assert (a.p_pad, a.cap, a.ecap, a.nb, a.na) == (b.p_pad, b.cap, b.ecap, b.nb, b.na)
    assert c.kx == 2


def test_sharded_mcl_keeps_its_world_across_calls():
    # a graph whose keys fit 32 bits: the wide path is the fixture's
    g = community_graph(4_000, seed=3)
    want = graph.markov_cluster(g, iters=ITERS, backend="scipy")
    plan = smcl.plan_mcl_sharded_device(graph._mcl_setup(g), kx=4, iters=ITERS)
    service = smcl.ShardedMcl(plan, backend="gloo", device="cpu")
    procs = service.world._procs
    try:
        for _ in range(2):
            assert_flows_equal(service(), want)
            assert [r["rank"] for r in service.reports] == [0, 1, 2, 3]
            assert all(r["fast_path"] and not r["wide"] for r in service.reports)
            assert len({tuple(r["products"]) for r in service.reports}) > 1  # each its own
    finally:
        service.close()
    assert all(not p.is_alive() for p in procs)
    import torch.distributed as dist

    assert not dist.is_initialized()


FAILING_RANK = """
import sys, time
sys.path.insert(0, {tests!r})
from outerspace_tpu_torch.shard.mesh import LiveWorld
from torch_live_fns import failing_step
world = LiveWorld(3, failing_step, backend="gloo", device="cpu", timeout=60)
world.ready()
print("pids", *[p.pid for p in world._procs], flush=True)
world.call(lambda: __import__("torch.distributed").distributed.barrier())
print("not reached", flush=True)
"""


def test_a_rank_that_raises_ends_the_world_within_seconds(tmp_path):
    code = FAILING_RANK.format(tests=str(REPO / "tests"))
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 1, p.stderr[-2000:]
    assert "rank 2 raised" in p.stderr and "not reached" not in p.stdout
    assert time.monotonic() - t0 < 60
    pids = [int(x) for x in p.stdout.split("pids", 1)[1].split()]
    time.sleep(0.5)
    for pid in pids:  # killed with the process, not left behind
        assert not Path(f"/proc/{pid}").exists() or "zombie" in _state(pid)


def _state(pid):
    try:
        return Path(f"/proc/{pid}/status").read_text().lower()
    except OSError:
        return "zombie"
