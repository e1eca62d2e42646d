"""The sharded MCL cell (``lfr21_k20_mu03.mcl4_x4``) on the CPU, its
configuration cut to 1,024 vertices and its mesh of 4 ranks run by gloo:

- the ``mcl_sharded`` entry's set-up, calls, check and ``release()``,
  after which no rank is left;
- a plan that raises ends the set-up at once, with no rank spawned;
- the graph kept in ``build/`` once drawn, read back equal;
- the ``mcl.exchange_ms`` and ``mcl.exchange_roofline`` readers on a
  recorded trace and counters worked out by hand;
- the cell's traced run: the spans and counters its metrics read are
  the ones the program records.
"""

from __future__ import annotations

import multiprocessing

import numpy as np
import pytest

from benchmark import program_spans
from benchmark import trace as tracing
from benchmark.manifest import Manifest
from benchmark.run import run_cell
from benchmark.tests import conftest as _fixtures
from benchmark.tests.conftest import REPO

CONFIG = "lfr21_k20_mu03"
CELL = "lfr21_k20_mu03.mcl4_x4"
_fixtures.TINY.setdefault(CONFIG, {"n_vertices": 1024})

SPANS = {"mcl.run", "mcl.loop", "mcl.iteration", "expand", "sort", "merge", "exchange",
         "allreduce", "fetch"}
COUNTERS = {"mcl.runs", "mcl.exchange_bytes_sent", "mcl.exchange_bytes_received",
            "mcl.rank_products"}


@pytest.fixture(autouse=True)
def sizing_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(tmp_path / "sizing.json"))


def _entry(m, seed, **kw):
    cell = m.cell(CELL)
    traffic = m.traffic(cell["traffic"])
    Entry = m.entry(traffic["entry"])
    return Entry(m.config(cell["config"]), traffic, seed, "cpu", **m.cell_file(CELL)["check"],
                 **kw)


def test_entry_calls_checks_and_releases_its_world(tiny_repo):
    m = Manifest(tiny_repo)
    entry = _entry(m, 2**31 + 7)
    procs = list(entry.program.service.world._procs)
    assert len(procs) == 3 and all(p.is_alive() for p in procs)
    entry.sample = entry.sample.__class__(2, 7, 3)
    for i in range(3):
        entry.observe(i, entry.call(entry.operand(i)))
    assert len(entry.kept) == 2 and len(set(entry.nnz)) == 1
    entry.release()
    assert all(not p.is_alive() for p in procs) and not multiprocessing.active_children()
    import torch.distributed as dist

    assert not dist.is_initialized()
    out = entry.check()
    assert out["struct_mismatch"] == 0 and out["cluster_mismatch"] == 0
    assert out["val_rel_err"] < 1e-4
    info = entry.info()
    assert [r["rank"] for r in info["ranks"]] == [0, 1, 2, 3] and info["fallbacks"] == 0
    assert all(len(r["products"]) == 4 and r["exchange_bytes_sent"] > 0 for r in info["ranks"])
    # the ranks' products of a run are the recurrence's, split by row owner
    work = entry.work()
    assert len(work["products"]) == 4
    assert [sum(r["products"][t] for r in info["ranks"]) for t in range(4)] == work["products"]


def test_plan_that_raises_spawns_no_rank(tiny_repo, monkeypatch):
    from outerspace_tpu_torch.shard import mcl as smcl
    from outerspace_tpu_torch.shard import mesh

    def refuse(*a, **kw):
        raise ValueError("device MCL loop needs m^2 < 2^32 (packed keys)")

    def spawn(*a, **kw):
        raise AssertionError("a rank was spawned")

    monkeypatch.setattr(smcl, "plan_mcl_sharded_device", refuse)
    monkeypatch.setattr(mesh.LiveWorld, "__init__", spawn)
    with pytest.raises(ValueError, match="m\\^2 < 2\\^32"):
        _entry(Manifest(tiny_repo), 3)
    assert not multiprocessing.active_children()


def test_full_size_configuration_refused_on_the_cpu():
    with pytest.raises(ValueError, match="run on the cards"):
        _entry(Manifest(REPO), 3)


def test_graph_kept_once_drawn(tmp_path):
    from benchmark.entries.mcl_sharded import cached_graph
    from benchmark.reference import lfr

    config = dict(Manifest(REPO).config(CONFIG), n_vertices=1024)
    first = cached_graph(config, tmp_path, min_vertices=0)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    again = cached_graph(config, tmp_path, min_vertices=0)
    want = lfr.make(config)
    for a, b, c in zip(first[1:], again[1:], want[1:]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert first[0] == again[0] == want[0]
    # another seed is another graph, kept beside the first
    other = cached_graph(dict(config, graph_seed=config["graph_seed"] + 1), tmp_path,
                         min_vertices=0)
    assert len(list(tmp_path.glob("*.npz"))) == 2
    assert other[1].shape != want[1].shape or not np.array_equal(other[2], want[2])


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


A2A = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
# two calls: all_to_all kernels of 300 + 100 µs and of 400 µs; an all-reduce
# and an all-gather left out
TRACE = {"traceEvents": [
    _x("user_annotation", tracing.CALL_SPAN, 0, 1000),
    _x("user_annotation", tracing.CALL_SPAN, 1000, 1000),
    _x("kernel", A2A, 100, 300),
    _x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
       450, 50),
    _x("kernel", A2A, 600, 100),
    _x("kernel", A2A, 1100, 400),
    _x("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 1600, 80),
]}


class _Timer:
    def __init__(self, spans, counters):
        self._spans, self._counters = spans, counters

    def spans(self):
        return self._spans

    def counters(self):
        return self._counters


def _span(name, id_, parent, root, device_ms):
    return {"name": name, "id": id_, "parent": parent, "root": root, "attrs": {},
            "start_us": 0.0, "end_us": 1.0, "host_ms": 99.0, "device_ms": device_ms}


def test_exchange_readers_on_a_recorded_trace(monkeypatch):
    m = Manifest(REPO)
    # two runs; run 0: exchanges of 5 and 3 ms, one with a 1 ms child; run 1: 4 ms
    spans = [
        _span("mcl.run", 0, None, 0, 50.0), _span("mcl.loop", 1, 0, 0, 40.0),
        _span("exchange", 2, 1, 0, 5.0), _span("sort", 3, 2, 0, 1.0),
        _span("exchange", 4, 1, 0, 3.0),
        _span("mcl.run", 5, None, 5, 50.0), _span("exchange", 6, 5, 5, 4.0),
    ]
    # 90 MB sent and 81 MB received over 2 runs: 45 MB a run, 0.1 ms at 450 GB/s;
    # the all_to_all kernels take 0.4 ms a traced call: 25%
    counters = {"mcl.runs": 2, "mcl.exchange_bytes_sent": 90_000_000,
                "mcl.exchange_bytes_received": 81_000_000}
    monkeypatch.setattr(program_spans, "_timer", lambda: _Timer(spans, counters))
    rec = tracing.parse(TRACE, {}, None)
    assert m.reader("mcl.exchange_ms")(rec) == pytest.approx(((5 - 1 + 3) + 4) / 2)
    assert m.reader("mcl.exchange_roofline")(rec) == pytest.approx(25.0)
    # nothing to read: no all_to_all kernel, no counters, no exchange span
    quiet = tracing.parse({"traceEvents": [e for e in TRACE["traceEvents"] if e["name"] != A2A]},
                          {}, None)
    assert m.reader("mcl.exchange_roofline")(quiet) is None
    monkeypatch.setattr(program_spans, "_timer", lambda: _Timer(spans, {"mcl.runs": 2}))
    assert m.reader("mcl.exchange_roofline")(rec) is None
    one_card = [_span("mcl.run", 0, None, 0, 50.0), _span("mcl.loop", 1, 0, 0, 40.0)]
    monkeypatch.setattr(program_spans, "_timer", lambda: _Timer(one_card, counters))
    assert m.reader("mcl.exchange_ms")(rec) is None


def test_traced_cell_reads_the_programs_spans_and_counters(tiny_repo):
    from outerspace_tpu_torch.perf import timer

    timer.reset()
    m = Manifest(tiny_repo)
    traced = run_cell(m, CELL, 2**31 + 29, 0.5, True, "cpu")
    assert traced["correct"], traced["checks"]
    got = traced["metrics"]
    # no card: no NCCL kernel, so no roofline; a flow this small keeps 32-bit keys
    assert {"mcl.exchange_ms", "mcl.fallback_pct", "mcl.loop_ms", "mcl.fetch_ms"} <= set(got)
    assert "mcl.exchange_roofline" not in got and "mcl.wide_pct" not in got
    assert got["mcl.fallback_pct"]["value"] == 0.0 and got["mcl.exchange_ms"]["value"] > 0
    assert SPANS <= {s["name"] for s in timer.spans()}
    assert COUNTERS <= set(timer.counters())
    for name in ("mcl.exchange_ms", "mcl.exchange_roofline"):
        metric = next(x for x in m.data["per_layer"] if x["name"] == name)
        assert metric["workloads"] == [CELL] and metric["layer"] == "sharded exchange"
    assert not multiprocessing.active_children()
    plain = run_cell(m, CELL, 2**31 + 31, 0.5, False, "cpu")
    assert plain["correct"] and set(plain["metrics"]) == {"mcl_ms", "mcl_p95_ms", "setup_s"}
