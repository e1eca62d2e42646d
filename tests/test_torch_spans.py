"""The program's spans and counters (``outerspace_tpu_torch/perf/timer.py``)
on the CPU: nothing recorded, and no ``record_function`` or CUDA event
entered, while the profiler is off; the staged MCL's and ``spgemm()``'s
span trees under ``profiler_trace``, in the exported Chrome trace and in
``spans.json``; the fallback's counter and attribute; and the benchmark's
readers of them (``benchmark/metrics/mcl.*``) on a span buffer whose
numbers are worked out by hand."""

import json
import threading
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.manifest import Manifest
from outerspace_tpu_torch.formats import rmat
from outerspace_tpu_torch.ops import graph
from outerspace_tpu_torch.ops.spgemm import spgemm
from outerspace_tpu_torch.perf import timer

REPO = Path(__file__).resolve().parent.parent
ITERS = 4
PHASES = {"expand", "sort", "merge", "compact"}


@pytest.fixture(autouse=True)
def clean(tmp_path, monkeypatch):
    """Every test starts with no span or counter, and a sizing cache of its own."""
    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(tmp_path / "sizing.json"))
    timer.reset()
    yield
    timer.reset()


def _prep(iters=ITERS, seed=3, scale=7):
    flow = graph._mcl_setup(rmat(scale, edge_factor=8, seed=seed))
    return graph.mcl_prepare(flow, iters=iters, device="cpu")


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_untraced_calls_record_nothing_and_enter_no_annotation(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered while the profiler was off")

    monkeypatch.setattr(timer, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    prep = _prep()
    for _ in range(2):
        graph.mcl_run(prep).to_csr()
    a = rmat(6, edge_factor=8, seed=5)
    spgemm(a, a, device="cpu")
    assert timer.spans() == []
    assert timer.counters() == {"mcl.runs": 2}


def test_traced_mcl_run_tree(tmp_path):
    prep = _prep()
    graph.mcl_run(prep)  # sized outside the trace
    with timer.profiler_trace(str(tmp_path)):
        graph.mcl_run(prep).to_csr()
    sp = timer.spans()
    by_id = {s["id"]: s for s in sp}
    roots = [s for s in sp if s["parent"] is None]
    assert [r["name"] for r in roots] == ["mcl.run", "fetch"]
    run = roots[0]
    assert run["attrs"] == {"fallback": False}
    stages = [s for s in sp if s["parent"] == run["id"]]
    assert [s["name"] for s in stages] == (["mcl.square1", "compact"]
                                           + ["mcl.iteration"] * (ITERS - 1)
                                           + ["mcl.finish", "mcl.wait"])
    iterations = [s for s in stages if s["name"] == "mcl.iteration"]
    assert [s["attrs"]["iteration"] for s in iterations] == list(range(2, ITERS + 1))
    for it in iterations:
        assert [s["name"] for s in sp if s["parent"] == it["id"]] == ["expand", "sort", "merge", "compact"]
    square1 = {s["name"] for s in sp if s["parent"] == stages[0]["id"]}
    assert square1 == {"expand", "sort", "merge"}
    under = [s for s in sp if s["root"] == run["id"] and s is not run]
    assert PHASES <= {s["name"] for s in under}
    for s in sp:
        assert s["device_ms"] == s["host_ms"] >= 0  # no CUDA device: host time
        if s["parent"] is None:
            assert s["root"] == s["id"]
            continue
        p = by_id[s["parent"]]
        assert s["root"] == p["root"]
        assert p["start_us"] <= s["start_us"] <= s["end_us"] <= p["end_us"]
        # a phase never sits inside a span of its own name
        while p is not None:
            assert p["name"] != s["name"]
            p = by_id.get(p["parent"])

    trace = json.loads((tmp_path / "trace.json").read_text())
    annotations = [e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"]
    assert {s["name"] for s in sp} <= {e["name"] for e in annotations}
    # the spans' host clock is the trace's (Unix µs): each span's host
    # interval holds its annotation (50 µs for rounding)
    base = trace["baseTimeNanoseconds"] / 1e3
    annotations.sort(key=lambda e: e["ts"])
    assert [e["name"] for e in annotations] == [s["name"] for s in sp]
    for e, s in zip(annotations, sp):
        assert s["start_us"] - 50 <= e["ts"] + base <= e["ts"] + e["dur"] + base <= s["end_us"] + 50
    saved = json.loads((tmp_path / "spans.json").read_text())
    assert saved["spans"] == sp
    assert saved["counters"] == {"mcl.runs": 2}


def _same_flow(got, want):
    g, w = got.to_scipy().tocsr(), want.to_scipy().tocsr()
    g.sort_indices()
    w.sort_indices()
    np.testing.assert_array_equal(g.indptr, w.indptr)
    np.testing.assert_array_equal(g.indices, w.indices)
    np.testing.assert_allclose(g.data, w.data, rtol=5e-4, atol=1e-5)


def test_fallback_counted_and_marked(tmp_path):
    g = rmat(8, edge_factor=8, seed=12)
    prep = graph.mcl_prepare(graph._mcl_setup(g), iters=3, device="cpu")
    prep.update(p_pad=4096, nnz_pad=1024)  # too small: ok reads false
    with timer.profiler_trace(str(tmp_path)):
        out = graph.mcl_run(prep).to_csr()
    assert timer.counters() == {"mcl.runs": 1, "mcl.fallbacks": 1}
    sp = timer.spans()
    run = next(s for s in sp if s["name"] == "mcl.run")
    assert run["attrs"] == {"fallback": True}
    stages = [s["name"] for s in sp if s["parent"] == run["id"]]
    assert stages[-2:] == ["mcl.wait", "mcl.fallback"]
    _same_flow(out, graph.markov_cluster(g, iters=3, backend="scipy"))


@pytest.mark.parametrize("strategy", ["gather", "tiles", "flat", "auto"])
def test_spgemm_span_tree(strategy, tmp_path):
    a = rmat(7, edge_factor=8, seed=5)
    with timer.profiler_trace(str(tmp_path)):
        spgemm(a, a, strategy=strategy, device="cpu")
    sp = timer.spans()
    by_id = {s["id"]: s for s in sp}
    (root,) = [s for s in sp if s["parent"] is None]
    assert root["name"] == "spgemm"
    assert root["attrs"]["strategy"] in ({strategy} if strategy != "auto" else {"gather", "tiles", "flat"})
    children = [s["name"] for s in sp if s["parent"] == root["id"]]
    assert children[0] == "spgemm.plan" and children[-1] == "fetch"
    assert ("spgemm.pick" in children) == (strategy == "auto")
    stages = [s for s in sp if s["name"] == "spgemm.stage"]
    assert stages and all(by_id[s["parent"]]["name"] in ("spgemm", "spgemm.plan") for s in stages)
    assert {"expand", "sort", "merge"} <= {s["name"] for s in sp}
    assert all(s["root"] == root["id"] for s in sp)


def test_span_nesting_threads_attributes_and_errors(monkeypatch):
    # the profiler's flag is its thread's: here every thread records
    monkeypatch.setattr(timer, "_profiler_enabled", lambda: True)
    seen = []

    def in_thread():
        with timer.span("thread"):
            seen.append(True)

    with timer.span("a", k=1) as a:
        a.set(j=2)
        with timer.span("b"):
            t = threading.Thread(target=in_thread)
            t.start()
            t.join(timeout=60)
    with pytest.raises(ValueError):
        with timer.span("c"):
            raise ValueError("inside a span")
    with timer.span("d"):
        pass
    assert not t.is_alive() and seen
    sp = {s["name"]: s for s in timer.spans()}
    assert sp["a"]["attrs"] == {"k": 1, "j": 2}
    assert sp["b"]["parent"] == sp["a"]["id"] and sp["b"]["root"] == sp["a"]["id"]
    # another thread's span has a stack of its own
    assert sp["thread"]["parent"] is None
    # a span left by an exception is recorded and leaves the stack
    assert sp["c"]["parent"] is None and sp["d"]["parent"] is None


def test_counters_bounded_buffer_and_reset(monkeypatch):
    timer.count("x")
    timer.count("x", 3)
    assert timer.counters() == {"x": 4}
    monkeypatch.setattr(timer._REC, "records", deque(maxlen=2))
    with _cpu_profile():
        for name in ("s0", "s1", "s2"):
            with timer.span(name):
                pass
    assert [s["name"] for s in timer.spans()] == ["s1", "s2"]
    assert timer.counters() == {"x": 4, "timer.spans_dropped": 1}
    timer.reset()
    assert timer.spans() == [] and timer.counters() == {}


def test_cuda_events_only_under_a_span_that_names_the_card(monkeypatch):
    class Event:  # reads the order of the records as milliseconds
        made, records = [], 0

        def __init__(self, enable_timing):
            Event.made.append(self)
            self.at = None

        def record(self, stream):
            Event.records += 1
            self.at = Event.records

        def elapsed_time(self, end):
            return float(end.at - self.at)

    monkeypatch.setattr(timer, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    with timer.span("run"):
        with timer.span("expand"):
            pass
        with timer.span("compact", device="cuda:0"):
            with timer.span("sort"):
                pass
        with timer.span("merge", device="cpu"):
            pass
    assert len(Event.made) == 4  # compact's pair and its sort's
    sp = {s["name"]: s for s in timer.spans()}
    assert sp["sort"]["device_ms"] == 1.0  # records 2 and 3
    assert sp["compact"]["device_ms"] == 3.0  # records 1 and 4
    for name in ("run", "expand", "merge"):
        assert sp[name]["device_ms"] == sp[name]["host_ms"]


def _span(i, name, parent, root, *, dev=0.0, start=0.0, end=0.0):
    return {"name": name, "id": i, "parent": parent, "root": root, "attrs": {},
            "start_us": start, "end_us": end, "host_ms": (end - start) / 1e3, "device_ms": dev}


# two runs, each followed by its fetch (device ms; host µs); the readers
# take the compactions' device ms and the fetches' host ms
#   run 0 [0, 10000): square1 6.0 (expand 2.0, sort 3.0, merge 0.5 + 0.25),
#     compact 1.0 (sort 0.3, merge 0.1), iteration 2.0 (expand 0.8, sort
#     0.6, merge 0.2, compact 0.4 (merge 0.1)), finish 0.5 (sort 0.4),
#     wait from 1500; fetch [10100, 10400)
#   run 19 [20000, 30000): square1 4.0 (expand 1.0, sort 2.0, merge 1.0),
#     compact 0.5, wait from 22500; fetch [30100, 30600)
SPANS = [
    _span(0, "mcl.run", None, 0, start=0, end=10000),
    _span(1, "mcl.square1", 0, 0, dev=6.0), _span(2, "expand", 1, 0, dev=2.0),
    _span(3, "sort", 1, 0, dev=3.0), _span(4, "merge", 1, 0, dev=0.5),
    _span(5, "merge", 1, 0, dev=0.25),
    _span(6, "compact", 0, 0, dev=1.0), _span(7, "sort", 6, 0, dev=0.3),
    _span(8, "merge", 6, 0, dev=0.1),
    _span(9, "mcl.iteration", 0, 0, dev=2.0), _span(10, "expand", 9, 0, dev=0.8),
    _span(11, "sort", 9, 0, dev=0.6), _span(12, "merge", 9, 0, dev=0.2),
    _span(13, "compact", 9, 0, dev=0.4), _span(14, "merge", 13, 0, dev=0.1),
    _span(15, "mcl.finish", 0, 0, dev=0.5), _span(16, "sort", 15, 0, dev=0.4),
    _span(17, "mcl.wait", 0, 0, start=1500, end=1600),
    _span(18, "fetch", None, 18, start=10100, end=10400),
    _span(19, "mcl.run", None, 19, start=20000, end=30000),
    _span(20, "mcl.square1", 19, 19, dev=4.0), _span(21, "expand", 20, 19, dev=1.0),
    _span(22, "sort", 20, 19, dev=2.0), _span(23, "merge", 20, 19, dev=1.0),
    _span(24, "compact", 19, 19, dev=0.5),
    _span(25, "mcl.wait", 19, 19, start=22500, end=22600),
    _span(26, "fetch", None, 26, start=30100, end=30600),
]
WANT = {
    # compact less its children: (1.0 - 0.4) + (0.4 - 0.1) in run 0, 0.5 in run 19
    "mcl.compact_ms": (0.6 + 0.3 + 0.5) / 2,
    "mcl.fetch_ms": (0.3 + 0.5) / 2,
}


def _reader(name):
    return Manifest(REPO).reader(name)


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers_by_hand(name, monkeypatch):
    monkeypatch.setattr(timer, "spans", lambda: [dict(s) for s in SPANS])
    assert _reader(name)(None) == pytest.approx(WANT[name])
    # no mcl.run root: nothing to read
    monkeypatch.setattr(timer, "spans", lambda: [s for s in SPANS if s["name"] != "mcl.run"])
    assert _reader(name)(None) is None
    # a program without spans (older than them): nothing, and no error
    monkeypatch.delattr(timer, "spans")
    assert _reader(name)(None) is None


def test_fallback_reader(monkeypatch):
    read = _reader("mcl.fallback_pct")
    monkeypatch.setattr(timer, "counters", lambda: {"mcl.runs": 8, "mcl.fallbacks": 2})
    assert read(None) == pytest.approx(25.0)
    monkeypatch.setattr(timer, "counters", lambda: {"mcl.runs": 3})
    assert read(None) == 0.0
    monkeypatch.setattr(timer, "counters", lambda: {})
    assert read(None) is None
