"""The per-layer readers and the trace's reduction on a synthetic
timeline whose numbers are worked out by hand."""

from __future__ import annotations

import pytest

from benchmark import trace as tracing
from benchmark.manifest import Manifest
from benchmark.tests.conftest import REPO
from benchmark.work.a2 import a2_work, least_seconds


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


# two calls, µs:
#   call 0 [0, 1000): copy 100-150, kernels 200-300 and 250-400, copy 900-950
#   call 1 [1100, 2100): kernel 1500-1600, kernel 1700-1750, copy 2000-2050
# host ops: "plan" 0-190 (in call 0), "aten::sort" 1600-1700 (in call 1)
TIMELINE = {"traceEvents": [
    _x("user_annotation", tracing.CALL_SPAN, 0, 1000),
    _x("user_annotation", tracing.CALL_SPAN, 1100, 1000),
    _x("gpu_memcpy", "Memcpy HtoD", 100, 50),
    _x("kernel", "k1", 200, 100),
    _x("kernel", "k2", 250, 150),
    _x("gpu_memcpy", "Memcpy DtoH", 900, 50),
    _x("kernel", "k1", 1500, 100),
    _x("kernel", "k3", 1700, 50),
    _x("gpu_memcpy", "Memcpy DtoH", 2000, 50),
    _x("cpu_op", "plan", 0, 190),
    _x("cpu_op", "aten::sort", 1600, 100),
    {"ph": "M", "name": "process_name"},
]}
WORK = {"bytes": 3.35e6, "flops": 1.0}  # 1 µs at 3.35 TB/s
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}


@pytest.fixture
def rec():
    return tracing.parse(TIMELINE, WORK, PEAKS)


def test_parse_gives_each_call_its_device_work(rec):
    assert [(c.start, c.end) for c in rec.calls] == [(0, 1000), (1100, 2100)]
    assert [k[0] for k in rec.calls[0].kernels] == ["k1", "k2"]
    assert len(rec.calls[0].copies) == 2 and len(rec.calls[1].copies) == 1
    assert rec.window == (0, 2100)


def test_union_and_busy(rec):
    assert tracing.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    # call 0: 50 + 200 (200-400) + 50; call 1: 100 + 50 + 50
    assert tracing.busy_us(rec) == 500


def _read(name, rec):
    return Manifest(REPO).reader(name)(rec)


def test_a2_readers(rec):
    assert _read("a2.lead_ms", rec) == pytest.approx((0.2 + 0.4) / 2)
    assert _read("a2.kernel_ms", rec) == pytest.approx((0.2 + 0.15) / 2)
    assert _read("a2.tail_ms", rec) == pytest.approx((0.6 + 0.35) / 2)
    assert _read("a2.idle_pct", rec) == pytest.approx(100 * (1 - 500 / 2000))
    # 1 µs over a mean kernel time of 175 µs
    assert _read("a2_roofline", rec) == pytest.approx(100 / 175)


def test_mcl_readers(rec):
    assert _read("mcl.kernel_ms", rec) == pytest.approx(0.175)
    assert _read("mcl.kernels_per_run", rec) == 2
    assert _read("mcl.idle_pct", rec) == pytest.approx(75.0)


def test_readers_return_nothing_without_something_to_read():
    empty = tracing.parse({"traceEvents": [_x("user_annotation", tracing.CALL_SPAN, 0, 10)]}, {}, None)
    for name in ("a2.lead_ms", "a2.kernel_ms", "a2.tail_ms", "a2_roofline", "mcl.kernel_ms"):
        assert _read(name, empty) is None
    # no peaks for the card: no roofline share
    assert _read("a2_roofline", tracing.parse(TIMELINE, WORK, None)) is None


def test_breakdown(rec):
    b = tracing.breakdown(rec)
    ops = dict((k, v) for k, v in b["device_ops"])
    assert ops["k1"] == pytest.approx(200e-6) and ops["k2"] == pytest.approx(150e-6)
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # call 0: 0-100 under "plan"; 150-200 under "plan" (mid 175 < 190);
    # 400-900 and 950-1000 outside any op; between calls 1000-1100;
    # call 1: 1100-1500 outside, 1600-1700 under aten::sort, 1750-2000
    # and 2050-2100 outside
    assert gaps["plan"] == pytest.approx(150e-6)
    assert gaps["aten::sort"] == pytest.approx(100e-6)
    assert gaps["between calls"] == pytest.approx(100e-6)
    assert gaps["host code outside torch ops, in a call"] == pytest.approx((500 + 50 + 400 + 250 + 50) * 1e-6)


def test_a2_work_by_hand():
    # A = [[1, 1, 0], [0, 0, 1], [0, 1, 0]]: col nnz (1, 2, 1), row nnz (2, 1, 1)
    indptr = [0, 2, 3, 4]
    indices = [0, 1, 2, 1]
    # A² = [[1, 1, 1], [0, 1, 0], [0, 0, 1]]: 5 entries
    w = a2_work((3, 3), indptr, indices, nnz_c=5)
    assert w["products"] == 1 * 2 + 2 * 1 + 1 * 1
    assert w["flops"] == 10
    # each CSR: 8 bytes per offset (4), 4 + 4 per entry
    assert w["bytes"] == (32 + 32) + (32 + 32) + (32 + 40)
    t, bound = least_seconds(w, PEAKS)
    assert bound == "bytes" and t == pytest.approx(200 / 3.35e12)
