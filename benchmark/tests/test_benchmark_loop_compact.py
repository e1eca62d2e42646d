"""The ``loop_compact_64_roofline`` reader on a trace and counts worked
out by hand."""

from __future__ import annotations

import pytest

from benchmark import trace as tracing
from benchmark.manifest import Manifest
from benchmark.tests.conftest import REPO


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


WIDE = "void (anonymous namespace)::loop_compact_kernel_wide(long long const*, float const*)"
FILL = "void (anonymous namespace)::loop_compact_fill_wide(unsigned int const*, unsigned int)"
NARROW = "void (anonymous namespace)::loop_compact_kernel(int const*, float const*)"
FIRST = "void (anonymous namespace)::prune_compact_kernel_wide(int const*, int const*)"
# two calls; the wide kernels 300 + 100 µs in the first, 200 µs in the second
TRACE = {"traceEvents": [
    _x("user_annotation", tracing.CALL_SPAN, 0, 1000),
    _x("user_annotation", tracing.CALL_SPAN, 1000, 1000),
    _x("kernel", WIDE, 100, 300),
    _x("kernel", FILL, 500, 100),
    _x("kernel", NARROW, 700, 50),
    _x("kernel", FIRST, 800, 100),
    _x("kernel", WIDE, 1100, 200),
]}
PEAKS = {"hbm_bytes_per_s": 1e12, "fp32_flops_per_s": 1.0}
# 5 B × (products of squarings 2-4: 10 000 + 6 000 + 4 000) + 20 B ×
# (survivors of squarings 2-4: 2 000 + 1 000 + 500) = 170 000 B: 0.17 µs
# at 1e12 B/s
WORK = {"products": [50_000, 10_000, 6_000, 4_000], "survivors": [3_000, 2_000, 1_000, 500]}


def _read(trace, work, peaks):
    return Manifest(REPO).reader("loop_compact_64_roofline")(tracing.parse(trace, work, peaks))


def test_share_of_the_wide_kernels_time_per_call():
    # 300 µs of the wide kernels a call; the 32-bit one and the first squaring's left out
    assert _read(TRACE, WORK, PEAKS) == pytest.approx(100 * 0.17 / 300)


def test_nothing_to_read():
    narrow = {"traceEvents": [e for e in TRACE["traceEvents"] if e["name"] not in (WIDE, FILL)]}
    assert _read(narrow, WORK, PEAKS) is None
    assert _read(TRACE, WORK, None) is None
    assert _read(TRACE, {}, PEAKS) is None
    assert _read(TRACE, {"K2_64_bytes": 1}, PEAKS) is None
