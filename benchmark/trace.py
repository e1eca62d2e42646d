"""The traced run's record: ``torch.profiler`` (CPU and CUDA activity)
over a stretch of the window's real calls, read back from its Chrome
trace.

The harness wraps each call in a ``record_function`` span named
:data:`CALL_SPAN`; every device kernel, copy and memset is given to the
call whose span holds its start (each call ends in a synchronisation,
so its device work ends inside its span). The per-layer readers in
``benchmark/metrics/`` take a :class:`Record` and return a number, or
None where there is nothing to read.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict

CALL_SPAN = "benchmark.call"
KERNEL_CATS = ("kernel",)
COPY_CATS = ("gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)


@dataclasses.dataclass
class Call:
    """One call's span (µs on the trace's clock) and its device work."""

    start: float
    end: float
    kernels: list = dataclasses.field(default_factory=list)  # (name, start, end)
    copies: list = dataclasses.field(default_factory=list)  # (name, start, end)

    @property
    def duration(self) -> float:
        return self.end - self.start

    def device_ops(self) -> list:
        return sorted(self.kernels + self.copies, key=lambda e: e[1])


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads: the traced calls, the host's torch
    ops, the work of one call (``benchmark/work``) and the card's peaks
    (None for a card the table does not hold)."""

    calls: list
    host_ops: list  # (name, start, end)
    work: dict
    peaks: dict | None

    def __post_init__(self):
        self.host_starts = [h[1] for h in self.host_ops]

    @property
    def window(self) -> tuple[float, float]:
        return self.calls[0].start, self.calls[-1].end


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def parse(trace: dict, work: dict, peaks: dict | None) -> Record:
    """A :class:`Record` from a Chrome trace (``export_chrome_trace``)."""
    spans, device, host = [], [], []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat"), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        if cat == "user_annotation" and name == CALL_SPAN:
            spans.append(Call(s, e))
        elif cat in KERNEL_CATS or cat in COPY_CATS:
            device.append((cat, name, s, e))
        elif cat in HOST_CATS:
            host.append((name, s, e))
    spans.sort(key=lambda c: c.start)
    starts = [c.start for c in spans]
    for cat, name, s, e in sorted(device, key=lambda d: d[2]):
        i = bisect.bisect_right(starts, s) - 1
        if i < 0 or s > spans[i].end:
            continue  # device work outside every call (none is expected)
        (spans[i].kernels if cat in KERNEL_CATS else spans[i].copies).append((name, s, e))
    return Record(spans, sorted(host, key=lambda h: h[1]), work, peaks)


def load(path, work: dict, peaks: dict | None) -> Record:
    with open(path) as f:
        return parse(json.load(f), work, peaks)


def busy_us(rec: Record) -> float:
    """Device activity (kernels, copies, memsets) over the traced calls."""
    return sum(union_us([(s, e) for _, s, e in c.device_ops()]) for c in rec.calls)


def _gap_label(rec: Record, s: float, e: float, in_call: bool) -> str:
    """What the host did in an idle gap: the innermost torch op that
    covers its middle, else whether it lay inside a call."""
    mid = 0.5 * (s + e)
    best = None
    i = bisect.bisect_right(rec.host_starts, mid)
    for name, hs, he in rec.host_ops[max(0, i - 256):i]:
        if hs <= mid <= he and (best is None or he - hs < best[2] - best[1]):
            best = (name, hs, he)
    if best is not None:
        return best[0]
    return "host code outside torch ops, in a call" if in_call else "between calls"


def breakdown(rec: Record, top: int = 10) -> dict:
    """``device_ops``: the device ops that took the most time, summed by
    name; ``idle_gaps``: the device's idle time inside the traced
    window, summed by what the host was doing (:func:`_gap_label`). Both
    in seconds, the ``top`` largest."""
    by_op = defaultdict(float)
    gaps = defaultdict(float)
    prev_end = None
    for c in rec.calls:
        if prev_end is not None and c.start > prev_end:
            gaps[_gap_label(rec, prev_end, c.start, False)] += c.start - prev_end
        t = c.start
        for name, s, e in c.device_ops():
            by_op[name[:160]] += e - s
            if s > t:
                gaps[_gap_label(rec, t, s, True)] += s - t
            t = max(t, e)
        if c.end > t:
            gaps[_gap_label(rec, t, c.end, True)] += c.end - t
        prev_end = c.end

    def top_s(d):
        return [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_s(by_op), "idle_gaps": top_s(gaps)}


def mean(xs) -> float | None:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def kernel_ms(rec: Record) -> float | None:
    """Mean over the traced calls of the union of their kernels' intervals."""
    return mean(union_us([(s, e) for _, s, e in c.kernels]) / 1e3 for c in rec.calls if c.kernels)


def idle_pct(rec: Record) -> float | None:
    """100 × (1 − device activity ÷ call time), over the traced calls."""
    total = sum(c.duration for c in rec.calls)
    if not total:
        return None
    busy = sum(union_us([(s, e) for _, s, e in c.device_ops()]) for c in rec.calls)
    return 100.0 * (1.0 - busy / total)
