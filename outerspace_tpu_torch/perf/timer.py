"""Spans and counters inside the program, and device-synchronised timing.

A span (:func:`span`) marks a stage or phase of a call: ``mcl.run`` and
its stages, ``spgemm`` and its pick, plan and staging, the phases
``expand``, ``sort``, ``merge`` and ``compact`` in the helpers both
share, and ``fetch``. A span records only while ``torch.profiler`` is
recording in its thread; otherwise it costs one flag check and records
nothing. A recording span

- opens ``torch.profiler.record_function(name)``, so it sits in the
  profiler's Chrome trace (``user_annotation``) on the kernels' clock;
- keeps its name, attributes, its own, its parent's and its root's id
  (the root's id names the run), and its host start and end as Unix
  nanoseconds (``time.time_ns``, the clock a Chrome trace's
  ``ts + baseTimeNanoseconds / 1000`` reads in µs);
- where it or a span above it named a CUDA device, records a pair of
  CUDA events on that device's current stream at entry and exit,
  resolved to device milliseconds only in :func:`spans` (after a
  synchronise). Elsewhere a span's device time is its host time.

Two events time the stream between them, idle included: they read a
span's kernel time only where the host queues the span's work well
ahead of the card. So a span names a device only there (in the program,
``compact``); a span whose host work paces the card (the first
squaring's row parts under the profiler) names none, and its device
time is left to the profiler's trace.

Records sit in a bounded buffer (:data:`SPAN_BUFFER`; the oldest drop,
counted under ``timer.spans_dropped``); the span stack is per thread.
Counters (:func:`count`) count always. :func:`profiler_trace` traces a
scope and writes ``trace.json`` and ``spans.json`` side by side.

PyTorch queues work on the card and returns at once, so a host clock
stops only after ``torch.cuda.synchronize`` (:func:`device_sync`);
:func:`time_device` times work on the card by CUDA events and work on
the CPU by the host clock.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable

import torch
from torch.autograd.profiler import record_function

SPAN_BUFFER = 200_000  # span records kept; older ones drop

_profiler_enabled = torch.autograd._profiler_enabled


class _Recorder:
    """The process's span records, span stacks and counters."""

    def __init__(self):
        self.records = collections.deque(maxlen=SPAN_BUFFER)
        self.counts: dict[str, int] = {}
        self.ids = itertools.count()
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def add(self, rec) -> None:
        if len(self.records) == self.records.maxlen:
            self.count("timer.spans_dropped", 1)
        self.records.append(rec)


_REC = _Recorder()


class _Off:
    """The span while the profiler is not recording: it records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "device", "id", "parent", "root", "start_ns", "end_ns",
                 "events", "device_ms", "_rf")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.attrs, self.device = name, attrs, device
        self.events = self.device_ms = None

    def set(self, **attrs) -> None:
        """Add attributes to the span (a result known only inside it)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _REC.stack()
        parent = stack[-1] if stack else None
        self.id = next(_REC.ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        if self.device is None and parent is not None:
            self.device = parent.device
        # the host times hold the annotation's on the trace's clock
        self.start_ns = time.time_ns()
        self._rf = record_function(self.name)
        self._rf.__enter__()
        if self.device is not None:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        _REC.stack().pop()
        self._rf.__exit__(*exc)
        self._rf = None
        self.end_ns = time.time_ns()
        _REC.add(self)
        return False

    def as_dict(self) -> dict:
        host_ms = (self.end_ns - self.start_ns) / 1e6
        return {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
                "attrs": dict(self.attrs), "start_us": self.start_ns / 1e3,
                "end_us": self.end_ns / 1e3, "host_ms": host_ms,
                "device_ms": host_ms if self.device_ms is None else self.device_ms}


def span(name: str, device=None, **attrs):
    """A context manager that marks a stage or phase of the program under
    ``name`` while the profiler records (see the module's docstring), and
    does nothing otherwise. ``device``: a CUDA device gives the span and
    the spans under it device times by CUDA events (only where the host
    runs ahead of the card; see the module's docstring); a span that
    names none takes its parent's. ``attrs``: the span's attributes (JSON values); the
    span the ``with`` statement binds takes more through ``set``."""
    if not _profiler_enabled():
        return _OFF
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            device = None
    return _Span(name, device, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _REC.count(name, n)


def counters() -> dict[str, int]:
    """Every counter's value."""
    with _REC.lock:
        return dict(_REC.counts)


def spans() -> list[dict]:
    """The closed spans recorded, in the order they opened, as dicts:
    ``name``, ``id``, ``parent`` (None for a root), ``root`` (the run's
    id), ``attrs``, ``start_us`` / ``end_us`` (host, Unix µs),
    ``host_ms`` and ``device_ms`` (from the span's CUDA events, else its
    host time). Resolving CUDA events synchronises their devices."""
    recs = sorted(list(_REC.records), key=lambda r: r.id)
    pending = [r for r in recs if r.events is not None]
    for dev in {r.device for r in pending}:
        torch.cuda.synchronize(dev)
    for r in pending:
        r.device_ms = r.events[0].elapsed_time(r.events[1])
        r.events = None
    return [r.as_dict() for r in recs]


def reset() -> None:
    """Drop every span record and counter."""
    with _REC.lock:
        _REC.records.clear()
        _REC.counts.clear()


def _tensors(x):
    """The tensors in ``x`` (a tensor, or lists / tuples / dicts of them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def result_device(x):
    """The device of the first tensor in ``x``, or None if it holds none."""
    return next((t.device for t in _tensors(x)), None)


def device_sync(x) -> None:
    """Wait until the card has finished the work that made ``x``: one
    ``torch.cuda.synchronize`` per CUDA device among ``x``'s tensors (CPU
    tensors are complete when returned)."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_device(fn: Callable, reps: int = 5, warmup: int = 2) -> float:
    """Seconds per call of ``fn``, the least of ``reps`` calls after
    ``warmup``. Where ``fn``'s result lies on a CUDA device, each call is
    timed by CUDA events on that device's current stream; otherwise by the
    host clock."""
    dev = None
    for _ in range(max(warmup, 1)):
        out = fn()
        device_sync(out)
        dev = result_device(out)
    ts = []
    if dev is not None and dev.type == "cuda":
        with torch.cuda.device(dev):
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return min(ts)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """``torch.profiler`` over the scope (CPU activity, and the card's
    where CUDA is available), written as a Chrome trace to
    ``logdir/trace.json``, and the spans the scope recorded with every
    counter to ``logdir/spans.json`` (``{"spans": [...], "counters":
    {...}}``, as :func:`spans` and :func:`counters` give them). Yields
    the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    first = next(_REC.ids)  # spans opened from here on are the scope's
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"spans": [s for s in spans() if s["id"] > first], "counters": counters()}, f)
