"""Scope timers and device-synchronised timing.

``Timer`` / ``timed`` time a host scope (the JAX package's
``perf/timer.py``). PyTorch queues work on the card and returns at once,
so a host clock stops only after ``torch.cuda.synchronize``
(:func:`device_sync`); :func:`time_device` times work on the card by CUDA
events and work on the CPU by the host clock.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable


class Timer(contextlib.AbstractContextManager):
    """Wall-clock scope timer; prints ``[caption] seconds`` to ``out``
    (default: the standard error at exit) unless ``quiet``. ``elapsed``
    holds the seconds."""

    def __init__(self, caption: str, out=None, quiet: bool = False):
        self.caption = caption
        self.out = out
        self.quiet = quiet
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if not self.quiet:
            print(f"[{self.caption}] {self.elapsed:.6f}s", file=self.out or sys.stderr)
        return False


def timed(caption: str | None = None):
    """Decorator form of :class:`Timer`."""

    def deco(fn: Callable):
        name = caption or fn.__name__

        def wrapper(*a, **kw):
            with Timer(name):
                return fn(*a, **kw)

        return wrapper

    return deco


def _tensors(x):
    """The tensors in ``x`` (a tensor, or lists / tuples / dicts of them)."""
    import torch

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
    import torch

    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_device(fn: Callable, reps: int = 5, warmup: int = 2) -> float:
    """Seconds per call of ``fn``, the least of ``reps`` calls after
    ``warmup``. Where ``fn``'s result lies on a CUDA device, each call is
    timed by CUDA events on that device's current stream; otherwise by the
    host clock."""
    import torch

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
    ``logdir/trace.json``. Yields the profiler (``key_averages()``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
