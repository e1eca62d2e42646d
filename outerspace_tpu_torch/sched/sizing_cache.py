"""Persisted sizing cache: learned buffer budgets keyed by workload.

The staged MCL (``ops.graph.mcl_run``) sizes its loop buffers from a host
sizing sweep (``ops.graph.mcl_size``). The budgets depend only on the
workload (the flow's structure and the chain's parameters), so they are
kept in a small JSON file keyed by a content hash: a warm cache skips the
sweep. A copy of the JAX package's ``sched/sizing_cache.py``; the port's
keys carry their own prefix (``ops.graph.mcl_prepare``), so the two
packages never read each other's entries from one file.

Writes are best-effort (a read-only checkout falls back to the sweep).
The device ``ok`` flag downstream guards every cached budget with an
exact fallback, so a stale or corrupt entry costs only speed.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np

_ENV = "OUTERSPACE_SIZING_CACHE"


def cache_path() -> str:
    """Cache file location: ``$OUTERSPACE_SIZING_CACHE`` or
    ``<repo>/build/sizing_cache.json`` (``build/`` is not committed)."""
    p = os.environ.get(_ENV)
    if p:
        return p
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "build", "sizing_cache.json")


def workload_key(arrays: tuple, params: tuple) -> str:
    """Content hash over operand structure + chain parameters.

    ``arrays``: numpy arrays whose bytes define the workload (e.g. CSR
    indptr/indices). ``params``: the chain's scalar knobs (a prefix,
    iters, inflation, threshold, ...)."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(repr(params).encode())
    return h.hexdigest()[:24]


def _load() -> dict:
    try:
        with open(cache_path()) as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, ValueError):
        return {}


# keys that may hold None (a disabled per-iteration schedule); None in
# any other key is corruption and is dropped, so the sweep re-runs
_NONE_OK = frozenset({"p_pads"})


def _coerce(k, v):
    """Sizing values are ints, int lists (per-iteration schedules) or,
    for the schedule keys only, None; anything else is rejected."""
    if v is None:
        return None if k in _NONE_OK else _reject()
    if isinstance(v, bool):
        return _reject()
    if isinstance(v, int):
        return v
    if isinstance(v, list) and all(isinstance(x, int) and not isinstance(x, bool) for x in v):
        return [int(x) for x in v]
    return _reject()


def _reject():
    raise ValueError("unsupported sizing value")


def lookup(key: str) -> dict | None:
    """The cached sizing dict for ``key`` (ints, int lists or None
    markers; torn or malformed values dropped), or None."""
    got = _load().get(key)
    if not isinstance(got, dict):
        return None
    out = {}
    for k, v in got.items():
        try:
            out[k] = _coerce(k, v)
        except ValueError:
            continue
    return out


def store(key: str, sizes: dict) -> None:
    """Best-effort atomic write of ``sizes`` under ``key``: a temporary
    file in the cache's directory, then a rename over the cache."""
    path = cache_path()
    try:
        d = _load()
        d[key] = {k: _coerce(k, v) for k, v in sizes.items()}
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(d, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass
