"""The program's own spans and counters (``outerspace_tpu_torch.perf.timer``),
read by the ``program_span`` and ``program_counter`` metrics.

The program records spans only while the profiler records, so in a
``--trace 1`` run they are the traced calls' own. A program without
spans or counters gives None, and the metric is left out of the line.
"""

from __future__ import annotations


def _timer():
    try:
        from outerspace_tpu_torch.perf import timer
    except ImportError:
        return None
    return timer if hasattr(timer, "spans") and hasattr(timer, "counters") else None


def counters() -> dict | None:
    t = _timer()
    return None if t is None else t.counters()


def runs(root: str = "mcl.run") -> list | None:
    """Each root span named ``root``, in order, with the spans under it:
    ``[(root span, [descendants])]``; None without one."""
    t = _timer()
    if t is None:
        return None
    spans = t.spans()
    found = {s["id"]: (s, []) for s in spans if s["parent"] is None and s["name"] == root}
    for s in spans:
        if s["root"] in found and s["id"] != s["root"]:
            found[s["root"]][1].append(s)
    return [found[k] for k in sorted(found)] or None


def mean_per_run(per_run) -> float | None:
    """The mean over the ``mcl.run`` roots of ``per_run(root,
    descendants)``, runs where it gives None left out."""
    rs = runs()
    if rs is None:
        return None
    xs = [x for x in (per_run(r, below) for r, below in rs) if x is not None]
    return sum(xs) / len(xs) if xs else None


def self_device_ms(name: str) -> float | None:
    """Device ms of every span named ``name`` in a run less its child
    spans' device ms, mean per run."""
    def per_run(_, below):
        own = {s["id"]: s["device_ms"] for s in below if s["name"] == name}
        return sum(own.values()) - sum(s["device_ms"] for s in below if s["parent"] in own)

    return mean_per_run(per_run)
