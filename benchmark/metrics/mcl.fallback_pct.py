"""Runs off the fast path: 100 × ``mcl.fallbacks`` ÷ ``mcl.runs``, the
program's counters over the process (warm-up and window)."""

from benchmark.program_spans import counters


def read(rec):
    c = counters()
    if not c or not c.get("mcl.runs"):
        return None
    return 100.0 * c.get("mcl.fallbacks", 0) / c["mcl.runs"]
