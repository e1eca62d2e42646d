"""Runs on 64-bit keys: 100 × ``mcl.wide_runs`` ÷ ``mcl.runs``, the
program's counters over the process (warm-up and window); nothing where
the program counts no wide runs (a program without the wide path, or a
flow whose keys fit 32 bits)."""

from benchmark.program_spans import counters


def read(rec):
    c = counters()
    if not c or not c.get("mcl.runs") or "mcl.wide_runs" not in c:
        return None
    return 100.0 * c["mcl.wide_runs"] / c["mcl.runs"]
