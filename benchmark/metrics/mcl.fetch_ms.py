"""Fetch to CSR after an MCL run: host ms of the ``fetch`` span (device
compaction, nnz read, pinned copies, the host CSR) that follows each
``mcl.run`` before the next, mean per traced run."""

from benchmark.program_spans import runs


def read(rec):
    mcl, fetches = runs(), runs("fetch")
    if mcl is None or fetches is None:
        return None
    starts = [r["start_us"] for r, _ in mcl] + [float("inf")]
    xs = []
    for (r, _), nxt in zip(mcl, starts[1:]):
        after = [f for f, _ in fetches if r["end_us"] <= f["start_us"] < nxt]
        if after:
            xs.append(after[0]["host_ms"])
    return sum(xs) / len(xs) if xs else None
