"""Fetch to CSR: from the end of a call's last kernel to the call's
return (the copies of C to the host and the CSR built there), mean over
the traced calls."""

from benchmark.trace import mean


def read(rec):
    return mean((c.end - max(e for _, _, e in c.kernels)) / 1e3 for c in rec.calls if c.kernels)
