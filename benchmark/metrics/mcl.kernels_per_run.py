"""The host's queueing of the MCL chain: device kernels launched per run,
mean over the traced runs."""

from benchmark.trace import mean


def read(rec):
    return mean(len(c.kernels) for c in rec.calls)
