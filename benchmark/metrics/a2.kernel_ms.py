"""Device pipeline: the union of a call's kernel intervals, mean over the
traced calls."""

from benchmark.trace import kernel_ms


def read(rec):
    return kernel_ms(rec)
