"""The MCL chain on the card: the union of a run's kernel intervals, mean
over the traced runs."""

from benchmark.trace import kernel_ms


def read(rec):
    return kernel_ms(rec)
