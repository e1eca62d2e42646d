"""Device idle share of the A² calls: 1 − device activity (kernels,
copies, memsets) ÷ call time, over the traced calls."""

from benchmark.trace import idle_pct


def read(rec):
    return idle_pct(rec)
