"""Device idle share of the MCL runs: 1 − device activity (kernels,
copies, memsets) ÷ run time, over the traced runs."""

from benchmark.trace import idle_pct


def read(rec):
    return idle_pct(rec)
