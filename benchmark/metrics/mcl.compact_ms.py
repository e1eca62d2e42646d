"""The MCL chain's prune, compaction, inflation and column
normalisation: device ms of every ``compact`` span of a run less its
child spans (its sorts and K2's column sums), mean per traced run."""

from benchmark.program_spans import self_device_ms


def read(rec):
    return self_device_ms("compact")
