"""The MCL chain's loop: device ms of the ``mcl.loop`` span (CUDA events
over the loop's iterations: expand, sort, K2, prune, compaction, column
normalisation), mean per traced run; nothing where the program has no
such span."""

from benchmark.program_spans import mean_per_run


def read(rec):
    def per_run(_, below):
        loops = [s["device_ms"] for s in below if s["name"] == "mcl.loop"]
        return sum(loops) if loops else None

    return mean_per_run(per_run)
