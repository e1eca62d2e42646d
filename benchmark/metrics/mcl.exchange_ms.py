"""The sharded MCL loop's exchanges on rank 0's card: device ms of every
``exchange`` span of a run (CUDA events: the bucket fill and the
all_to_all, the wait for the other ranks included) less its child
spans, mean per traced run; nothing where the program has no such span
(the one-card chain, or a program without the sharded loop's spans)."""

from benchmark.program_spans import mean_per_run


def read(rec):
    def per_run(_, below):
        own = {s["id"]: s["device_ms"] for s in below if s["name"] == "exchange"}
        if not own:
            return None
        return sum(own.values()) - sum(s["device_ms"] for s in below if s["parent"] in own)

    return mean_per_run(per_run)
