"""The sharded MCL loop's all_to_alls against the NVLink roofline: the
larger of the bytes rank 0 sent and received a run (the program's
counters ``mcl.exchange_bytes_sent`` and ``mcl.exchange_bytes_received``
over ``mcl.runs``: padded buckets included, the rank's chunk to itself
left out) over 450 GB/s (one direction of an H100's NVLink 4, 18 links
of 25 GB/s; ``perf/roofline.py:GPUConfig.nvlink_bw_bytes``), over the
trace time per traced run of the NCCL kernels that carry the
all_to_alls (their names hold ``SendRecv``; the loop's all_to_alls are
the only point-to-point collectives it runs, each inside an
``exchange`` span). Nothing is read where those kernels did not run (a
single rank, gloo) or without the counters."""

from benchmark.program_spans import counters
from benchmark.work.mcl import kernel_ms

NVLINK_BYTES_PER_S = 450e9
NCCL_ALL_TO_ALL = ("SendRecv",)


def read(rec):
    c = counters()
    if not c or not c.get("mcl.runs") or "mcl.exchange_bytes_sent" not in c:
        return None
    nbytes = max(c["mcl.exchange_bytes_sent"], c.get("mcl.exchange_bytes_received", 0))
    ms = kernel_ms(rec, NCCL_ALL_TO_ALL)
    if not ms or not nbytes:
        return None
    return 100.0 * nbytes / c["mcl.runs"] / NVLINK_BYTES_PER_S / (ms / 1e3)
