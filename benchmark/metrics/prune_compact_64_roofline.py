"""The 64-bit-key prune-and-compact kernel against its roofline: the
bytes the first squaring's prune and compaction need
(``benchmark/work/mcl.py``: 5 B a product, 20 B a survivor, exact
counts) over the peak bandwidth, over the device time of its kernels
(``prune_compact_kernel_wide``, ``prune_compact_tail_wide``) per traced
run. Nothing is read where they did not run or on a card the peak table
does not hold."""

from benchmark.work.mcl import kernel_share


def read(rec):
    return kernel_share(rec, "prune_compact_64",
                        ("prune_compact_kernel_wide", "prune_compact_tail_wide"))
