"""The 64-bit-key loop prune-and-compact kernel against its roofline: the
bytes the prune and in-order compaction of the loop's merged streams
need, on the exact counts of ``benchmark/work/mcl.py`` (5 B a product of
squarings 2 on, the value and valid byte of its merged slot read; 20 B a
survivor of those squarings, its int64 key read and its key and float32
value written), over the peak bandwidth, over the device time of
``loop_compact_kernel_wide`` and ``loop_compact_fill_wide`` per traced
run. A lower bound of the work: the kernel also reads the budget's padded
slots. Nothing is read where the kernels did not run, without the counts,
or on a card the peak table does not hold."""

from benchmark.work.mcl import kernel_ms

BYTES_PER_SLOT = 5  # a float32 value and a valid byte
BYTES_PER_SURVIVOR = 20  # an int64 key read, an int64 key and a float32 value written


def read(rec):
    products, survivors = rec.work.get("products"), rec.work.get("survivors")
    ms = kernel_ms(rec, ("loop_compact_kernel_wide", "loop_compact_fill_wide"))
    if rec.peaks is None or not products or not survivors or not ms:
        return None
    nbytes = BYTES_PER_SLOT * sum(products[1:]) + BYTES_PER_SURVIVOR * sum(survivors[1:])
    return 100.0 * nbytes / rec.peaks["hbm_bytes_per_s"] / (ms / 1e3)
