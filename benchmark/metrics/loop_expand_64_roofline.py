"""The 64-bit-key loop expand kernel against its roofline: the bytes the
expands of the loop's squarings need, on the exact counts of
``benchmark/work/mcl.py`` (each product's int64 key and float32 value
written, 12 B a product of squarings 2 on; each entry of the flow that
enters those squarings read once, its key and value, 12 B a survivor of
squarings 1 to 3), over the peak bandwidth, over the device time of
``loop_expand_kernel_wide`` per traced run. A lower bound of the work:
the kernel also writes the budget's padded slots. Nothing is read where
the kernel did not run, without the counts, or on a card the peak table
does not hold."""

from benchmark.work.mcl import kernel_ms

BYTES_PER_ENTRY = 12  # an int64 key and a float32 value


def read(rec):
    products, survivors = rec.work.get("products"), rec.work.get("survivors")
    ms = kernel_ms(rec, ("loop_expand_kernel_wide",))
    if rec.peaks is None or not products or not survivors or not ms:
        return None
    nbytes = BYTES_PER_ENTRY * (sum(products[1:]) + sum(survivors[:-1]))
    return 100.0 * nbytes / rec.peaks["hbm_bytes_per_s"] / (ms / 1e3)
