"""K2's 64-bit-key instantiation against its roofline: the bytes its
merges of the loop's squarings need (``benchmark/work/mcl.py``: 25 B a
product of each loop squaring, exact counts) over the peak bandwidth,
over the device time of its kernels (``scan_tile_kernel_wide``,
``scan_carry_kernel_wide``) per traced run. Nothing is read where they
did not run or on a card the peak table does not hold."""

from benchmark.work.mcl import kernel_share


def read(rec):
    return kernel_share(rec, "K2_64", ("scan_tile_kernel_wide", "scan_carry_kernel_wide"))
