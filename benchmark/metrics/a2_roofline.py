"""The A² kernels' share of their roofline: the least time the card needs
for one product (``benchmark/work/a2.py``: the larger of its bytes over
the peak bandwidth and its operations over the float32 peak) over the
mean union of a call's kernel intervals. Nothing is read on a card the
peak table does not hold."""

from benchmark.trace import kernel_ms
from benchmark.work.a2 import least_seconds


def read(rec):
    ms = kernel_ms(rec)
    if rec.peaks is None or "bytes" not in rec.work or not ms:
        return None
    t_min, _ = least_seconds(rec.work, rec.peaks)
    return 100.0 * t_min * 1e3 / ms
