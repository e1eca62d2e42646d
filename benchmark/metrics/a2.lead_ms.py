"""Strategy pick and host plan: from a call's start to the start of its
first device kernel (the operands' copies to the card included), mean
over the traced calls."""

from benchmark.trace import mean


def read(rec):
    return mean((c.kernels[0][1] - c.start) / 1e3 for c in rec.calls if c.kernels)
