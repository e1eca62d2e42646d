"""Which of a window's answers the check compares: a sample of call
numbers drawn from the run's seed before the window opens, so that the
window holds no more than copies of the sampled answers."""

from __future__ import annotations

import numpy as np


class Sample:
    """``k`` call numbers drawn from ``seed`` among the first ``span``
    calls of the window."""

    def __init__(self, k: int, seed: int, span: int):
        rng = np.random.default_rng([seed % (1 << 64), 0x5EED])
        self.calls = frozenset(int(i) for i in rng.choice(span, size=min(k, span), replace=False))

    @classmethod
    def paced(cls, k: int, seed: int, seconds: float, call_s: float) -> "Sample":
        """Draws among the first half of the calls a window of
        ``seconds`` completes at ``call_s`` a call (at least ``k``)."""
        return cls(k, seed, max(k, int(0.5 * seconds / max(call_s, 1e-6))))

    def __contains__(self, i: int) -> bool:
        return i in self.calls


def host_copy(answer):
    """A sampled answer copied out of the program's buffers (a pinned
    buffer kept alive would make the program allocate a new one)."""
    shape, *arrays = answer
    return (shape, *(np.array(a, copy=True) for a in arrays))
