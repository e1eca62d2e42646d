"""A² through the port's main entry point: ``spgemm(B, B,
strategy=..., device="cuda")``, a host CSR in and an exact host CSR out.

B's structure is the configuration's graph, the same in every run; each
call's values are drawn anew from (seed, call), so no call can be
answered from an earlier one. They are drawn in set-up for as many calls
as the window should hold at the warm-up's pace, and between calls for
any beyond those (counted as ``drawn_in_window``). A symmetric
configuration gets symmetric values, (i, j) and (j, i) alike. The check
makes the values of the sampled calls again and multiplies them with the
plain reference (``reference/spgemm.py``, float64, on the card once the
program's state is freed).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import generators
from benchmark.reference.compare import compare_csr
from benchmark.reference.spgemm import csr_matmul
from benchmark.sample import Sample, host_copy
from benchmark.work.a2 import a2_work


def port_program(strategy: str, device):
    """The system under test: one ``spgemm`` call per operand."""
    from outerspace_tpu_torch.formats.csr import CSR
    from outerspace_tpu_torch.ops.spgemm import spgemm

    def run(operand):
        b = CSR(*operand)
        c = spgemm(b, b, strategy=strategy, device=device)
        return c.shape, c.indptr, c.indices, c.data

    return run


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device, program=None):
        self.seed, self.device, self.traffic = seed, device, traffic
        b = generators.make(config)
        self.shape, self.indptr, self.indices, _ = b
        nnz = self.indices.shape[0]
        # each stored entry takes the value drawn for the first of (i, j), (j, i)
        self.canon = (np.minimum(np.arange(nnz), generators.mirror(b))
                      if config.get("symmetric", False) else None)
        self.staged: dict[int, np.ndarray] = {}
        self.drawn_in_window = 0
        self.program = program or port_program(traffic["strategy"], device)
        # the harness draws the sample once the warm-up has set the pace
        self.sample = Sample(traffic["check_calls"], seed, traffic["check_calls"])
        self.kept: dict[int, tuple] = {}
        self.nnz: list[int] = []
        self.nnz_c = None

    def values(self, i: int) -> np.ndarray:
        """Call ``i``'s values, from (seed, call) alone."""
        vals = generators.call_values(self.seed, i, self.indices.shape[0])
        return vals if self.canon is None else vals[self.canon]

    def stage(self, calls: int) -> None:
        # at most 1 GiB of values staged
        calls = min(calls, (1 << 30) // max(4 * self.indices.shape[0], 1))
        self.staged = {i: self.values(i) for i in range(calls)}

    def operand(self, i: int):
        vals = self.staged.pop(i, None)
        if vals is None:
            vals = self.values(i)
            self.drawn_in_window += i >= 0
        return self.shape, self.indptr, self.indices, vals

    def call(self, operand):
        return self.program(operand)

    def observe(self, i: int, out) -> None:
        self.nnz.append(int(out[2].shape[0]))
        if i in self.sample:
            self.kept[i] = host_copy(out)

    def release(self) -> None:
        self.program = None
        self.staged = {}

    def check(self) -> dict:
        """The compared numbers: ``struct_mismatch`` and ``val_rel_err``
        over the sampled calls, ``calls_nnz_mismatch`` over every call."""
        struct, rel = 0, 0.0
        for i, got in sorted(self.kept.items()):
            a = self.shape, self.indptr, self.indices, self.values(i)
            want = csr_matmul(a, a, precision="float64", device=self.device)
            r = compare_csr(got, want, device=self.device)
            struct += r["struct_mismatch"]
            rel = max(rel, r["val_rel_err"])
            self.nnz_c = int(want[2].shape[0])
        mismatch = sum(1 for z in self.nnz if z != self.nnz_c)
        return {"struct_mismatch": struct, "val_rel_err": rel, "calls_nnz_mismatch": mismatch}

    def info(self) -> dict:
        return {"nnz_b": int(self.indices.shape[0]), "nnz_c": self.nnz_c,
                "drawn_in_window": self.drawn_in_window}

    def work(self) -> dict:
        return a2_work(self.shape, self.indptr, self.indices, self.nnz_c or 0)
