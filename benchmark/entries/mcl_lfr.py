"""Markov clustering of an LFR community graph through the port's staged
chain: the ``mcl`` entry (``entries/mcl.py``) with its graph drawn by
``reference/lfr.py`` in place of ``generators.make``. Set-up builds the
flow (``reference/mcl.py:flow_of``) and calls ``ops.graph.mcl_prepare``;
each call is ``mcl_run(prep).to_csr()``; the check holds the sampled
calls to the plain reference MCL as the ``mcl`` entry does.

``work()`` runs the reference's recurrence once more (float64, on the
card, after the check) to count each squaring's exact products and
survivors, and gives the 64-bit-key kernels' bytes from them
(``work/mcl.py``).
"""

from __future__ import annotations

from benchmark.entries.mcl import Entry as MclEntry
from benchmark.entries.mcl import PortMcl
from benchmark.reference import lfr
from benchmark.reference import mcl as ref_mcl
from benchmark.sample import Sample
from benchmark.work.mcl import mcl_work, recurrence


class Entry(MclEntry):
    def __init__(self, config: dict, traffic: dict, seed: int, device, program=None, *,
                 band: float):
        self.seed, self.device, self.traffic, self.band = seed, device, traffic, band
        self.flow = ref_mcl.flow_of(lfr.make(config))
        self.program = program or PortMcl(self.flow, traffic, device)
        # the harness draws the sample once the warm-up has set the pace
        self.sample = Sample(traffic["check_calls"], seed, traffic["check_calls"])
        self.kept: dict[int, tuple] = {}
        self.nnz: list[int] = []
        self.fallbacks = self.sizing_cached = self.near = self.uncertain_share = None
        self._work = None

    def work(self) -> dict:
        if self._work is None:
            t = self.traffic
            self._work = mcl_work(recurrence(
                self.flow, iters=t["iters"], inflation=t["inflation"],
                threshold=t["prune_threshold"], device=self.device))
        return self._work
