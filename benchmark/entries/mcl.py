"""Markov clustering through the port's staged chain: set-up builds the
flow of the configuration's graph (``reference/mcl.py:flow_of``, the
benchmark's own code) and calls ``ops.graph.mcl_prepare`` (the first
squaring's host plan); each call is ``mcl_run(prep).to_csr()``, the whole
chain on the card and the final flow as a host CSR. The first warm-up
call sizes the loop's budgets: by the host sweep (``mcl_size``) in a
checkout's first run, from the program's sizing cache in ``build/``
after it.

Every call clusters the same flow, so the harness cannot tell a fresh
answer from a remembered one: a result cache keyed on ``prep`` is out of
bounds for the program. The check runs the plain reference
MCL (float64, on the card once the program's state is freed) and holds
the sampled calls' flows and cluster sets to it over the columns that no
prune within rounding of its threshold can have changed.
"""

from __future__ import annotations

from benchmark.reference import generators
from benchmark.reference import mcl as ref_mcl
from benchmark.reference.compare import compare_flows
from benchmark.sample import Sample, host_copy


class PortMcl:
    """The system under test: the staged MCL of one flow."""

    def __init__(self, flow, traffic: dict, device):
        from outerspace_tpu_torch.formats.csr import CSR
        from outerspace_tpu_torch.ops import graph

        self.graph = graph
        self.prep = graph.mcl_prepare(CSR(*flow), inflation=traffic["inflation"],
                                      iters=traffic["iters"],
                                      prune_threshold=traffic["prune_threshold"], device=device)
        self.fallbacks = 0

    def __call__(self, _operand):
        p_pad = self.prep.get("p_pad")
        c = self.graph.mcl_run(self.prep).to_csr()
        # a run whose budgets failed ran the exact fallback and doubled them
        self.fallbacks += p_pad is not None and self.prep["p_pad"] != p_pad
        return c.shape, c.indptr, c.indices, c.data


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device, program=None, *, band: float):
        self.seed, self.device, self.traffic, self.band = seed, device, traffic, band
        self.flow = ref_mcl.flow_of(generators.make(config))
        self.program = program or PortMcl(self.flow, traffic, device)
        # the harness draws the sample once the warm-up has set the pace
        self.sample = Sample(traffic["check_calls"], seed, traffic["check_calls"])
        self.kept: dict[int, tuple] = {}
        self.nnz: list[int] = []
        self.fallbacks = self.sizing_cached = self.near = self.uncertain_share = None

    def stage(self, calls: int) -> None:
        pass

    def operand(self, i: int):
        return None

    def call(self, operand):
        return self.program(operand)

    def observe(self, i: int, out) -> None:
        self.nnz.append(int(out[2].shape[0]))
        if i in self.sample:
            self.kept[i] = host_copy(out)

    def release(self) -> None:
        self.fallbacks = getattr(self.program, "fallbacks", None)
        prep = getattr(self.program, "prep", None)
        self.sizing_cached = bool(prep.get("sizing_cached")) if prep is not None else None
        self.program = None

    def check(self) -> dict:
        """The compared numbers over the sampled calls:
        ``struct_mismatch``, ``val_rel_err`` and ``cluster_mismatch``
        (``reference/compare.py:compare_flows``)."""
        t = self.traffic
        want, uncertain, self.near = ref_mcl.mcl(
            self.flow, iters=t["iters"], inflation=t["inflation"], threshold=t["prune_threshold"],
            device=self.device, band=self.band)
        out = {"struct_mismatch": 0, "val_rel_err": 0.0, "cluster_mismatch": 0}
        for _, got in sorted(self.kept.items()):
            r = compare_flows(got, want, uncertain, device=self.device)
            out["struct_mismatch"] += r["struct_mismatch"]
            out["val_rel_err"] = max(out["val_rel_err"], r["val_rel_err"])
            out["cluster_mismatch"] += r["cluster_mismatch"]
            self.uncertain_share = r["uncertain_share"]
        return out

    def info(self) -> dict:
        """The runs that fell back to the exact chain, whether the budgets
        came from the sizing cache, the reference's entries within
        ``band`` of the threshold per iteration, and the share of columns
        the check left out."""
        return {"fallbacks": self.fallbacks, "sizing_cached": self.sizing_cached,
                "near": self.near, "uncertain_share": self.uncertain_share}

    def work(self) -> dict:
        return {}
