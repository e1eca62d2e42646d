"""Markov clustering of an LFR community graph over a mesh of cards, through
the port's device-resident sharded loop (``shard/mcl.py``).

Set-up draws the graph (``reference/lfr.py``; past :data:`CACHE_VERTICES`
vertices kept in ``build/`` once drawn, keyed on the configuration and
its seed: the input, never a result), builds the flow
(``reference/mcl.py:flow_of``) and, in this process, sizes and plans the
loop (``plan_mcl_sharded_device``) before any rank is spawned, so a
program that refuses the plan fails at once with no world left behind.
Then ``shard.mcl.ShardedMcl`` starts the other ranks of the traffic's
mesh as workers that stay alive across calls, one card each over nccl
(gloo on the CPU); this process is rank 0, on card 0. Each call runs
the loop on every rank and returns rank 0's host CSR; ``release()``
stops the workers and joins them. The check holds the sampled calls to
the plain reference MCL as the ``mcl`` entry does.

``info()`` reports every rank's memory peak, products and fallbacks;
``work()`` the exact counts of the reference's recurrence (float64, on
the card, after the check), as ``entries/mcl_lfr.py`` does. A traced
run records rank 0's card; the ranks run the same program on their own
shards.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from benchmark.entries.mcl import Entry as MclEntry
from benchmark.reference import lfr
from benchmark.reference import mcl as ref_mcl
from benchmark.sample import Sample
from benchmark.work.mcl import recurrence

BUILD = Path(__file__).resolve().parents[2] / "build" / "benchmark_graphs"
CACHE_VERTICES = 1 << 20  # graphs this large take minutes to draw: kept once drawn
CPU_VERTICES = 1 << 16  # a run on the CPU (the tests) takes a test-size cut


def cached_graph(config: dict, root: Path = BUILD, min_vertices: int = CACHE_VERTICES):
    """``lfr.make(config)``, kept in ``root`` (an ``.npz`` named by a hash
    of the configuration, its ``graph_seed`` included) for a graph of at
    least ``min_vertices`` vertices, and read back from there after."""
    if config["n_vertices"] < min_vertices:
        return lfr.make(config)
    digest = hashlib.sha256(json.dumps(config, sort_keys=True).encode()).hexdigest()[:20]
    path = root / f"{config['name']}-{digest}.npz"
    try:
        with np.load(path) as z:
            return (tuple(int(x) for x in z["shape"]), z["indptr"], z["indices"], z["data"])
    except (OSError, KeyError, ValueError):
        pass
    g = lfr.make(config)
    root.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, shape=np.asarray(g[0]), indptr=g[1], indices=g[2], data=g[3])
    tmp.replace(path)
    return g


class PortShardedMcl:
    """The system under test: the sharded device loop of one flow over a
    world of ranks kept alive across calls."""

    def __init__(self, flow, traffic: dict, device):
        import torch

        from outerspace_tpu_torch.formats.csr import CSR
        from outerspace_tpu_torch.shard import mcl as smcl

        shape = tuple(traffic["mesh"])
        plan = smcl.plan_mcl_sharded_device(
            CSR(*flow), kx=shape[0], ny=shape[1] if len(shape) > 1 else 1,
            inflation=traffic["inflation"], iters=traffic["iters"],
            prune_threshold=traffic["prune_threshold"])
        cuda = torch.device(device).type == "cuda"
        self.service = smcl.ShardedMcl(plan, backend="nccl" if cuda else "gloo", device=device)
        self.plan = plan
        self.reports: list[dict] = []
        self.fallbacks = 0

    def __call__(self, _operand):
        c = self.service()
        self.reports = self.service.reports
        self.fallbacks += not self.reports[0]["fast_path"]
        return c.shape, c.indptr, c.indices, c.data

    def close(self) -> None:
        self.service.close()


class Entry(MclEntry):
    def __init__(self, config: dict, traffic: dict, seed: int, device, program=None, *,
                 band: float):
        import torch

        self.seed, self.device, self.traffic, self.band = seed, device, traffic, band
        if program is None:
            # the program's sharded service, before any graph is drawn
            from outerspace_tpu_torch.shard.mcl import ShardedMcl  # noqa: F401
        if torch.device(device).type == "cpu" and config["n_vertices"] > CPU_VERTICES:
            raise ValueError(f"{config['name']}: {config['n_vertices']} vertices run on the cards; "
                             f"the CPU takes a test-size cut (at most {CPU_VERTICES})")
        self.flow = ref_mcl.flow_of(cached_graph(config))
        self.program = program or PortShardedMcl(self.flow, traffic, device)
        # the harness draws the sample once the warm-up has set the pace
        self.sample = Sample(traffic["check_calls"], seed, traffic["check_calls"])
        self.kept: dict[int, tuple] = {}
        self.nnz: list[int] = []
        self.fallbacks = self.sizing_cached = self.near = self.uncertain_share = None
        self.ranks: list[dict] = []
        self._work = None

    def release(self) -> None:
        program, self.program = self.program, None
        self.fallbacks = getattr(program, "fallbacks", None)
        if isinstance(program, PortShardedMcl):
            self.ranks = [{"rank": r["rank"], "memory_peak_bytes": r["memory_peak_bytes"],
                           "products": r["products"],
                           "fallbacks": r["counters"].get("mcl.fallbacks", 0),
                           "exchange_bytes_sent": r["counters"].get("mcl.exchange_bytes_sent", 0)}
                          for r in program.reports]
            program.close()

    def info(self) -> dict:
        """The runs that fell back to the host-planned loop, the
        reference's entries within ``band`` of the threshold per iteration,
        the share of columns the check left out, and each rank's memory
        peak, products per iteration of the last run, fallbacks and bytes
        sent by its all_to_alls (over every call)."""
        return {"fallbacks": self.fallbacks, "near": self.near,
                "uncertain_share": self.uncertain_share, "ranks": self.ranks}

    def work(self) -> dict:
        if self._work is None:
            t = self.traffic
            self._work = recurrence(self.flow, iters=t["iters"], inflation=t["inflation"],
                                    threshold=t["prune_threshold"], device=self.device)
        return self._work
