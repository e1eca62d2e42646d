"""Readings that set a cell's correctness limits, outside the benchmark's
own runs.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 --side program|control [--calls N]

For each seed it builds the cell's inputs as a run does and compares
``--calls`` answers (default: as many as a run samples) with the plain
reference, printing one JSON line of compared numbers per seed:

- ``program``: the program's answers (set-up and calls as in a run, no
  window): the lower readings;
- ``control``: the reference itself put in the program's place,
  computed with every value stored in bfloat16 (the precision below the
  configurations' float32): the upper readings. The control has to fail.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from benchmark.manifest import Manifest
from benchmark.reference import mcl as ref_mcl
from benchmark.reference.spgemm import csr_matmul
from benchmark.run import REPO, pin_caches, warm
from benchmark.sample import Sample


def _host(csr):
    (shape, indptr, indices, data) = csr
    return shape, np.asarray(indptr.cpu()), np.asarray(indices.cpu()), np.asarray(data.cpu())


def control_program(entry_name: str, traffic: dict, entry, device):
    """The reference in the program's place, values stored in bfloat16."""
    if entry_name == "a2":
        return lambda op: _host(csr_matmul(op, op, precision="bfloat16", device=device))
    if entry_name == "mcl":
        return lambda _op: _host(ref_mcl.mcl(
            entry.flow, iters=traffic["iters"], inflation=traffic["inflation"],
            threshold=traffic["prune_threshold"], precision="bfloat16", device=device)[0])
    raise ValueError(f"no control for entry {entry_name!r}")


def readings(manifest: Manifest, cell_name: str, seed: int, side: str, calls: int | None, device) -> dict:
    cell = manifest.cell(cell_name)
    traffic = manifest.traffic(cell["traffic"])
    Entry = manifest.entry(traffic["entry"])
    check = manifest.cell_file(cell_name).get("check", {})
    config = manifest.config(cell["config"])
    t0 = time.perf_counter()
    if side == "program":
        entry = Entry(config, traffic, seed, device, **check)
        warm(entry, traffic["warm_calls"], device)
    else:
        entry = Entry(config, traffic, seed, device, program=lambda op: None, **check)
        entry.program = control_program(traffic["entry"], traffic, entry, device)
    calls = calls or traffic["check_calls"]
    entry.sample = Sample(calls, seed, calls)
    for i in range(calls):
        entry.observe(i, entry.call(entry.operand(i)))
    entry.release()
    numbers = entry.check()
    return {"cell": cell_name, "seed": seed, "side": side, **numbers, **entry.info(),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--side", choices=("program", "control"), required=True)
    p.add_argument("--calls", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    pin_caches(REPO)
    manifest = Manifest(REPO)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(manifest, args.workload, seed, args.side, args.calls, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
