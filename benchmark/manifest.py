"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own under ``benchmark/``, so a
cell, a mix or a metric is added by adding files:

- ``configs/<config>.json``: the configuration (``file`` in the manifest);
- ``traffic/<mix>.json``: a traffic mix's parameters, among them the
  ``entry`` that drives the program and how each end-to-end metric is
  taken from the window;
- ``entries/<entry>.py``: the driver of one of the program's entry
  points (an ``Entry`` class);
- ``workloads/<cell>.json``: the cell's correctness limits and the
  parameters of its check;
- ``metrics/<metric>.py``: a per-layer metric's reader (``read(rec)``).
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

_SAFE = re.compile(r"[^0-9A-Za-z_]")


def _load_module(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(f"{prefix}_{_SAFE.sub('_', path.stem)}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """The benchmark of the checkout at ``repo``: its ``BENCHMARK.json``
    and the directory ``bench`` (default ``repo/benchmark``) that holds
    the files named above."""

    def __init__(self, repo: Path, bench: Path | None = None):
        self.repo = Path(repo)
        self.bench = Path(bench) if bench is not None else self.repo / "benchmark"
        self.data = _read_json(self.repo / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _read_json(self.repo / c["file"])
        raise KeyError(f"no config named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _read_json(self.bench / "traffic" / f"{name}.json")

    def cell_file(self, cell: str) -> dict:
        """The cell's ``limits`` (and any ``check`` parameters)."""
        return _read_json(self.bench / "workloads" / f"{cell}.json")

    def entry(self, name: str):
        return _load_module(self.bench / "entries" / f"{name}.py", "benchmark_entry").Entry

    def reader(self, metric: str):
        return _load_module(self.bench / "metrics" / f"{metric}.py", "benchmark_metric").read

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics ``cell`` reports: those that list it."""
        return [m for m in self.data["per_layer"] if cell in m["workloads"]]
