"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose
configurations are cut to test size, run with the kernels' plain
versions (``device="cpu"``).

The copy's ``BENCHMARK.json`` also holds the A² cell of ``a2_cell.json``
(``rmat14_ef16.a2``, its ``a2_ms`` and its per-layer metrics): its
configuration, mix, limits, driver and readers are in ``benchmark/``,
but its runs on the card spread too widely for any bound the contract
allows, so the benchmark itself leaves it out."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
A2_CELL = Path(__file__).resolve().parent / "a2_cell.json"
TINY = {
    "rmat14_ef16": {"scale": 8},
    "rmat15_ef16": {"scale": 8},
}


def copy_benchmark(dst: Path) -> Path:
    """``BENCHMARK.json`` and ``benchmark/`` copied under ``dst``, each
    configuration cut to test size."""
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for key, entries in json.loads(A2_CELL.read_text()).items():
        manifest[key].extend(entries)
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest))
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cut in TINY.items():
        path = dst / "benchmark" / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        config.update(cut)
        path.write_text(json.dumps(config))
    return dst


@pytest.fixture
def tiny_repo(tmp_path):
    return copy_benchmark(tmp_path)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
