"""What the benchmark runs loads neither JAX nor the JAX package, and the
plain reference loads nothing of the program. Module names are compared
by their top-level name, whole: the port's name begins with the JAX
package's."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.tests.conftest import REPO

RUN_A_CELL = """
import json, sys, time
from pathlib import Path
from benchmark.manifest import Manifest
from benchmark import run, control
m = Manifest(Path(sys.argv[1]))
for w in m.data["workloads"]:
    run.run_cell(m, w["name"], 5, 0.2, True, "cpu", t_process=time.perf_counter())
for p in m.data["per_layer"]:
    m.reader(p["name"])
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""

LOAD_THE_REFERENCE = """
import json, sys
import benchmark.reference.compare, benchmark.reference.generators
import benchmark.reference.mcl, benchmark.reference.spgemm
import benchmark.work.a2, benchmark.work.peaks, benchmark.trace, benchmark.sample
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""


def _top_level(code, *args):
    p = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax(tiny_repo):
    names = _top_level(RUN_A_CELL, str(tiny_repo))
    assert "outerspace_tpu_torch" in names and "benchmark" in names
    assert not names & {"jax", "jaxlib", "flax", "outerspace_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _top_level(LOAD_THE_REFERENCE)
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "outerspace_tpu", "outerspace_tpu_torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "outerspace_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxfake.sub", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert forbidden_modules() == ["jaxlib"]
