"""The manifest (``BENCHMARK.json``) holds to the benchmark's contract, and
every cell, configuration, traffic mix, entry and metric it names is
found by name; a new cell and a new per-layer metric are added by
adding files alone."""

from __future__ import annotations

import hashlib
import json
import re

import pytest

from benchmark.manifest import Manifest
from benchmark.run import run_cell
from benchmark.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return Manifest(REPO)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_and_names(manifest):
    d = manifest.data
    assert set(d) == TOP_KEYS
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(d["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in d["paths"])
    assert 1 <= len(d["command"]) <= 32 and all(_line(w) and not w.startswith("/") for w in d["command"])
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in d[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in d[k]}) == len(d[k])
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and all(NAME.match(k) for k in c["reduced"])
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in d["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in d["end_to_end"])
    layers = {}
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_piece_is_found_by_name(manifest):
    configs = {c["name"] for c in manifest.data["configs"]}
    used = {w["config"] for w in manifest.data["workloads"]}
    assert configs == used
    for w in manifest.data["workloads"]:
        config = manifest.config(w["config"])
        assert config["name"] == w["config"]
        traffic = manifest.traffic(w["traffic"])
        assert callable(manifest.entry(traffic["entry"]))
        limits = manifest.cell_file(w["name"])["limits"]
        assert limits and all(v >= 0 for v in limits.values())
        e2e = {m["name"] for m in manifest.end_to_end(w["name"])}
        assert "setup_s" in e2e and set(traffic["end_to_end"]) == e2e - {"setup_s"}
        layer = manifest.per_layer(w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)
    for m in manifest.data["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def _digest(root):
    h = hashlib.sha256()
    for p in sorted((root / "benchmark").rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    h.update((root / "BENCHMARK.json").read_bytes())
    return h.hexdigest()


NEW_METRIC = '''"""Calls traced."""


def read(rec):
    return float(len(rec.calls))
'''


def test_cell_and_metric_added_as_files(tiny_repo):
    before = _digest(REPO)
    bench = tiny_repo / "benchmark"
    # a configuration, a traffic mix, a cell and a per-layer metric: new
    # files, and entries appended to the copy's manifest
    config = json.loads((bench / "configs" / "rmat15_ef16.json").read_text())
    config.update(name="rmat6_ef4", scale=6, edge_factor=4)
    (bench / "configs" / "rmat6_ef4.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "a2.json").read_text())
    traffic.update(strategy="flat", trace_calls=2)
    (bench / "traffic" / "a2_flat.json").write_text(json.dumps(traffic))
    limits = json.loads((bench / "workloads" / "rmat14_ef16.a2.json").read_text())
    (bench / "workloads" / "rmat6_ef4.a2_flat.json").write_text(json.dumps(limits))
    (bench / "metrics" / "a2.traced_calls.py").write_text(NEW_METRIC)
    d = json.loads((tiny_repo / "BENCHMARK.json").read_text())
    d["configs"].append({"name": "rmat6_ef4", "source": "test", "file": "benchmark/configs/rmat6_ef4.json",
                         "reduced": ["scale", "edge_factor"], "why": "test"})
    d["workloads"].append({"name": "rmat6_ef4.a2_flat", "config": "rmat6_ef4", "traffic": "a2_flat",
                           "chips": 1, "why": "test"})
    for m in d["end_to_end"]:
        if m["name"] == "a2_ms":
            m["workloads"].append("rmat6_ef4.a2_flat")
    d["per_layer"].append({"name": "a2.traced_calls", "unit": "calls", "better": "higher",
                           "source": "device_trace", "layer": "harness", "moves": "a2_ms",
                           "workloads": ["rmat6_ef4.a2_flat"]})
    (tiny_repo / "BENCHMARK.json").write_text(json.dumps(d))
    m = Manifest(tiny_repo)
    plain = run_cell(m, "rmat6_ef4.a2_flat", 5, 0.3, False, "cpu")
    assert plain["correct"] and set(plain["metrics"]) == {"a2_ms", "setup_s"}
    traced = run_cell(m, "rmat6_ef4.a2_flat", 5, 0.3, True, "cpu")
    assert traced["correct"] and traced["metrics"]["a2.traced_calls"]["value"] == 2.0
    assert _digest(REPO) == before
