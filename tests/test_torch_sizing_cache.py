"""The port's sizing cache (``outerspace_tpu_torch/sched/sizing_cache.py``):
the JAX package's keys and values, torn entries dropped, atomic writes,
and a default file under ``build/``, never ``data/sizing_cache.json``."""

import hashlib
import json
import os

import numpy as np
import pytest

from outerspace_tpu.sched import sizing_cache as jsc
from outerspace_tpu_torch.sched import sizing_cache as tsc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"p_pad": 4096, "nnz_pad": 1024, "elem_pad": 4096, "p_pads": [8192, 4096, 4096]}


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "c.json"
    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(path))
    return path


def test_workload_key_equals_jax():
    arrays = (np.arange(5, dtype=np.int32), np.array([[1.5, 2.0]], np.float32))
    for params in (("t", 1), ("mcl-torch", 256, 2.0, 4, 1e-4)):
        assert tsc.workload_key(arrays, params) == jsc.workload_key(arrays, params)
    assert tsc.workload_key(arrays, ("a",)) != tsc.workload_key(arrays, ("b",))


def test_store_lookup_round_trip(cache):
    key = tsc.workload_key((np.arange(5),), ("t", 1))
    tsc.store(key, SIZES)
    assert tsc.lookup(key) == SIZES
    assert tsc.lookup("absent") is None
    tsc.store(key, dict(SIZES, p_pads=None))
    assert tsc.lookup(key)["p_pads"] is None
    # the JAX package reads the same file format
    assert jsc.lookup(key) == tsc.lookup(key)
    # atomic: one file, no temporary left behind
    assert os.listdir(cache.parent) == [cache.name]


def test_torn_entries_are_dropped(cache):
    key = "k"
    with pytest.raises(ValueError):
        tsc.store(key, {"p_pad": "huge"})
    tsc.store(key, SIZES)
    d = json.loads(cache.read_text())
    d[key].update(p_pad="corrupt", nnz_pad=None, elem_pad=True, p_pads=[1, "x"])
    d["other"] = [1, 2]
    cache.write_text(json.dumps(d))
    assert tsc.lookup(key) == {}
    assert tsc.lookup("other") is None
    cache.write_text('{"k": {"p_pad": 40')  # torn write
    assert tsc.lookup(key) is None
    tsc.store(key, SIZES)  # rewrites the unreadable file
    assert tsc.lookup(key) == SIZES


def test_default_path_is_build_not_data(monkeypatch):
    monkeypatch.delenv("OUTERSPACE_SIZING_CACHE", raising=False)
    assert tsc.cache_path() == os.path.join(REPO, "build", "sizing_cache.json")


def test_unwritable_cache_costs_nothing(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(blocker / "sub" / "c.json"))
    tsc.store("k", SIZES)  # best effort: no error
    assert tsc.lookup("k") is None


def test_port_mcl_never_writes_the_committed_cache(cache):
    """A cold staged MCL stores its budgets in the configured file; the
    JAX package's committed ``data/sizing_cache.json`` stays as it is."""
    from outerspace_tpu_torch.formats import rmat
    from outerspace_tpu_torch.ops import graph

    committed = os.path.join(REPO, "data", "sizing_cache.json")
    before = hashlib.sha256(open(committed, "rb").read()).hexdigest()
    graph.markov_cluster(rmat(6, edge_factor=8, seed=3), iters=2, device="cpu")
    assert len(json.loads(cache.read_text())) == 1
    assert hashlib.sha256(open(committed, "rb").read()).hexdigest() == before
