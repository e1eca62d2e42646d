"""``correct`` comes out false when the timed path is broken underneath a
run (the harness's look for a card skipped: the cells run on the CPU,
at test size, with the kernels' plain versions), and the control —
the reference put in the program's place with its values stored in
bfloat16 — fails the cells' limits. The cells run on one card, so no
fault of an exchange between cards applies."""

from __future__ import annotations

import importlib
import subprocess
import sys

import numpy as np
import pytest

from benchmark import control
from benchmark.manifest import Manifest
from benchmark.run import run_cell
from benchmark.tests.conftest import REPO

A2_CELLS = ("rmat14_ef16.a2",)
MCL_CELL = "rmat15_ef16.mcl4"


def _csr(shape, indptr, indices, data):
    from outerspace_tpu_torch.formats.csr import CSR

    return CSR(shape, indptr, indices, data)


def drop_half_rows(c):
    """The rows of the second half left out."""
    cut = int(c.indptr[c.shape[0] // 2])
    indptr = np.minimum(c.indptr, cut)
    return _csr(c.shape, indptr, c.indices[:cut], c.data[:cut])


def alter_one(c):
    """One answer altered by a twentieth where it is produced."""
    data = c.data.copy()
    data[len(data) // 2] *= np.float32(1.05)
    return _csr(c.shape, c.indptr, c.indices, data)


def stale(fn):
    """A call that returns the state the previous call left."""
    last = {}

    def run(*args, **kwargs):
        out = last.get("out") or fn(*args, **kwargs)
        last["out"] = out
        return out

    return run


def raises_after_warm_up(fn, warm_calls):
    """Calls that raise once set-up is over."""
    calls = []

    def run(*args, **kwargs):
        calls.append(1)
        if len(calls) > warm_calls:
            raise RuntimeError("broken")
        return fn(*args, **kwargs)

    return run


def _run(repo, cell, seed=2**31 + 17):
    return run_cell(Manifest(repo), cell, seed, 1.0, False, "cpu")


@pytest.mark.parametrize("cell", A2_CELLS)
def test_a2_sound_run_is_correct(tiny_repo, cell):
    r = _run(tiny_repo, cell)
    assert r["correct"] and r["attempted"] > 3 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "raises"])
@pytest.mark.parametrize("cell", A2_CELLS)
def test_a2_fault_is_caught(tiny_repo, cell, fault, monkeypatch):
    mod = importlib.import_module("outerspace_tpu_torch.ops.spgemm")
    real = mod.spgemm
    broken = {
        "stale": stale(real),
        "half": lambda a, b, **kw: drop_half_rows(real(a, b, **kw)),
        "altered": lambda a, b, **kw: alter_one(real(a, b, **kw)),
        "raises": raises_after_warm_up(real, Manifest(tiny_repo).traffic("a2")["warm_calls"]),
    }[fault]
    monkeypatch.setattr(mod, "spgemm", broken)
    r = _run(tiny_repo, cell)
    assert not r["correct"]
    assert (r["failed"] == r["attempted"]) == (fault == "raises")


def test_mcl_sound_run_is_correct(tiny_repo):
    r = _run(tiny_repo, MCL_CELL)
    assert r["correct"] and r["attempted"] > 3 and r["info"]["uncertain_share"] < 0.1


class _Fixed:
    def __init__(self, c):
        self.c = c

    def to_csr(self):
        return self.c


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_mcl_fault_is_caught(tiny_repo, fault, monkeypatch):
    chain = importlib.import_module("outerspace_tpu_torch.ops.chain")
    graph = importlib.import_module("outerspace_tpu_torch.ops.graph")
    real = graph.mcl_run
    if fault == "unchanged":
        # every loop iteration returns its state unchanged
        monkeypatch.setattr(chain, "_mcl_iteration", lambda state, **kw: state)
    else:
        edit = drop_half_rows if fault == "half" else alter_one
        monkeypatch.setattr(graph, "mcl_run", lambda prep: _Fixed(edit(real(prep).to_csr())))
    r = _run(tiny_repo, MCL_CELL)
    assert not r["correct"]
    # the check judged most columns (none lay within rounding of a prune)
    assert r["info"]["uncertain_share"] < 0.1


@pytest.mark.parametrize("cell", A2_CELLS + (MCL_CELL,))
def test_control_fails_and_program_passes(tiny_repo, cell):
    m = Manifest(tiny_repo)
    limits = m.cell_file(cell)["limits"]
    for seed in (3, 2**31 + 3):
        prog = control.readings(m, cell, seed, "program", None, "cpu")
        assert all(prog[k] <= v for k, v in limits.items()), prog
        ctl = control.readings(m, cell, seed, "control", None, "cpu")
        assert any(ctl[k] > v for k, v in limits.items()), ctl


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", MCL_CELL, "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 2 and p.stdout == ""


@pytest.mark.cuda
def test_cells_on_the_card(tiny_repo, cuda):
    m = Manifest(tiny_repo)
    for cell in A2_CELLS + (MCL_CELL,):
        for trace in (False, True):
            r = run_cell(m, cell, 2**31 + 99, 0.5, trace, "cuda")
            assert r["correct"], r["checks"]
            if trace:
                assert r["device"]["busy_s"] > 0 and r["metrics"]
