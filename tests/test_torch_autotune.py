"""The strategy pick: with the JAX package's weights set, the port's
``autotune`` and ``choose_strategy`` equal the JAX package's picks and
waste limits, and ``spgemm(strategy="auto")`` runs the picked strategy.
The port's own weights (measured on the card) are held to their form."""

import dataclasses
import functools
import importlib
import inspect
import math

import numpy as np
import pytest

from outerspace_tpu.formats import COO, erdos_renyi, rmat
from outerspace_tpu.sched import autotune as jat
from outerspace_tpu.sched import planner as jpl
from outerspace_tpu_torch.config import DEFAULT, Config
from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays
from outerspace_tpu_torch.ops import assert_csr_allclose, spgemm_scipy
from outerspace_tpu_torch.sched import autotune as tat
from outerspace_tpu_torch.sched import planner as tpl

import torch_cases  # tests/ is on sys.path under pytest

jsp = importlib.import_module("outerspace_tpu.ops.spgemm")
tsp = importlib.import_module("outerspace_tpu_torch.ops.spgemm")
tgp = importlib.import_module("outerspace_tpu_torch.ops.gather_pipeline")


@pytest.fixture
def jax_weights(monkeypatch):
    torch_cases.set_jax_cost_weights(monkeypatch, jat, tat, tpl.TILE_A_CLASSES)


def port(a, b):
    a_csc, b_csr = a.to_csc(), b.to_csr()
    return (a_csc, b_csr), (
        csc_from_arrays(a_csc.shape, a_csc.indptr, a_csc.indices, a_csc.data),
        csr_from_arrays(b_csr.shape, b_csr.indptr, b_csr.indices, b_csr.data),
    )


def hub_and_tail(seed=0):
    """Twelve dense 256-wide B rows beside a sparse tail: the model puts
    tiles well ahead of gather."""
    rng = np.random.default_rng(seed)
    d = (rng.random((512, 64)) < 0.02).astype(np.float32)
    d[:, :12] = 1.0
    e = (rng.random((64, 512)) < 0.02).astype(np.float32)
    e[:12, :256] = 1.0
    return COO.from_dense(d), COO.from_dense(e)


CASES = {
    "rmat8_ef16": lambda: (rmat(8, edge_factor=16, seed=1),) * 2,
    "rmat10_ef8": lambda: (rmat(10, edge_factor=8, seed=1),) * 2,
    "er_300": lambda: (erdos_renyi(300, 300, 0.02, seed=2),) * 2,
    "dense_blocks": functools.partial(torch_cases.dense_blocks, COO),
    "big_shape": functools.partial(torch_cases.big_shape_pair, COO),
    "hub_and_tail": hub_and_tail,
    "empty": lambda: (COO((6, 5), [0, 3], [1, 2], [1.0, 2.0]), COO((5, 4), [0, 4], [1, 3], [1.0, 1.0])),
}


def picks(case):
    (ja, jb), (ta, tb) = port(*case)
    return jat.autotune(ja, jb), tat.autotune(ta, tb), (ja, jb), (ta, tb)


@pytest.mark.parametrize("name", sorted(CASES))
def test_autotune_equals_jax(name, jax_weights):
    want, got, (ja, jb), (ta, tb) = picks(CASES[name]())
    assert got == want
    assert tpl.choose_strategy(ta, tb) == jpl.choose_strategy(ja, jb) == want[0]
    assert tat.best_waste_limit(ta, tb) == want[1]


def test_autotune_equals_jax_zoo(operand_pair, jax_weights):
    want, got, _, _ = picks(operand_pair)
    assert got == want


def test_picks_across_the_cases(jax_weights):
    # the merge's weight dominates every per-element cost, so tiles never
    # beat gather by the near-tie margin on these operands
    got = {name: picks(c())[1][0] for name, c in CASES.items()}
    assert set(got.values()) == {"gather", "flat"} and got["empty"] == "flat"


def test_strategy_costs_under_jax_weights(jax_weights):
    (ja, jb), (ta, tb) = port(*CASES["rmat10_ef8"]())
    cost, wl, padded = tat.strategy_costs(ta, tb)
    na = ta.major_nnz().astype(np.int64)
    nb = tb.major_nnz().astype(np.int64)
    total = int((na * nb).sum())
    b_mis = np.asarray(tb.indptr)[:-1].astype(np.int64) % 128
    assert cost["tiles"] == jat.modeled_cost_ns(na, nb, wl, b_mis=b_mis)
    assert cost["gather"] == int(total * 1.04) * (jat.GATHER_NS + jat.SORT_NS)
    assert cost["flat"] == total * (jat.FLAT_NS + jat.SORT_NS)
    assert padded == sum(jat._class_totals(na, nb, wl, b_mis=b_mis)[0])
    assert tat.strategy_costs(*port(*CASES["empty"]())[1]) is None


@pytest.mark.parametrize("name", ["rmat10_ef8", "hub_and_tail", "big_shape", "empty"])
def test_auto_runs_the_pick(name, jax_weights, monkeypatch):
    ran = []

    def spy(label, fn):
        def wrapper(*a, **kw):
            ran.append(label)
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tsp, "plan_tiled_parts", spy("tiles", tsp.plan_tiled_parts))
    monkeypatch.setattr(tsp, "spgemm_padded", spy("flat", tsp.spgemm_padded))
    monkeypatch.setattr(tgp, "spgemm_gather", spy("gather", tgp.spgemm_gather))
    a, b = CASES[name]()
    (ja, jb), (ta, tb) = port(a, b)
    got = tsp.spgemm(ta, tb, device="cpu")
    if name == "empty":
        assert ran == [] and got.nnz == 0  # no products: no strategy runs
    else:
        assert ran == [jpl.choose_strategy(ja, jb)]
    assert_csr_allclose(got, spgemm_scipy(ta, tb), rtol=1e-5, atol=1e-6)


def test_config_and_signature():
    # the port's Config holds only what a module of the port reads, and
    # the pick takes the operands alone: the cost model decides
    assert [f.name for f in dataclasses.fields(Config)] == ["waste_limit"]
    assert DEFAULT.waste_limit is None and Config(waste_limit=1.3).waste_limit == 1.3
    assert list(inspect.signature(tpl.choose_strategy).parameters) == ["a_csc", "b_csr"]


def test_card_weights_are_the_ports_own():
    # the committed weights are times measured on the card, not the JAX
    # planner's, and the non-weight constants stay the JAX package's
    weights = [tat.SORT_NS, tat.GATHER_NS, tat.FLAT_NS, *tat.TILE_NS_BY_CLASS.values()]
    assert all(math.isfinite(w) and w > 0 for w in weights)
    assert tat.TILE_NS == tat.TILE_NS_BY_CLASS[8]
    assert set(tat.TILE_NS_BY_CLASS) == set(tpl.TILE_A_CLASSES)
    assert (tat.SORT_NS, tat.GATHER_NS, tat.FLAT_NS) != (jat.SORT_NS, jat.GATHER_NS, jat.FLAT_NS)
    assert (tat.GATHER_FILL, tat.TILES_MARGIN) == (1.04, 1.15)
    (_, _), (ta, tb) = port(*CASES["rmat10_ef8"]())
    assert tat.autotune(ta, tb)[0] in ("tiles", "gather", "flat")
