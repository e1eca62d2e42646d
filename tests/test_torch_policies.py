"""The port's residency and merge-scheduling studies
(``sched/policies.py``) against the JAX package's, function for function,
on seeded block streams and on the task tables each package plans from
the same operands (the JAX cost weights set in the port first)."""

import numpy as np
import pytest

from outerspace_tpu.sched import autotune as jat
from outerspace_tpu.sched import policies as jpo
from outerspace_tpu_torch.sched import planner as tpl
from outerspace_tpu_torch.sched import autotune as tat
from outerspace_tpu_torch.sched import policies as tpo

import torch_cases  # tests/ is on sys.path under pytest
from conftest import random_matrices
from torch_shard_cases import port


@pytest.fixture(autouse=True)
def jax_weights(monkeypatch):
    torch_cases.set_jax_cost_weights(monkeypatch, jat, tat, tpl.TILE_A_CLASSES)


def streams():
    rng = np.random.default_rng(7)
    return {
        "empty": np.zeros(0, np.int64),
        "uniform": rng.integers(0, 40, 600),
        "skewed": (rng.zipf(1.6, 800) % 97).astype(np.int64),
        "b_major": np.repeat(np.arange(50), rng.integers(1, 9, 50)),
        "sweep": np.tile(np.arange(24), 12),
    }


@pytest.mark.parametrize("name", list(streams()))
@pytest.mark.parametrize("cap", [1, 4, 16])
def test_policies_equal_jax(name, cap):
    acc = streams()[name]
    assert tpo.simulate_lru(acc, cap) == jpo.simulate_lru(acc, cap)
    assert tpo.simulate_belady(acc, cap) == jpo.simulate_belady(acc, cap)
    for la in (0, 3, 64):
        assert tpo.simulate_slot_min(acc, cap, la) == jpo.simulate_slot_min(acc, cap, la)
    assert tpo.residency_study(acc, [cap, 2 * cap]) == jpo.residency_study(acc, [cap, 2 * cap])
    assert (tpo.policy_study(acc, [cap], lookaheads=(4, 32))
            == jpo.policy_study(acc, [cap], lookaheads=(4, 32)))


@pytest.mark.parametrize("case", random_matrices(), ids=lambda c: c[0])
@pytest.mark.parametrize("tile_a", [8, 32])
def test_task_b_stream_equal_jax(case, tile_a):
    _, a, b = case
    for order in ("b_major", "a_major"):
        for wl in (8.0, 2.0):
            want = jpo.task_b_stream(a.to_csc(), b.to_csr(), tile_a=tile_a, order=order,
                                     waste_limit=wl)
            got = tpo.task_b_stream(port(a).to_csc(), port(b).to_csr(), tile_a=tile_a,
                                    order=order, waste_limit=wl)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
            # the studies agree on the planned stream too
            assert (tpo.residency_study(got, [2, 8])
                    == jpo.residency_study(np.asarray(want), [2, 8]))


@pytest.mark.parametrize("runs", [[], [5], [3, 1, 4, 1, 5, 9, 2, 6], list(range(1, 40)),
                                  [1000, 1, 1, 1, 1, 1, 1, 1, 1]])
def test_merge_schedule_and_fanin_equal_jax(runs):
    for ways in (2, 3, 4, 8, 64):
        assert tpo.merge_schedule(runs, ways) == jpo.merge_schedule(runs, ways)
    if runs:
        assert tpo.optimal_fanin(runs) == jpo.optimal_fanin(runs)
        assert tpo.optimal_fanin(runs, (2, 3)) == jpo.optimal_fanin(runs, (2, 3))
