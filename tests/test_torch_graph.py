"""Triangle counting: ``triangle_count`` by every route of the port
(dense, sparse, auto on the CPU; the host reference) equal to the JAX
package's and to scipy's, the pieces it is built from equal to the JAX
package's, and the selector equal to the JAX package's under its
weights."""

import functools

import numpy as np
import pytest
import torch

from outerspace_tpu.formats import COO, erdos_renyi, rmat
from outerspace_tpu.ops import graph as jg
from outerspace_tpu_torch.formats import COO as TCOO
from outerspace_tpu_torch.ops import graph as tg

import torch_cases  # tests/ is on sys.path under pytest


def tcoo(c):
    return TCOO(c.shape, c.row, c.col, c.val)


def ring(n):
    r = np.arange(n)
    return COO((n, n), r, (r + 1) % n, np.ones(n, np.float32))


def star(n):
    """No triangles: a star and a path beside it."""
    rows = np.concatenate([np.zeros(n // 2, np.int64), np.arange(n // 2, n - 1)])
    cols = np.concatenate([np.arange(1, n // 2 + 1), np.arange(n // 2 + 1, n)])
    return COO((n, n), rows, cols, np.ones(rows.shape[0], np.float32))


GRAPHS = {
    "rmat9": lambda: rmat(9, edge_factor=8, seed=4),
    "er_directed": lambda: erdos_renyi(400, 400, 0.03, seed=5),
    "hub_pair": functools.partial(torch_cases.hub_pair_graph, COO),
    "ring": lambda: ring(600),
    "no_triangles": lambda: star(300),
    "self_loops_only": lambda: COO((40, 40), np.arange(40), np.arange(40), np.ones(40, np.float32)),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_triangle_count_equals_jax_and_scipy(name):
    g = GRAPHS[name]()
    want = jg.triangle_count(g, backend="scipy")
    assert tg.triangle_count(tcoo(g), backend="scipy") == want
    for route in ("dense", "sparse"):
        assert jg.triangle_count(g, strategy=route) == want, route
    for route in ("dense", "sparse", "auto"):
        assert tg.triangle_count(tcoo(g), strategy=route, device="cpu") == want, route
    if name == "no_triangles":
        assert want == 0
    if name == "hub_pair":
        assert want >= 600


def test_sparse_route_past_2e31_goes_through_spgemm(monkeypatch):
    # m·n ≥ 2³¹: the packed-key route is refused and A² runs as spgemm
    n = 50_000
    g = erdos_renyi(n, n, 3e-5, seed=7)
    rng = np.random.default_rng(1)
    tri = rng.choice(n, size=(40, 3), replace=False)
    rows = np.concatenate([g.row, tri[:, 0], tri[:, 1], tri[:, 2]])
    cols = np.concatenate([g.col, tri[:, 1], tri[:, 2], tri[:, 0]])
    g = COO((n, n), rows, cols, np.ones(rows.shape[0], np.float32))
    calls = []
    real = tg.triangle_prepare
    monkeypatch.setattr(tg, "triangle_prepare", lambda *a, **k: calls.append(1) or real(*a, **k))
    want = jg.triangle_count(g, backend="scipy")
    assert want >= 40
    assert tg.triangle_count(tcoo(g), strategy="sparse", device="cpu") == want
    assert tg.triangle_count(tcoo(g), device="cpu") == want  # auto: sparse (n > 32768)
    assert calls == []
    with pytest.raises(ValueError, match="2\\^31"):
        tg.triangle_prepare(tg._symmetrize_simple(tcoo(g)), device="cpu")


def test_forced_unsafe_dense_route_raises():
    g = COO((40_000, 40_000), [0, 1, 2], [1, 2, 0], np.ones(3, np.float32))
    sym_j = jg._symmetrize_simple(g)
    assert not jg._dense_triangle_safe(sym_j)
    assert not tg._dense_triangle_safe(tg._symmetrize_simple(tcoo(g)))
    with pytest.raises(ValueError, match="unsafe"):
        tg.triangle_count(tcoo(g), strategy="dense", device="cpu")
    assert tg.triangle_count(tcoo(g), device="cpu") == 1  # auto takes the sparse route
    with pytest.raises(ValueError):
        tg.triangle_count(tcoo(g), strategy="bogus", device="cpu")
    with pytest.raises(ValueError):
        tg.triangle_count(tcoo(g), backend="tpu", device="cpu")


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pieces_equal_jax(name):
    g = GRAPHS[name]()
    sj, st = jg._symmetrize_simple(g), tg._symmetrize_simple(tcoo(g))
    for f in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f))
    n_words = -(-g.shape[1] // 32)
    np.testing.assert_array_equal(
        tg._edge_bitmap(st.row, st.col, g.shape[0], n_words),
        jg._edge_bitmap(sj.row, sj.col, g.shape[0], n_words),
    )
    assert tg._dense_triangle_safe(st) == jg._dense_triangle_safe(sj)


def test_selector_equals_jax_under_its_weights(monkeypatch):
    # the JAX package's model: 2·n_pad³ operations at 100 TFLOP/s against
    # 2 ns per sparse product
    monkeypatch.setattr(tg, "DENSE_NS_PER_NPAD3", 2.0e-5)
    monkeypatch.setattr(tg, "SPARSE_NS_PER_PRODUCT", 2.0)
    picks = {}
    for name, make in {**GRAPHS, "ring_4096": lambda: ring(4096),
                       "rmat11": lambda: rmat(11, edge_factor=8, seed=4)}.items():
        g = make()
        picks[name] = tg._triangle_strategy(tg._symmetrize_simple(tcoo(g)))
        assert picks[name] == jg._triangle_strategy(jg._symmetrize_simple(g)), name
    assert set(picks.values()) == {"dense", "sparse"}


def test_dense_total_is_exact_past_bf16():
    # an edge whose ends share 600 neighbours: A² holds 600 there, which
    # a bf16 result would round; int8 products with int32 sums keep it
    g = torch_cases.hub_pair_graph(TCOO)
    sym = tg._symmetrize_simple(g)
    rows = torch.from_numpy(sym.row.astype(np.int64))
    cols = torch.from_numpy(sym.col.astype(np.int64))
    total = tg._tri_dense_total(rows, cols, tg._n_pad(sym), block=256)
    assert total.dtype == torch.int64
    d = torch.zeros((g.shape[0],) * 2, dtype=torch.float64)
    d[rows, cols] = 1
    assert int(total) == int(((d @ d) * d).sum())
    assert float((d @ d)[0, 1]) == 600
