"""The sharded mode's host plans (``shard_plan``, ``shard_plan_2d``,
``shard_plan_tiled`` with global and rebased keys, chunks and merge
parts) equal to the JAX package's, field for field and array for array,
on the operands ``tests/test_sharded.py`` runs. No processes: planning
is numpy on the host.

The tiled plan's waste limit comes from the cost model, so every test
first sets the port's weights to the JAX package's."""

import dataclasses
import importlib

import numpy as np
import pytest

from outerspace_tpu.formats import COO, erdos_renyi, rmat
from outerspace_tpu.sched import autotune as jat
from outerspace_tpu.shard import tiled as jtl
from outerspace_tpu_torch.formats import COO as TCOO
from outerspace_tpu_torch.sched import autotune as tat
from outerspace_tpu_torch.sched import planner as tpl
from outerspace_tpu_torch.shard import tiled as ttl

import torch_cases  # tests/ is on sys.path under pytest

# the modules (each package's ``shard`` also exports the function ``spgemm_sharded``)
jss = importlib.import_module("outerspace_tpu.shard.spgemm_sharded")
tss = importlib.import_module("outerspace_tpu_torch.shard.spgemm_sharded")


@pytest.fixture(autouse=True)
def jax_weights(monkeypatch):
    torch_cases.set_jax_cost_weights(monkeypatch, jat, tat, tpl.TILE_A_CLASSES)


def port(coo):
    """The same operand as the port's COO."""
    return TCOO(coo.shape, np.asarray(coo.row), np.asarray(coo.col), np.asarray(coo.val))


def assert_same(got, want, path="plan"):
    """Equal values: dataclasses field by field, dicts key by key,
    sequences item by item, arrays in shape, dtype and every element."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif want is None:
        assert got is None, path
    else:
        assert type(got) is type(want) and got == want, path


def skewed(seed):
    rng = np.random.default_rng(seed)
    return COO((64, 64), np.zeros(32, np.int64), np.arange(32),
               rng.random(32).astype(np.float32) + 0.5)


def corner_2_32():
    m = 1 << 16
    return COO((m, m), np.array([0, 0, 1, m - 1, m - 1, 7]), np.array([1, m - 1, 0, m - 1, 0, 7]),
               np.arange(1, 7, dtype=np.float32))


def rect_2_33():
    m, n, k = 1 << 20, 1 << 13, 64
    rng = np.random.default_rng(11)
    a = COO((m, k), rng.integers(0, m, 300), rng.integers(0, k, 300),
            rng.random(300).astype(np.float32) + 0.1).deduplicated()
    b = COO((k, n), rng.integers(0, k, 200), rng.integers(0, n, 200),
            rng.random(200).astype(np.float32) + 0.1).deduplicated()
    return a, b


def rmat71():
    return rmat(7, edge_factor=8, seed=71)


# (a, b) pairs of tests/test_sharded.py and the multi-device dryrun
FLAT_1D = {
    "er256": lambda: (erdos_renyi(256, 256, 0.02, seed=31),) * 2,
    "rmat7": lambda: (rmat(7, edge_factor=8, seed=32),) * 2,
    "rect": lambda: (erdos_renyi(100, 300, 0.05, seed=33), erdos_renyi(300, 300, 0.03, seed=99)),
    "empty_slices": lambda: (COO((64, 64), [0, 1], [0, 1], [1.0, 2.0]),) * 2,
    "skewed": lambda: (skewed(0), erdos_renyi(64, 64, 0.1, seed=44)),
    "dryrun_er128": lambda: (erdos_renyi(128, 128, 0.05, seed=7),) * 2,
}


@pytest.mark.parametrize("case", list(FLAT_1D))
def test_shard_plan_equals_jax(case):
    a, b = FLAT_1D[case]()
    want = jss.shard_plan(a.to_csc(), b.to_csr(), 8)
    got = tss.shard_plan(port(a).to_csc(), port(b).to_csr(), 8)
    assert_same(got, want)


FLAT_2D = {
    "er200_4x2": (lambda: (erdos_renyi(200, 200, 0.02, seed=61),) * 2, 4, 2),
    "rmat8_4x2": (lambda: (rmat(8, edge_factor=4, seed=62),) * 2, 4, 2),
    "rect_4x2": (lambda: (erdos_renyi(150, 260, 0.03, seed=63),
                          erdos_renyi(260, 180, 0.03, seed=64)), 4, 2),
    "rmat8_2x4": (lambda: (rmat(8, edge_factor=5, seed=65),) * 2, 2, 4),
    "dryrun_er128_4x2": (lambda: (erdos_renyi(128, 128, 0.05, seed=7),) * 2, 4, 2),
}


@pytest.mark.parametrize("case", list(FLAT_2D))
def test_shard_plan_2d_equals_jax(case):
    make, kx, ny = FLAT_2D[case]
    a, b = make()
    want = jss.shard_plan_2d(a.to_csc(), b.to_csr(), kx, ny)
    got = tss.shard_plan_2d(port(a).to_csc(), port(b).to_csr(), kx, ny)
    assert_same(got, want)
    # B is sharded over both axes, not replicated
    assert int(got.b_indptr[:, :, -1].sum()) == b.nnz


TILED = {
    "rmat8_4x2": (lambda: (rmat(8, edge_factor=5, seed=75),) * 2, dict(kx=4, ny=2)),
    "rmat7_chunks2": (lambda: (rmat71(),) * 2, dict(kx=8, exchange_chunks=2)),
    "rmat7_parts2": (lambda: (rmat71(),) * 2, dict(kx=8, merge_parts=2)),
    "rmat7_kx1_auto": (lambda: (rmat71(),) * 2, dict(kx=1)),
    "rmat7_kx2_auto": (lambda: (rmat71(),) * 2, dict(kx=2)),
    "er256_kx8": (lambda: (erdos_renyi(256, 256, 0.02, seed=72),) * 2, dict(kx=8)),
    "dryrun_rmat7": (lambda: (rmat(7, edge_factor=8, seed=9).deduplicated(),) * 2, dict(kx=8)),
    "dryrun_rmat7_4x2_chunks2": (lambda: (rmat(7, edge_factor=8, seed=9).deduplicated(),) * 2,
                                 dict(kx=4, ny=2, exchange_chunks=2)),
    "empty_slices": (lambda: (COO((64, 64), [0, 1], [0, 1], [1.0, 2.0]),) * 2, dict(kx=8)),
    # rebased keys
    "rebased_forced": (lambda: (rmat71().deduplicated(),) * 2, dict(kx=8, rebase=True)),
    "rebased_kx1_chunks2": (lambda: (rmat71().deduplicated(),) * 2,
                            dict(kx=1, exchange_chunks=2, rebase=True)),
    "rebased_4x2_chunks2": (lambda: (rmat71().deduplicated(),) * 2,
                            dict(kx=4, ny=2, exchange_chunks=2, rebase=True)),
    "rebased_parts3": (lambda: (rmat71().deduplicated(),) * 2,
                       dict(kx=8, merge_parts=3, rebase=True)),
    "rebased_auto_2_32": (lambda: (corner_2_32(),) * 2, dict(kx=2)),
    "rebased_auto_er80000": (lambda: (erdos_renyi(80000, 80000, 2e-6, seed=5),) * 2, dict(kx=4)),
    "rebased_rect_2_33": (rect_2_33, dict(kx=4)),
}


@pytest.mark.parametrize("case", list(TILED))
def test_shard_plan_tiled_equals_jax(case):
    make, kw = TILED[case]
    a, b = make()
    want = jtl.shard_plan_tiled(a.to_csc(), b.to_csr(), **kw)
    got = ttl.shard_plan_tiled(port(a).to_csc(), port(b).to_csr(), **kw)
    assert_same(got, want)
    assert got.stream_len == want.stream_len and got.merge_len == want.merge_len
    assert got.rebase == (kw.get("rebase") or a.shape[0] * b.shape[1] >= 2**32)


def test_kx1_auto_merge_parts_is_one():
    g = port(rmat71())
    assert ttl.shard_plan_tiled(g.to_csc(), g.to_csr(), kx=1).merge_parts == 1


def test_rebase_false_past_2_32_raises():
    # the JAX package wraps the keys silently there; the port refuses
    g = port(corner_2_32())
    with pytest.raises(ValueError, match="m\\*n < 2\\^32"):
        ttl.shard_plan_tiled(g.to_csc(), g.to_csr(), kx=2, rebase=False)


def test_owner_chunk_starts_equal_jax_and_span_capped():
    rng = np.random.default_rng(3)
    prod = rng.integers(0, 100, size=1000).astype(np.float64)
    prod[990:] = 1e6
    got = ttl._owner_chunk_starts(prod, 0, 1000, 4, span_cap=300)
    np.testing.assert_array_equal(got, jtl._owner_chunk_starts(prod, 0, 1000, 4, span_cap=300))
    assert got[0] == 0 and got[-1] == 1000 and np.diff(got).max() <= 300


def test_slices_equal_jax():
    g = rmat(8, edge_factor=4, seed=78)
    b, tb = g.to_csr(), port(g).to_csr()
    total = 0
    for k_lo, k_hi in ((0, 50), (50, 100), (100, 256)):
        for c_lo, c_hi in ((0, 90), (90, 256)):
            got = ttl.slice_b_rows_cols(tb, k_lo, k_hi, c_lo, c_hi)
            want = jtl.slice_b_rows_cols(b, k_lo, k_hi, c_lo, c_hi)
            for f in ("indptr", "indices", "data"):
                np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            total += got.nnz
        got = ttl.slice_a_columns(port(g).to_csc(), k_lo, k_hi)
        want = jtl.slice_a_columns(g.to_csc(), k_lo, k_hi)
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert total == b.nnz  # B partitioned, not replicated
    u = np.array([0, 1, 2**31, 2**32 - 1, 2**32 + 5], dtype=np.int64)
    np.testing.assert_array_equal(ttl._pack_u32_biased(u), jtl._pack_u32_biased(u))


@pytest.mark.parametrize("dead_key", [2**31 - 1, 0])
def test_slice_fill_buckets_equals_jax(dead_key):
    # the exchange buffers: each bucket's run left-aligned, then the
    # dead value; from a sorted stream with the key-space maximum as the
    # dead value, every slot is itself sorted
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(5)
    key = np.sort(rng.integers(0, 10_000, 1000)).astype(np.int32)
    val = rng.random(1000, dtype=np.float32)
    starts = np.array([0, 250, 400, 900], np.int32)
    ends = np.array([250, 400, 650, 1000], np.int32)
    want = jss._slice_fill_buckets(
        jnp.asarray(starts), jnp.asarray(ends), 300, 4,
        (jnp.asarray(key), np.int32(dead_key)), (jnp.asarray(val), np.float32(0.0)))
    got = tss._slice_fill_buckets(
        torch.from_numpy(starts), torch.from_numpy(ends), 300, 4,
        (torch.from_numpy(key), dead_key), (torch.from_numpy(val), 0.0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if dead_key == 2**31 - 1:
        assert (np.diff(got[0].numpy().astype(np.int64), axis=1) >= 0).all()
