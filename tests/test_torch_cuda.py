"""The port's CUDA kernels on the card, against their plain versions and
scipy. Marked ``cuda``: each test skips without a CUDA device. This file
imports neither JAX nor the JAX package, so it runs on a machine without
them:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import functools
import importlib
import os

import numpy as np
import pytest
import torch

from outerspace_tpu_torch.convert import load_params, state_dict_from_params
from outerspace_tpu_torch.formats import COO, BlockELL, erdos_renyi, rmat
from outerspace_tpu_torch.ops import assert_csr_allclose, spgemm, spgemm_scipy
from outerspace_tpu_torch.ops.gather_pipeline import plan_spgemm_gather
from outerspace_tpu_torch.nn.data import synthetic_mnist
from outerspace_tpu_torch.nn.models import make_model
from outerspace_tpu_torch.nn.sparse_infer import SparseLeNet, SparseMLP
from outerspace_tpu_torch.ops.kernels import expand, gexpand, scan, spmm
from outerspace_tpu_torch.ops.spgemm import (
    plan_tiled,
    plan_tiled_parts,
    spgemm_padded_tiled,
    spgemm_padded_tiled_parts,
)

import torch_cases  # tests/ is on sys.path under pytest

big_shape_pair = functools.partial(torch_cases.big_shape_pair, COO)

spgemm_mod = importlib.import_module("outerspace_tpu_torch.ops.spgemm")
pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-5, 1e-6
I32_MAX = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_k1_kernel_bit_equal_to_plain(cuda):
    g = rmat(10, edge_factor=8, seed=1)
    plan = plan_spgemm_gather(g.to_csc(), g.to_csr(), device=cuda)
    for p in plan.parts:
        d = p.dev
        args = (d["bases"], d["table"], d["a_pack"], d["b_pack"], d["group_bits"])
        before = gexpand.KERNEL.launches
        k, v = gexpand.expand_gather(*args, b_win=p.b_win)
        kp, vp = gexpand.expand_gather_plain(*args, b_win=p.b_win)
        torch.cuda.synchronize()
        assert gexpand.KERNEL.launches == before + 1
        assert torch.equal(k, kp)
        assert torch.equal(v.view(torch.int32), vp.view(torch.int32))
        assert int((k != I32_MAX).sum()) == p.p_real


def k1_matches_plain(args, b_win):
    """K1 on the card, twice, against its plain version: bit for bit,
    one launch counted per call."""
    before = gexpand.KERNEL.launches
    k, v = gexpand.expand_gather(*args, b_win=b_win)
    k2, v2 = gexpand.expand_gather(*args, b_win=b_win)
    kp, vp = gexpand.expand_gather_plain(*args, b_win=b_win)
    torch.cuda.synchronize()
    assert gexpand.KERNEL.launches == before + 2
    assert torch.equal(k, kp), int((k != kp).sum())
    assert torch.equal(v.view(torch.int32), vp.view(torch.int32))
    assert torch.equal(k2, k) and torch.equal(v2.view(torch.int32), v.view(torch.int32))
    return k


K1_PLANS = {
    # the port's own copies of tests/test_torch_gexpand.py's cases:
    # (A, B or None for Aᵀ, forced key space of the row split)
    "wide_rows": lambda: (erdos_renyi(40, 64, 0.1, seed=7), erdos_renyi(64, 900, 0.2, seed=8), None),
    "multipart": lambda: (erdos_renyi(300, 260, 0.02, seed=44), None, 12_000),
    "keys_2e31": lambda: (erdos_renyi(50_000, 50_000, 4e-6, seed=45), None, None),
    # eight row parts of unequal size, commonised to one shape
    "commonised": lambda: (rmat(10, edge_factor=8, seed=1), None, 200_000),
}


def k1_plan(name, cuda, monkeypatch):
    from outerspace_tpu_torch.ops import gather_pipeline
    from outerspace_tpu_torch.sched import gplanner

    a, b, key_space = K1_PLANS[name]()
    b = a.T if b is None else b  # A·Aᵀ, or A² for a square A
    if key_space is not None:
        monkeypatch.setattr(gather_pipeline, "row_partition",
                            functools.partial(gplanner.row_partition, key_space=key_space))
    return plan_spgemm_gather(a.to_csc(), b.to_csr(), device=cuda)


@pytest.mark.parametrize("depth", [4, 6, 8])
@pytest.mark.parametrize("name,b_win", [("wide_rows", 3), ("multipart", 5)])
def test_k1_forced_depths_bit_equal_to_plain(cuda, monkeypatch, name, b_win, depth):
    # one depth on every group, also where it is shallower than a
    # subtile's owner span: the kernel must run the same search
    plan = k1_plan(name, cuda, monkeypatch)
    assert all(p.b_win == b_win for p in plan.parts)
    for p in plan.parts:
        d = p.dev
        bits = torch.full_like(d["group_bits"], depth)
        k1_matches_plain((d["bases"], d["table"], d["a_pack"], d["b_pack"], bits), p.b_win)


@pytest.mark.parametrize("name", ["keys_2e31", "commonised"])
def test_k1_plans_bit_equal_to_plain(cuda, monkeypatch, name):
    plan = k1_plan(name, cuda, monkeypatch)
    if name == "keys_2e31":
        assert plan.m * plan.n >= 2**31
    else:
        # commonised parts: zero pack blocks past a part's own, and
        # padding groups (plen = 0 on every subtile)
        assert len(plan.parts) > 1
        assert any(p.nab8 < p.dev["a_pack"].shape[0] or p.nbb8 < p.dev["b_pack"].shape[0]
                   for p in plan.parts)
        assert any(bool((p.dev["table"][:, :, 3] == 0).all(dim=1).any()) for p in plan.parts)
    for p in plan.parts:
        d = p.dev
        k = k1_matches_plain((d["bases"], d["table"], d["a_pack"], d["b_pack"], d["group_bits"]),
                             p.b_win)
        assert int((k != I32_MAX).sum()) == p.p_real


# window ref 0 searched from negative anchors in a group at base 0, and
# negative B window refs: reads before both packs' first blocks
_BEFORE_THE_PACKS = dict(seed=1, r_a=(0, 2), r_b=(-8, 6))


@pytest.mark.parametrize(
    "b_win,bits,anchors,shift,extra",
    [(3, 4, (0, 128), 0, {}), (3, 6, (0, 128), 0, {}), (5, 8, (0, 128), 0, {}),
     (5, None, (0, 128), 0, {}), (5, None, (-100, 300), 0, {}), (40, None, (0, 128), 0, {}),
     (5, None, (0, 128), 3 * 2**28, {}), (5, None, (0, 128), 2**30, {}),
     (5, None, (-100, 0), 0, _BEFORE_THE_PACKS)],
    ids=["bw3-d4", "bw3-d6", "bw5-d8", "bw5-mixed", "bw5-out-of-window", "bw40-mixed",
         "bw5-offsets-past-2e29", "bw5-offset-sums-past-2e31", "bw5-reads-before-the-packs"],
)
def test_k1_odd_windows_bit_equal_to_plain(cuda, b_win, bits, anchors, shift, extra):
    # cum that runs at random or is all zero, clamped reads, wrapping
    # keys, padding groups; anchors past [0, 128) send the search out
    # of the staged A window; b_win 40 stages the widest B window; jb,
    # cum and p0 past 2^29 (at 2^30 their sums pass 2^31); reads before
    # the packs wrap once, as the plain version's torch indices do
    kw = dict(seed=b_win + (bits or 0), b_win=b_win, bits=bits, anchors=anchors, shift=shift)
    h = torch_cases.k1_odd_windows(**{**kw, **extra})
    if extra:
        assert torch_cases.k1_reads_before_the_packs(h) == (True, True)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in h.items()}
    k1_matches_plain((t["bases"], t["table"], t["a_pack"], t["b_pack"], t["group_bits"]), b_win)


def test_k1_unaligned_packs_take_the_scalar_path(cuda):
    h = torch_cases.k1_odd_windows(seed=9, b_win=5, bits=None)

    def unaligned(x):
        flat = torch.empty(x.size + 1, dtype=torch.int32, device=cuda)
        flat[1:] = torch.from_numpy(x.reshape(-1)).to(cuda)
        return flat[1:].view(x.shape)

    t = {k: torch.from_numpy(v).to(cuda) for k, v in h.items()}
    a, b = unaligned(h["a_pack"]), unaligned(h["b_pack"])
    assert a.is_contiguous() and a.data_ptr() % 16 and b.data_ptr() % 16
    want = k1_matches_plain((t["bases"], t["table"], t["a_pack"], t["b_pack"], t["group_bits"]), 5)
    got = k1_matches_plain((t["bases"], t["table"], a, b, t["group_bits"]), 5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,pad_count,corner", [(5000, 100, 0), (8192, 96, 3), (8192, 100, 3), (1, 0, 0)])
def test_k2_kernel_matches_plain(cuda, n, pad_count, corner):
    rng = np.random.default_rng(n + pad_count)
    m = n_cols = 65536
    pad = min(97 if corner else pad_count, n)
    real = n - pad
    flat = np.repeat(rng.choice(m * n_cols, size=real, replace=False), rng.integers(1, 7, size=real))[:real]
    if corner:
        flat[-corner:] = m * n_cols - 1
    key = np.sort(np.concatenate([(np.sort(flat) - 2**31).astype(np.int32), np.full(pad, I32_MAX, np.int32)]))
    vals = rng.normal(size=n).astype(np.float32)
    kt, vt = torch.from_numpy(key).to(cuda), torch.from_numpy(vals).to(cuda)
    before = scan.KERNEL.launches
    got = scan.merge_epilogue_scan(kt, vt, pad_count, n_cols=n_cols, sentinel_row=m)
    want = scan.merge_epilogue_plain(kt, vt, pad_count, n_cols=n_cols, sentinel_row=m)
    torch.cuda.synchronize()
    assert scan.KERNEL.launches == before + 1
    for i in (0, 1, 3, 4):
        assert torch.equal(got[i], want[i]), i
    torch.testing.assert_close(got[2], want[2], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "make",
    [
        lambda: (erdos_renyi(64, 64, 0.08, seed=1), erdos_renyi(64, 64, 0.08, seed=2)),
        lambda: (erdos_renyi(48, 96, 0.1, seed=3), erdos_renyi(96, 32, 0.07, seed=4)),
        lambda: (rmat(12, edge_factor=8, seed=5),) * 2,
        lambda: (erdos_renyi(70_000, 70_000, 2e-5, seed=6),) * 2,
        lambda: (COO((65536, 2), [65535, 3], [0, 1], [1.5, 2.0]), COO((2, 65536), [0, 1], [65535, 7], [2.0, 1.0])),
    ],
    ids=["er64", "rect", "rmat12", "er70k", "corner_2e32"],
)
def test_spgemm_on_card_matches_scipy(cuda, make):
    a, b = make()
    assert_csr_allclose(spgemm(a, b, device=cuda), spgemm_scipy(a, b), rtol=RTOL, atol=ATOL)


T = scan.TILE


def k2_stream(n, runs, pad, seed, n_cols=65536):
    """A sorted biased-key stream of ``n`` slots: runs of the given
    lengths (in order, distinct ascending keys) and ``pad`` sentinels.
    Values are multiples of 1/8 below 8 in magnitude, so every run sum
    is exact in float32 in any order: kernel and plain must agree to
    the bit."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(runs, np.int64)
    assert lengths.sum() + pad == n
    coords = np.sort(rng.choice(2**31, size=len(lengths), replace=False)).astype(np.int64)
    key = np.concatenate([np.repeat(coords - 2**31, lengths).astype(np.int32), np.full(pad, I32_MAX, np.int32)])
    return key, (rng.integers(-63, 64, size=n) / 8).astype(np.float32), n_cols


def runs_to_fill(n, fixed, seed):
    """``fixed`` runs, then short runs (1-5) up to ``n`` slots."""
    rng = np.random.default_rng(seed)
    runs = list(fixed)
    while sum(runs) < n:
        runs.append(int(min(rng.integers(1, 6), n - sum(runs))))
    return runs


def k2_matches_plain(key, vals, pad_count, n_cols, sentinel_row=65536):
    kt, vt = (torch.as_tensor(a).to("cuda") if isinstance(a, np.ndarray) else a for a in (key, vals))
    before = scan.KERNEL.launches
    got = scan.merge_epilogue_scan(kt, vt, pad_count, n_cols=n_cols, sentinel_row=sentinel_row)
    want = scan.merge_epilogue_plain(kt, vt, pad_count, n_cols=n_cols, sentinel_row=sentinel_row)
    torch.cuda.synchronize()
    assert scan.KERNEL.launches == before + 1
    for i in (0, 1, 2, 3, 4):
        assert torch.equal(got[i], want[i]), i
    return got


def test_k2_run_longer_than_three_tiles(cuda):
    n = 5 * T + 77
    key, vals, n_cols = k2_stream(n, runs_to_fill(n - 300, [T // 2, 3 * T + 100], seed=1), 300, seed=1)
    got = k2_matches_plain(key, vals, 300, n_cols)
    end = T // 2 + 3 * T + 100 - 1
    assert bool(got[3][end]) and not got[3][T // 2:end].any()
    assert float(got[2][end]) == vals[T // 2:end + 1].astype(np.float64).sum()


@pytest.mark.parametrize("shift", [-1, 0, 1])
def test_k2_runs_ending_at_tile_boundaries(cuda, shift):
    # a run ends at slot b·T + shift − 1 for b = 1, 3, 5: one before, at
    # and one after a tile boundary; the run ending near 5·T is T + 500
    # slots long and crosses 4·T
    n = 6 * T + 9
    runs = []
    for b in (1, 3, 5):
        target = b * T + shift - sum(runs)
        runs += {1: runs_to_fill(target, [], seed=b), 3: [target - 40, 40], 5: [target - T - 500, T + 500]}[b]
    runs = runs_to_fill(n - 9, runs, seed=7)
    key, vals, n_cols = k2_stream(n, runs, 9, seed=2 + shift)
    got = k2_matches_plain(key, vals, 9, n_cols)
    for b in (1, 3, 5):
        assert bool(got[3][b * T + shift - 1])


def test_k2_sentinel_pad_longer_than_a_tile(cuda):
    n = 3 * T + 11
    pad = T + 500
    key, vals, n_cols = k2_stream(n, runs_to_fill(n - pad, [], seed=3), pad, seed=3)
    got = k2_matches_plain(key, vals, pad, n_cols)
    assert not got[3][n - pad:].any()


@pytest.mark.parametrize("n", [1, T - 1, T, T + 1, 3 * T + 5])
def test_k2_lengths_around_the_tile(cuda, n):
    pad = min(n // 3, 50)
    key, vals, n_cols = k2_stream(n, runs_to_fill(n - pad, [], seed=n), pad, seed=n)
    k2_matches_plain(key, vals, pad, n_cols)


def test_k2_unaligned_view_takes_the_scalar_path(cuda):
    n = 2 * T + 333
    key, vals, n_cols = k2_stream(n + 1, runs_to_fill(n + 1 - 40, [700], seed=4), 40, seed=4)
    kt, vt = torch.from_numpy(key).to(cuda)[1:], torch.from_numpy(vals).to(cuda)[1:]
    assert kt.is_contiguous() and kt.data_ptr() % 16 and vt.data_ptr() % 16
    k2_matches_plain(kt, vt, 40, n_cols)


@pytest.mark.parametrize("pad_count", [T + 2, T + 3, T + 4])
def test_k2_corner_2e32_across_tiles(cuda, pad_count):
    # T + 3 sentinel slots (padding plus real corner products, at
    # m·n = 2³²): the terminal slot is real iff T + 3 > pad_count
    n = 3 * T
    key, vals, n_cols = k2_stream(n, runs_to_fill(n - T - 3, [], seed=5), T + 3, seed=5)
    got = k2_matches_plain(key, vals, pad_count, n_cols)
    assert bool(got[3][-1]) == (T + 3 > pad_count)


def test_k2_two_launches_bit_equal(cuda):
    n = 4 * T + 123
    key, vals, n_cols = k2_stream(n, runs_to_fill(n - 64, [2 * T + 5, 900], seed=6), 64, seed=6)
    kt, vt = torch.from_numpy(key).to(cuda), torch.from_numpy(vals).to(cuda)
    a = scan.merge_epilogue_scan(kt, vt, 64, n_cols=n_cols, sentinel_row=65536)
    b = scan.merge_epilogue_scan(kt, vt, 64, n_cols=n_cols, sentinel_row=65536)
    torch.cuda.synchronize()
    assert torch.equal(a[2].view(torch.int32), b[2].view(torch.int32))


def test_wrappers_reject_mixed_devices(cuda):
    key = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        scan.merge_epilogue_scan(key, torch.zeros(8), 0, n_cols=4, sentinel_row=4)


def random_tables(tile_a, ntasks=40, nblocks=16, seed=0):
    """Every mask case: full tasks, short A slices, lane edges, an empty
    lane range, and zero padding tasks; keys that wrap at m·n = 2³²."""
    rng = np.random.default_rng(seed + tile_a)
    real = ntasks - 8
    tasks = np.zeros((ntasks, 4), np.int32)
    b_lo = rng.integers(0, 64, size=real)
    b_hi = rng.integers(64, 129, size=real)
    b_lo[:2], b_hi[:2] = 0, 128
    b_lo[2], b_hi[2] = 40, 40
    tasks[:real] = np.stack(
        [rng.integers(1, tile_a + 1, size=real), rng.integers(0, nblocks, size=real), b_lo, b_hi], 1
    )
    tasks[0, 0] = tile_a
    return [
        torch.from_numpy(x)
        for x in (
            tasks.reshape(-1),
            rng.integers(0, 65536, size=(ntasks, tile_a)).astype(np.int32),
            rng.normal(size=(ntasks, tile_a)).astype(np.float32),
            rng.integers(0, 65536, size=(nblocks, 128)).astype(np.int32),
            rng.normal(size=(nblocks, 128)).astype(np.float32),
        )
    ]


def assert_bit_equal(got, want):
    for g, w in zip(got, want):
        g = g.view(torch.int32) if g.dtype == torch.float32 else g
        w = w.view(torch.int32) if w.dtype == torch.float32 else w
        assert torch.equal(g, w)


def k3_k4_match_plain(args, tile_a, n_cols, sentinel_row):
    before = (expand.KERNEL_PACKED.launches, expand.KERNEL_COORDS.launches)
    got_p = expand.expand_tiles_packed(*args, tile_a=tile_a, n_cols=n_cols)
    got_c = expand.expand_tiles_coords(*args, tile_a=tile_a, sentinel_row=sentinel_row)
    want_p = expand.expand_tiles_packed_plain(*args, tile_a=tile_a, n_cols=n_cols)
    want_c = expand.expand_tiles_coords_plain(*args, tile_a=tile_a, sentinel_row=sentinel_row)
    torch.cuda.synchronize()
    assert (expand.KERNEL_PACKED.launches, expand.KERNEL_COORDS.launches) == (before[0] + 1, before[1] + 1)
    assert_bit_equal(got_p, want_p)
    assert_bit_equal(got_c, want_c)


@pytest.mark.parametrize("tile_a", [8, 32, 128])
def test_k3_k4_kernels_bit_equal_to_plain(cuda, tile_a):
    args = [t.to(cuda) for t in random_tables(tile_a)]
    k3_k4_match_plain(args, tile_a, 65536, 65536)


def test_k3_k4_kernels_bit_equal_on_a_plan(cuda):
    g = rmat(10, edge_factor=16, seed=1)
    tplan = plan_tiled(g.to_csc(), g.to_csr(), waste_limit=2.0, device=cuda)
    tables = tplan.class_tables()
    assert {s.tile_a for s, _ in tables} == {8, 32, 128}
    for sched, d in tables:
        args = [d[k] for k in ("tasks", "a_rows_t", "a_vals_t", "b_cols_blk", "b_vals_blk")]
        k3_k4_match_plain(args, sched.tile_a, tplan.n, tplan.m)


@pytest.mark.parametrize("packed", [None, False])
@pytest.mark.parametrize(
    "make",
    [
        lambda: (rmat(12, edge_factor=8, seed=5),) * 2,
        lambda: (rmat(10, edge_factor=16, seed=1),) * 2,
        lambda: (erdos_renyi(70_000, 70_000, 2e-5, seed=6),) * 2,
        big_shape_pair,
    ],
    ids=["rmat12", "rmat10_ef16", "er70k", "big_shape"],
)
def test_tiles_on_card_match_scipy(cuda, make, packed):
    a, b = make()
    got = spgemm(a, b, strategy="tiles", packed=packed, device=cuda)
    assert_csr_allclose(got, spgemm_scipy(a, b), rtol=RTOL, atol=ATOL)


def test_unsplit_big_plan_on_card_runs_k4_and_flat_residue(cuda):
    a, b = big_shape_pair(seed=2)
    tplan = plan_tiled(a.to_csc(), b.to_csr(), device=cuda)
    assert tplan.light_plan is not None and tplan.class_tables()
    before = expand.KERNEL_COORDS.launches
    got = spgemm_padded_tiled(tplan).to_csr()
    assert expand.KERNEL_COORDS.launches == before + 1  # once over all the class tables
    assert_csr_allclose(got, spgemm_scipy(a, b), rtol=RTOL, atol=ATOL)


def random_group(layout, seed, nblocks=16):
    """A group of class tables of ``layout`` = [(tile_a, tasks)] on the
    host, with every mask case and three padding tasks per class."""
    rng = np.random.default_rng(seed)
    tables = []
    for tile_a, ntasks in layout:
        if ntasks:
            arrays = [t.numpy() for t in random_tables(tile_a, ntasks, nblocks, seed)[:3]]
        else:  # an empty class
            arrays = [np.zeros(0, np.int32), np.zeros((0, tile_a), np.int32),
                      np.zeros((0, tile_a), np.float32)]
        tables.append((tile_a, dict(zip(("tasks", "a_rows_t", "a_vals_t"), arrays))))
    return expand.stage_group(
        tables, rng.integers(0, 65536, size=(nblocks, 128)).astype(np.int32),
        rng.normal(size=(nblocks, 128)).astype(np.float32), "cpu")


def grouped_match_plain(group, n_cols, sentinel_row, extra=4096):
    """The grouped K3 and K4 on the card, once each, against their plain
    versions on the same inputs, bit for bit; slots past the group keep
    what they held."""
    def outs(dtypes):
        return [torch.full((group.slots + extra,), 12345, dtype=dt, device=group.tasks.device)
                for dt in dtypes]

    before = (expand.KERNEL_PACKED.launches, expand.KERNEL_COORDS.launches)
    got, want = outs((torch.int32, torch.float32)), outs((torch.int32, torch.float32))
    expand.expand_part_packed(group, n_cols=n_cols, out_keys=got[0], out_vals=got[1])
    expand.expand_part_packed_plain(group, n_cols=n_cols, out_keys=want[0], out_vals=want[1])
    three = (torch.int32, torch.int32, torch.float32)
    got_c, want_c = outs(three), outs(three)
    expand.expand_part_coords(group, sentinel_row=sentinel_row, out_rows=got_c[0],
                              out_cols=got_c[1], out_vals=got_c[2])
    expand.expand_part_coords_plain(group, sentinel_row=sentinel_row, out_rows=want_c[0],
                                    out_cols=want_c[1], out_vals=want_c[2])
    torch.cuda.synchronize()
    assert (expand.KERNEL_PACKED.launches, expand.KERNEL_COORDS.launches) == (before[0] + 1, before[1] + 1)
    assert_bit_equal(got + got_c, want + want_c)
    assert all((g[group.slots:] == 12345).all() for g in got + got_c)


@pytest.mark.parametrize("layout", [
    [(8, 24)], [(128, 12), (8, 40)], [(128, 12), (32, 16), (8, 24)],
    [(128, 12), (32, 0), (8, 24)], [(16, 12), (64, 12)],
], ids=["8", "128+8", "128+32+8", "empty_middle", "16+64"])
def test_grouped_k3_k4_bit_equal_to_plain(cuda, layout):
    g = random_group(layout, seed=len(layout))
    g = expand.TileGroup(g.desc, *(t.to(cuda) for t in (
        g.tasks, g.a_rows, g.a_vals, g.b_cols_blk, g.b_vals_blk)))
    grouped_match_plain(g, 65536, 65536)


def test_grouped_k3_k4_bit_equal_on_a_plan_and_the_stream_in_place(cuda):
    g = rmat(10, edge_factor=16, seed=1)
    kw = dict(waste_limit=2.0, nparts=2, min_part_stream=1, budget=10.0)
    tplan = plan_tiled_parts(g.to_csc(), g.to_csr(), device=cuda, **kw)
    cpu_plan = plan_tiled_parts(g.to_csc(), g.to_csr(), device="cpu", **kw)
    assert len(tplan.parts) == 2 and tplan.merge_pad
    for (_, _, tp), (_, _, cp) in zip(tplan.parts, cpu_plan.parts):
        assert len(tp.group.layout) > 1
        grouped_match_plain(tp.group, tp.n, tp.m)
        before = expand.KERNEL_PACKED.launches
        got = spgemm_mod.tiled_expand_packed(tp, tplan.merge_pad)
        assert expand.KERNEL_PACKED.launches == before + 1
        want = spgemm_mod.tiled_expand_packed(cp, tplan.merge_pad)
        assert got[2] == want[2]
        assert_bit_equal([t.cpu() for t in got[:2]], want[:2])


def test_tiled_spgemm_launches_k3_and_k4_once_per_part(cuda):
    g = rmat(12, edge_factor=8, seed=5)
    kw = dict(nparts=4, min_part_stream=1, budget=10.0)
    tplan = plan_tiled_parts(g.to_csc(), g.to_csr(), device=cuda, **kw)
    grouped = sum(tp.group is not None for _, _, tp in tplan.parts)
    assert grouped and sum(len(tp.class_tables()) for _, _, tp in tplan.parts) > grouped
    want = spgemm_scipy(g, g)
    for packed, kernel in ((None, expand.KERNEL_PACKED), (False, expand.KERNEL_COORDS)):
        before = kernel.launches
        got = spgemm_padded_tiled_parts(tplan, packed=packed).to_csr()
        assert kernel.launches == before + grouped
        assert_csr_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_grouped_wrappers_refuse_a_misaligned_view(cuda):
    g = random_group([(8, 16)], seed=1)
    g = expand.TileGroup(g.desc, *(t.to(cuda) for t in (
        g.tasks, g.a_rows, g.a_vals, g.b_cols_blk, g.b_vals_blk)))
    keys = torch.empty(g.slots + 1, dtype=torch.int32, device=cuda)
    vals = torch.empty(g.slots + 1, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        expand.expand_part_packed(g, n_cols=65536, out_keys=keys[1:], out_vals=vals[1:])


def test_tiles_corner_2e32_on_card(cuda):
    a = COO((65536, 2), [65535, 3], [0, 1], [1.5, 2.0])
    b = COO((2, 65536), [0, 1], [65535, 7], [2.0, 1.0])
    assert_csr_allclose(spgemm(a, b, strategy="tiles", device=cuda), spgemm_scipy(a, b), rtol=RTOL, atol=ATOL)


def random_blockell(m, k, density, seed, block=(8, 128), empty_rows=()):
    """A random W as block-ELL (ragged rows, so masked slots) and dense."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, k)).astype(np.float32)
    d[rng.random((m, k)) >= density] = 0.0
    for r in empty_rows:
        d[r] = 0.0
    return BlockELL.from_coo(COO.from_dense(d), block_shape=block), d


@pytest.mark.parametrize(
    "m,k,n,density,block,tn",
    [
        (1000, 784, 1024, 0.01, (8, 128), 128),  # MLP1w layer 0's shapes
        (100, 784, 77, 0.05, (8, 128), 128),  # N not a multiple of 128
        (64, 256, 300, 0.002, (8, 128), 64),  # many masked slots and empty row blocks
        (37, 200, 50, 0.1, (16, 8), 32),  # bn = 8, two row groups per block
        (21, 300, 256, 0.1, (5, 128), 256),  # bm not a multiple of 8
    ],
)
def test_k5_kernel_matches_plain(cuda, m, k, n, density, block, tn):
    bm = block[0]
    w, d = random_blockell(m, k, density, seed=m + n, block=block, empty_rows=range(bm, 2 * bm))
    assert not w.block_mask.all()
    dev = spmm.blockell_to_device(w, cuda)
    x = np.random.default_rng(n).standard_normal((k, n)).astype(np.float32)
    k_pad = -(-k // block[1]) * block[1]
    xp = torch.zeros((k_pad, -(-n // tn) * tn), device=cuda)
    xp[:k, :n] = torch.from_numpy(x).to(cuda)
    before = spmm.KERNEL.launches
    got = spmm.spmm_blockell_device(dev["meta"], dev["blocks"], xp, tn=tn)[:m, :n]
    torch.cuda.synchronize()
    assert spmm.KERNEL.launches == before + 1
    want = spmm.spmm_blockell_plain(dev["meta"], dev["blocks"], xp)[:m, :n]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    assert np.abs(got.cpu().numpy() - d.astype(np.float64) @ x).max() <= 1e-6 * scale
    assert not got[bm:2 * bm].any()


def k5_kernel_and_plain(w, x, tn):
    """K5 (counted) and its plain version on a staged W and a padded X."""
    dev = spmm.blockell_to_device(w, x.device)
    before = spmm.KERNEL.launches
    got = spmm.spmm_blockell_device(dev["meta"], dev["blocks"], x, tn=tn)
    want = spmm.spmm_blockell_plain(dev["meta"], dev["blocks"], x)
    torch.cuda.synchronize()
    assert spmm.KERNEL.launches == before + 1
    return got, want, dev


def pad_x(x, rows, tn, cuda, fill=0.0):
    xp = torch.full((rows, -(-x.shape[1] // tn) * tn), fill, device=cuda)
    xp[: x.shape[0], : x.shape[1]] = torch.from_numpy(x).to(cuda)
    return xp


@pytest.mark.parametrize("tn", [32, 128])
def test_k5_never_reads_x_rows_no_weight_needs(cuda, tn):
    # X rows whose weight column is empty (or holds only stored zeros),
    # the padding rows included, are NaN: K5 gives exactly what it gives
    # with them zeroed, and that equals plain on the zeroed X. N_pad (288
    # or 384) is a multiple of 32 but not of the kernel's 256 columns.
    rng = np.random.default_rng(tn)
    m, k, n = 40, 600, 288
    d = rng.standard_normal((m, k)).astype(np.float32)
    d[rng.random((m, k)) >= 0.01] = 0.0
    empty = np.flatnonzero(~d.any(axis=0))
    r, c = np.nonzero(d)
    zr, zc = np.array([1, 9, 33]), empty[[0, len(empty) // 2, -1]]
    w = BlockELL.from_coo(COO((m, k), np.r_[r, zr], np.r_[c, zc], np.r_[d[r, c], np.zeros(3, np.float32)]),
                          block_shape=(8, 128))
    x = rng.standard_normal((k, n)).astype(np.float32)
    k_pad = 640
    unread = np.r_[empty, np.arange(k, k_pad)]
    x_zero = pad_x(x, k_pad, tn, cuda)
    x_zero[torch.from_numpy(unread).to(cuda)] = 0.0
    x_nan = x_zero.clone()
    x_nan[torch.from_numpy(unread).to(cuda)] = float("nan")
    got_nan, plain_nan, _ = k5_kernel_and_plain(w, x_nan, tn)
    got, want, _ = k5_kernel_and_plain(w, x_zero, tn)
    assert plain_nan.isnan().any()  # 0 · NaN reaches the plain sums
    assert torch.isfinite(got_nan).all()
    assert torch.equal(got_nan, got)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    assert np.abs(got[:m, :n].cpu().numpy() - d.astype(np.float64) @ x).max() <= 1e-6 * scale


def test_k5_dense_block_and_stored_zero_blocks(cuda):
    # row block 0: a stored all-zero block, then a block with all 128
    # columns nonempty; row block 1: sparse; row block 2: only a stored
    # all-zero block. N = 96: one column tile, mostly masked.
    rng = np.random.default_rng(3)
    m, k, n = 24, 384, 96
    d = np.zeros((m, k), np.float32)
    d[0:8, 128:256] = rng.uniform(0.5, 1.5, size=(8, 128)) * rng.choice([-1, 1], size=(8, 128))
    sparse = rng.standard_normal((8, k)).astype(np.float32)
    d[8:16] = np.where(rng.random((8, k)) < 0.05, sparse, 0.0)
    r, c = np.nonzero(d)
    zr, zc = (a.reshape(-1) for a in np.meshgrid(np.r_[0:8, 16:24], np.r_[0:128], indexing="ij"))
    zc = zc + np.where(zr < 8, 0, 256)
    w = BlockELL.from_coo(COO((m, k), np.r_[r, zr], np.r_[c, zc], np.r_[d[r, c], np.zeros(zr.size, np.float32)]),
                          block_shape=(8, 128))
    assert w.block_mask[0].sum() == 2 and w.block_mask[2].sum() == 1
    x = rng.standard_normal((k, n)).astype(np.float32)
    got, want, _ = k5_kernel_and_plain(w, pad_x(x, k, 32, cuda), 32)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    assert np.abs(got.cpu().numpy() - d.astype(np.float64) @ x).max() <= 1e-6 * scale
    assert not got[16:24].any()


def test_k5_unaligned_x_takes_the_scalar_path(cuda):
    w, d = random_blockell(100, 300, 0.05, seed=8)
    x = np.random.default_rng(8).standard_normal((300, 64)).astype(np.float32)
    flat = torch.zeros(384 * 64 + 1, device=cuda)
    xp = flat[1:].view(384, 64)
    xp[:300] = torch.from_numpy(x).to(cuda)
    assert xp.is_contiguous() and xp.data_ptr() % 8
    got, want, _ = k5_kernel_and_plain(w, xp, 32)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    assert np.abs(got[:100].cpu().numpy() - d.astype(np.float64) @ x).max() <= 1e-6 * scale


def test_k5_empty_w_writes_zeros(cuda):
    w = BlockELL.from_coo(COO((64, 128), [], [], []), block_shape=(8, 128))
    y = spmm.spmm(w, torch.ones((128, 32)), device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.zeros((64, 32), device=cuda))


def test_k5_wrapper_rejects_mixed_devices_and_unsupported_shapes(cuda):
    w, _ = random_blockell(16, 256, 0.1, seed=1)
    dev = spmm.blockell_to_device(w, cuda)
    x = torch.zeros((256, 128), device=cuda)
    with pytest.raises(ValueError, match="x on cpu"):
        spmm.spmm_blockell_device(dev["meta"], dev["blocks"], x.cpu())
    with pytest.raises(ValueError, match="meta on cpu"):
        spmm.spmm_blockell_device(dev["meta"].cpu(), dev["blocks"], x)
    for tn in (48, 512):
        with pytest.raises(ValueError, match="K5 takes tn"):
            spmm.spmm_blockell_device(dev["meta"], dev["blocks"], torch.zeros((256, 1536), device=cuda), tn=tn)
    before = spmm.KERNEL.launches
    with pytest.raises(ValueError, match="bn | K_pad"):
        spmm.spmm_blockell_device(dev["meta"], dev["blocks"], torch.zeros((200, 128), device=cuda))
    assert spmm.KERNEL.launches == before


def weights(name):
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "saved_weights")
    return load_params(os.path.join(root, name))


@pytest.mark.parametrize(
    "model_type,path,batch,per_call",
    [("MLP1w", "MLP1w/prune0p01_finetuned.pkl", 256, 3), ("MLP1", "MLP1/pruned10_finetuned.pkl", 33, 3),
     ("LeNet", "LeNet/pruned_finetuned", 64, 5)],
)
def test_sparse_models_on_card_match_dense(cuda, model_type, path, batch, per_call):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = weights(path)
    x = synthetic_mnist(10 * batch, seed=1)["test"][0][:batch]
    dense = make_model(model_type).to(cuda)
    dense.load_state_dict(state_dict_from_params(p))
    cls = SparseLeNet if model_type == "LeNet" else SparseMLP
    model = cls(p, device=cuda)
    before = spmm.KERNEL.launches
    got = model(x)
    torch.cuda.synchronize()
    assert spmm.KERNEL.launches == before + per_call
    with torch.no_grad():
        want = dense(torch.from_numpy(x).to(cuda))[0]
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5, err


# ---- the flat strategy, compaction, the native planner, triangles ---------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same_csr(got, want):
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["rmat10_ef8", "band2048_p5", "mesh2d_48"])
def test_flat_on_card_equals_cpu(cuda, name):
    from outerspace_tpu_torch.formats import read_mtx

    a = read_mtx(os.path.join(REPO, "data", "mtx", f"{name}.mtx"))
    before = scan.KERNEL.launches
    got = spgemm(a, a, strategy="flat", device=cuda)
    assert scan.KERNEL.launches == before + 1
    assert_same_csr(got, spgemm(a, a, strategy="flat", device="cpu"))
    assert_csr_allclose(got, spgemm_scipy(a, a), rtol=RTOL, atol=ATOL)


def test_flat_on_card_twokey_corner_and_p_pad(cuda):
    from outerspace_tpu_torch.ops.spgemm import spgemm_coo

    a, b = big_shape_pair(seed=4)  # m·n > 2³²: the two-key merge
    assert_same_csr(spgemm(a, b, strategy="flat", device=cuda),
                    spgemm(a, b, strategy="flat", device="cpu"))
    m = 65536  # m·n = 2³²: the corner's key is the sentinel's pattern
    a = COO((m, 4), [m - 1, m - 1, 3], [0, 1, 2], [1.5, 2.0, 3.0])
    b = COO((4, m), [0, 1, 2], [m - 1, m - 1, 7], [2.0, 0.5, 1.0])
    for p_pad in (None, 3, 4, 5000):
        got = spgemm(a, b, strategy="flat", p_pad=p_pad, device=cuda)
        assert_csr_allclose(got, spgemm_scipy(a, b), rtol=RTOL, atol=ATOL)
    c = spgemm_coo(a, b, p_pad=4096, device=cuda)
    assert c.col.tolist() == [7, m - 1]


@pytest.mark.parametrize("strategy", ["gather", "tiles", "flat"])
def test_to_csr_on_card_equals_the_host_route(cuda, strategy):
    import importlib

    from outerspace_tpu_torch.formats import CSR
    from outerspace_tpu_torch.ops import gather_pipeline as gp

    tsp = importlib.import_module("outerspace_tpu_torch.ops.spgemm")
    g = rmat(11, edge_factor=8, seed=3)
    a_csc, b_csr = g.to_csc(), g.to_csr()
    if strategy == "gather":
        merged = gp.spgemm_gather_padded(gp.plan_spgemm_gather(a_csc, b_csr, device=cuda))
    elif strategy == "tiles":
        merged = tsp.spgemm_padded_tiled_parts(
            tsp.plan_tiled_parts(a_csc, b_csr, nparts=2, budget=10.0, device=cuda))
    else:
        merged = tsp.spgemm_padded(tsp.expansion_plan(a_csc, b_csr), device=cuda)
    got = merged.to_csr()
    valid = merged.valid.cpu().numpy()
    rows = merged.rows.cpu().numpy()[valid]
    indptr = np.zeros(g.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=g.shape[0]), out=indptr[1:])
    want = CSR(merged.shape, indptr, merged.cols.cpu().numpy()[valid],
               merged.vals.cpu().numpy()[valid])
    assert got.indptr.dtype == np.int64
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data.view(np.int32), want.data.view(np.int32))
    assert_csr_allclose(got, spgemm_scipy(g, g), rtol=RTOL, atol=ATOL)


def test_native_planner_builds_and_plans_on_the_card_machine(cuda, monkeypatch):
    from outerspace_tpu_torch.runtime import build
    from outerspace_tpu_torch.sched import gplanner

    assert build.build_host("gplan").exists()
    g = rmat(11, edge_factor=8, seed=2)
    native = plan_spgemm_gather(g.to_csc(), g.to_csr(), device=cuda)
    monkeypatch.setattr(gplanner, "_cut_subtiles", gplanner._cut_subtiles_loop)
    monkeypatch.setattr(gplanner, "_pack_groups", gplanner._pack_groups_loop)
    loops = plan_spgemm_gather(g.to_csc(), g.to_csr(), device=cuda)
    assert len(native.parts) == len(loops.parts)
    for p, q in zip(native.parts, loops.parts):
        for k in p.dev:
            assert torch.equal(p.dev[k], q.dev[k]), k


@pytest.mark.parametrize("seed", [0, 1])
def test_triangles_on_card_equal_scipy(cuda, seed):
    from outerspace_tpu_torch.ops import graph

    # a hub pair whose edge has 600 common neighbours (A² entries past
    # bf16's exact integers) and an R-MAT graph
    for g in (torch_cases.hub_pair_graph(COO, seed=seed), rmat(10, edge_factor=8, seed=seed + 4)):
        want = graph.triangle_count(g, backend="scipy")
        before = scan.KERNEL.launches
        assert graph.triangle_count(g, strategy="sparse", device=cuda) == want
        assert scan.KERNEL.launches == before + 1
        assert graph.triangle_count(g, strategy="dense", device=cuda) == want
        assert graph.triangle_count(g, device=cuda) == want


# ---- Markov clustering: the device chain, K2's column sums, mcl_run


def column_key_stream(cols, seed, m=20_000):
    """A loop stream as the chain forms it: sorted CSC keys (``cols``
    nonzeros per column, rows at random), its biased column keys (the
    sentinel tail's included) and values exact in float32 in any order."""
    from outerspace_tpu_torch.ops import chain

    rng = np.random.default_rng(seed)
    col = np.repeat(np.arange(len(cols)), cols)
    row = np.concatenate([np.sort(rng.choice(m, size=c, replace=False)) for c in cols])
    key = np.full(col.size + 777, I32_MAX, np.int32)
    key[: col.size] = col * np.int64(m) + row - 2**31
    vals = np.zeros(key.size, np.float32)
    vals[: col.size] = rng.integers(1, 64, size=col.size) / 8
    kt = torch.from_numpy(key)
    return kt, chain._col_keys(kt, m), torch.from_numpy(vals), m


@pytest.mark.parametrize("seed", [0, 1])
def test_k2_column_sums_with_runs_past_three_tiles(cuda, seed):
    """K2 with ``n_cols=1`` on column-key streams whose columns run
    longer than three 1,024-slot tiles, ``pad_count`` the stream length
    (as the loop passes it), equal to its plain version; the column
    normalisation built on it equal to the CPU's."""
    from outerspace_tpu_torch.ops import chain

    rng = np.random.default_rng(seed)
    cols = list(rng.integers(0, 40, size=300)) + [3 * T + 100, 5 * T + 1, T, 1, 0, 4 * T - 1]
    key, kcol, vals, m = column_key_stream(rng.permutation(cols), seed)
    got = k2_matches_plain(kcol.to(cuda), vals.to(cuda), kcol.numel(), 1, sentinel_row=m)
    assert int(got[4]) == sum(c > 0 for c in cols) + 1  # + the tail's run
    starts = chain._column_starts(key, m)
    want = chain._csc_colnorm_sorted(kcol, vals, m, starts)
    on_card = chain._csc_colnorm_sorted(kcol.to(cuda), vals.to(cuda), m, starts.to(cuda))
    assert torch.equal(on_card.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("join", ["fill", "gather", "auto"])
def test_mcl_iteration_on_card_equals_cpu(cuda, join):
    """One loop iteration on the card equals the CPU's; "auto" takes
    gather on the card and fill on the CPU, with the same result."""
    from outerspace_tpu_torch.ops import chain, graph

    flow = graph._mcl_setup(rmat(10, edge_factor=8, seed=3)).to_coo()
    n = flow.shape[0]
    key, val = chain._to_csc_state(
        torch.from_numpy(flow.row.astype(np.int32)), torch.from_numpy(flow.col.astype(np.int32)),
        torch.from_numpy(flow.val), torch.ones(flow.nnz, dtype=torch.bool), p_pad=1 << 17, m=n)
    kw = dict(p_pad=1 << 21, elem_pad=1 << 17, m=n, inflation=2.0, threshold=1e-4, blk_cap=8192,
              join=join)

    def step(dev):
        k, v = key.to(dev), val.to(dev)
        s = (k, v, chain._column_starts(k, n), torch.ones((), dtype=torch.bool, device=dev))
        return [x.cpu() for x in chain._mcl_iteration(s, **kw)]

    want, got = step("cpu"), step(cuda)
    assert bool(got[3]) and bool(want[3])
    for i in (0, 2):
        assert torch.equal(got[i], want[i])
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)


def mcl_equal(got, want):
    assert got.nnz == want.nnz
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("make", [lambda: erdos_renyi(120, 120, 0.04, seed=55),
                                  lambda: rmat(10, edge_factor=8, seed=11)], ids=["er120", "rmat10"])
def test_markov_cluster_on_card_equals_scipy(cuda, make, tmp_path, monkeypatch):
    from outerspace_tpu_torch.ops import graph

    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(tmp_path / "c.json"))
    g = make()
    want = graph.markov_cluster(g, iters=4, backend="scipy")
    report = {}
    got = graph.markov_cluster(g, iters=4, device=cuda, report=report)
    mcl_equal(got, want)
    assert report["fast_path"]
    assert [sorted(c) for c in graph.mcl_clusters(got)] == [sorted(c) for c in graph.mcl_clusters(want)]


def test_mcl_run_cold_then_warm_on_card(cuda, tmp_path, monkeypatch):
    """A cold run (the sweep), warm runs on the same prep and from the
    cache: exact, K1 once per stage-1 part, K2 once per part + 1 + 2 per
    loop iteration, at most two host reads in ``mcl_run`` (it reads
    ``ok``); an element budget too small falls back, exactly."""
    import warnings

    from outerspace_tpu_torch.ops import graph

    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(tmp_path / "c.json"))
    g = rmat(10, edge_factor=8, seed=11)
    want = graph.markov_cluster(g, iters=4, backend="scipy")
    flow = graph._mcl_setup(g)
    prep = graph.mcl_prepare(flow, iters=4, device=cuda)
    mcl_equal(graph.mcl_run(prep).to_csr(), want)
    parts = len(prep["tplan"].parts)
    for p in (prep, graph.mcl_prepare(flow, iters=4, device=cuda)):
        before = (gexpand.KERNEL.launches, scan.KERNEL.launches)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = graph.mcl_run(p)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        got = out.to_csr()
        syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
        assert 1 <= len(syncs) <= 2, [str(w.message) for w in syncs]
        assert (gexpand.KERNEL.launches - before[0], scan.KERNEL.launches - before[1]) == \
            (parts, parts + 1 + 2 * 3)
        mcl_equal(got, want)
    assert p["sizing_cached"] and p["p_pad"] == prep["p_pad"]
    prep.update(elem_pad=4096, p_pads=None, blk_caps=None)
    mcl_equal(graph.mcl_run(prep).to_csr(), want)
    assert prep["elem_pad"] == 8192 and prep["ran_with"]["elem_pad"] == 4096


# ---- the NN training pipeline ------------------------------------------------


def steps_on(device, model_type, sd, x, y, cfg, n=3):
    """``n`` train_steps from ``sd`` on (x, y) on ``device``: the losses
    and the final state_dict, on the CPU."""
    from outerspace_tpu_torch.nn import train

    model = train.load_model(model_type, sd, device=device)
    opt = train.make_optimizer(model, cfg)
    xd, yd = x.to(device), y.to(device)
    losses = [float(train.train_step(model, opt, xd, yd, cfg)[0]) for _ in range(n)]
    return losses, {k: v.cpu() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("model_type", ["MLP1w", "LeNet"])
def test_train_steps_on_card_equal_cpu(cuda, model_type):
    # float64 over three steps (Adam moves a weight whose gradient is
    # within rounding of zero by up to 2·lr, so float32 parameters after
    # several steps on two devices need not agree); float32 for one
    # step's loss and gradients (conv1's bias gradient is a float32 sum of
    # 802,816 terms: cuDNN's and the CPU's part by ~3e-6)
    from outerspace_tpu_torch.nn import models, train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train.TrainConfig(model_type=model_type, l2reg=True)
    d = synthetic_mnist(2048, seed=0)["train"]
    x, y = torch.from_numpy(d[0][:1024]), torch.from_numpy(d[1][:1024]).long()
    sd = models.init_lecun_normal_(make_model(model_type), 0).state_dict()
    sd64 = {k: v.double() for k, v in sd.items()}
    cpu = steps_on("cpu", model_type, sd64, x.double(), y, cfg)
    card = steps_on(cuda, model_type, sd64, x.double(), y, cfg)
    np.testing.assert_allclose(card[0], cpu[0], rtol=0, atol=1e-5)
    for k, v in cpu[1].items():
        assert float((card[1][k] - v).abs().max()) <= 1e-5, k
    grads = []
    for dev in ("cpu", cuda):
        model = train.load_model(model_type, sd, device=dev)
        loss, _ = train.loss_fn(model, x.to(dev), y.to(dev), cfg)
        loss.backward()
        grads.append((loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()}))
    assert abs(grads[0][0] - grads[1][0]) <= 1e-5
    for k, g in grads[0][1].items():
        assert float((grads[1][1][k] - g).abs().max()) <= 1e-5, k


def test_finetune_on_card_keeps_zeros(cuda):
    from outerspace_tpu_torch.nn import prune, train

    data = synthetic_mnist(4096, seed=0)
    cfg = train.TrainConfig(model_type="LeNet", num_epochs=1, batch_size=512)
    res = train.train(data, cfg, verbose=False, device=cuda)
    assert all(v.device.type == "cuda" for v in res.params.values())
    pruned = prune.prune_params(res.best_params)
    ft = train.finetune(data, cfg, pruned, verbose=False, device=cuda)
    for name, w in pruned.items():
        if name.endswith("weight"):
            assert not torch.any((ft.params[name] != 0) & (w == 0)), name


def test_cli_pf_on_card_serves_through_k5(cuda, tmp_path):
    from outerspace_tpu_torch import cli

    path = str(tmp_path / "pf.pkl")
    assert cli.main(["nn", "--mode", "pf", "--data", "synthetic", "--num_epochs", "1",
                     "--saved_model_name", path]) == 0
    params = load_params(path)
    x = synthetic_mnist(80, seed=0)["test"][0]
    model = SparseMLP(params, device=cuda)
    before = spmm.KERNEL.launches
    got = model(x)
    torch.cuda.synchronize()
    assert spmm.KERNEL.launches == before + 3
    dense = make_model("MLP1").to(cuda)
    dense.load_state_dict(state_dict_from_params(params))
    with torch.no_grad():
        want = dense(torch.from_numpy(x).to(cuda))[0]
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("strategy", ["gather", "tiles", "flat"])
def test_cli_spgemm_on_card_out_equals_scipy(cuda, tmp_path, capsys, strategy):
    from outerspace_tpu_torch import cli
    from outerspace_tpu_torch.formats import read_mtx

    f = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data", "mtx", "rmat10_ef8.mtx")
    out = str(tmp_path / "c.mtx")
    before = scan.KERNEL.launches
    assert cli.main(["spgemm", f, f, "--strategy", strategy, "--out", out]) == 0
    assert scan.KERNEL.launches > before
    a = read_mtx(f)
    want = spgemm_scipy(a, a.transpose())
    assert_csr_allclose(read_mtx(out).to_csr(), want, rtol=RTOL, atol=ATOL)
    assert f"nnz: {want.nnz}" in capsys.readouterr().out


def test_timers_on_card(cuda):
    from outerspace_tpu_torch.perf import microbench
    from outerspace_tpu_torch.perf.timer import device_sync, result_device, time_device

    x = torch.rand(1 << 22, device=cuda)
    assert result_device([(x,)]) == x.device
    device_sync({"x": x})
    s = time_device(lambda: torch.sort(x), reps=3)
    assert 0 < s < 0.1
    res = microbench.suite(p=8192, e=2048, m=256, k=2, device=str(cuda))
    assert len(res) == 11 and all(np.isfinite(v) and v > 0 for v in res.values())
