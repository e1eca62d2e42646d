"""K3 and K4's plain versions vs the JAX package's Pallas dense-tile
expands (``expand_tiles_packed`` / ``expand_tiles_coords``, interpret
mode), and the host staging halves vs the JAX package's.

The kernels have no reduction, so keys, rows, cols and values must be
bit-equal. Inputs are made with numpy from a seed and handed to both.
"""

import numpy as np
import pytest
import torch

from outerspace_tpu.ops.pallas import expand as jexp
from outerspace_tpu.sched.planner import OuterProductSchedule as JSchedule
from outerspace_tpu_torch.ops.kernels import expand as texp
from outerspace_tpu_torch.sched.planner import OuterProductSchedule as TSchedule

M = N = 65536  # m·n = 2³²: biased keys use every bit and wrap


def random_tables(tile_a, ntasks=24, nblocks=16, seed=0):
    """A task table with every mask case: full tasks, ``a_len < tile_a``,
    ``b_lo > 0``, ``b_hi < 128``, empty lane ranges, and padding tasks
    (all zero) at the end; A slices and B blocks of random values."""
    rng = np.random.default_rng(seed + tile_a)
    real = ntasks - 5
    a_len = rng.integers(1, tile_a + 1, size=real)
    a_len[:3] = tile_a
    b_lo = rng.integers(0, 64, size=real)
    b_hi = rng.integers(64, 129, size=real)
    b_lo[:2], b_hi[:2] = 0, 128
    b_lo[2], b_hi[2] = 40, 40  # no live lane
    tasks = np.zeros((ntasks, 4), np.int32)
    tasks[:real] = np.stack([a_len, rng.integers(0, nblocks, size=real), b_lo, b_hi], 1)
    a_rows_t = rng.integers(0, M, size=(ntasks, tile_a)).astype(np.int32)
    a_rows_t[0, 0], a_rows_t[1, 0] = M - 1, 0
    a_vals_t = rng.normal(size=(ntasks, tile_a)).astype(np.float32)
    b_cols = rng.integers(0, N, size=(nblocks, 128)).astype(np.int32)
    b_cols[tasks[0, 1], :4] = N - 1
    b_vals = rng.normal(size=(nblocks, 128)).astype(np.float32)
    return tasks.reshape(-1), a_rows_t, a_vals_t, b_cols, b_vals


def bits(t):
    t = torch.as_tensor(np.array(t))
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(bits(g), bits(w))


@pytest.mark.parametrize("tile_a", [8, 32, 128])
def test_packed_plain_bit_equal_to_pallas(tile_a):
    arrays = random_tables(tile_a)
    ntasks = arrays[0].shape[0] // 4
    want = jexp.expand_tiles_packed(
        *arrays, ntasks=ntasks, tile_a=tile_a, n_cols=N, interpret=True
    )
    got = texp.expand_tiles_packed_plain(
        *map(torch.from_numpy, arrays), tile_a=tile_a, n_cols=N
    )
    assert got[0].shape == (ntasks * tile_a * 128,)
    assert_bit_equal(got, want)
    keys = got[0].view(ntasks, tile_a, 128)
    assert (keys[-5:] == texp._I32_MAX).all()  # padding tasks: pure sentinel
    assert (keys[2] == texp._I32_MAX).all()  # empty lane range


@pytest.mark.parametrize("tile_a", [8, 32, 128])
def test_coords_plain_bit_equal_to_pallas(tile_a):
    arrays = random_tables(tile_a, seed=7)
    ntasks = arrays[0].shape[0] // 4
    want = jexp.expand_tiles_coords(
        *arrays, ntasks=ntasks, tile_a=tile_a, sentinel_row=M, interpret=True
    )
    got = texp.expand_tiles_coords_plain(
        *map(torch.from_numpy, arrays), tile_a=tile_a, sentinel_row=M
    )
    assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.float32]
    assert_bit_equal(got, want)
    rows = got[0].view(ntasks, tile_a, 128)
    assert (rows[-5:] == M).all() and (got[1].view(ntasks, tile_a, 128)[-5:] == 0).all()


@pytest.mark.parametrize("tile_a", [8, 128])
def test_wrappers_take_the_plain_version_on_cpu(tile_a):
    arrays = [torch.from_numpy(x) for x in random_tables(tile_a, seed=3)]
    assert_bit_equal(
        texp.expand_tiles_packed(*arrays, tile_a=tile_a, n_cols=N),
        texp.expand_tiles_packed_plain(*arrays, tile_a=tile_a, n_cols=N),
    )
    assert_bit_equal(
        texp.expand_tiles_coords(*arrays, tile_a=tile_a, sentinel_row=M),
        texp.expand_tiles_coords_plain(*arrays, tile_a=tile_a, sentinel_row=M),
    )
    assert texp.KERNEL_PACKED.launches == 0 and texp.KERNEL_COORDS.launches == 0


def test_wrappers_check_their_inputs():
    tasks, a_rows, a_vals, b_cols, b_vals = map(torch.from_numpy, random_tables(8))
    ok = dict(tile_a=8, n_cols=N)
    with pytest.raises(TypeError):
        texp.expand_tiles_packed(tasks, a_rows.float(), a_vals, b_cols, b_vals, **ok)
    with pytest.raises(ValueError, match="shape"):
        texp.expand_tiles_packed(tasks[:-4], a_rows, a_vals, b_cols, b_vals, **ok)
    with pytest.raises(ValueError, match="tile_a"):
        texp.expand_tiles_packed(tasks, a_rows, a_vals, b_cols, b_vals, tile_a=256, n_cols=N)
    with pytest.raises(ValueError, match="n_cols"):
        texp.expand_tiles_packed(tasks, a_rows, a_vals, b_cols, b_vals, tile_a=8, n_cols=2**31)
    with pytest.raises(ValueError, match="contiguous"):
        texp.expand_tiles_coords(
            tasks, a_rows.t().contiguous().t(), a_vals, b_cols, b_vals, tile_a=8, sentinel_row=M
        )
    meta = [t.to("meta") for t in (tasks, a_rows, a_vals, b_cols, b_vals)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        texp.expand_tiles_packed(*meta, **ok)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        texp.expand_tiles_coords(*meta, tile_a=8, sentinel_row=M)


def schedule_pair(ntasks, tile_a, seed=0):
    """One random schedule as both packages' OuterProductSchedule."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 100, size=ntasks).astype(np.int32) for _ in range(5)]
    a_rows_t = rng.integers(0, 100, size=(ntasks, tile_a)).astype(np.int32)
    a_vals_t = rng.normal(size=(ntasks, tile_a)).astype(np.float32)
    args = (tile_a, *cols, a_rows_t, a_vals_t, np.arange(3, dtype=np.int32), 99)
    return JSchedule(*args), TSchedule(*args)


@pytest.mark.parametrize("ntasks,tile_a", [(0, 8), (5, 8), (300, 8), (1500, 8), (70, 32), (300, 32), (100, 128)])
def test_schedule_to_host_equal(ntasks, tile_a):
    js, ts = schedule_pair(ntasks, tile_a, seed=ntasks)
    assert ts.slab_layout == js.slab_layout
    assert ts.ntasks_padded == js.ntasks_padded and ts.padded_heavy == js.padded_heavy
    pads = [None] + ([-(-ntasks // 8) * 8 + 16] if ntasks else [])
    for pad in pads:
        jh, th = jexp.schedule_to_host(js, pad), texp.schedule_to_host(ts, pad)
        assert jh.keys() == th.keys()
        for k in jh:
            np.testing.assert_array_equal(jh[k], th[k], err_msg=k)
            assert jh[k].dtype == th[k].dtype
    with pytest.raises(ValueError):
        texp.schedule_to_host(ts, ntasks_pad=-(-ntasks // 8) * 8 + 3)


@pytest.mark.parametrize("nnz_b,pad", [(0, None), (1, None), (1000, None), (5000, None), (1000, 16)])
def test_b_blocks_host_equal(nnz_b, pad):
    rng = np.random.default_rng(nnz_b)
    cols = rng.integers(0, 500, size=nnz_b).astype(np.int32)
    vals = rng.normal(size=nnz_b).astype(np.float32)
    for j, t in zip(jexp.b_blocks_host(cols, vals, pad), texp.b_blocks_host(cols, vals, pad)):
        np.testing.assert_array_equal(j, t)
        assert j.dtype == t.dtype
    with pytest.raises(ValueError):
        texp.b_blocks_host(cols, vals, nblocks_pad=12)
