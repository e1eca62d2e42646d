"""K2's plain version vs the JAX package's Pallas merge epilogue
(``merge_epilogue_scan``, interpret mode), and the biased-key packing vs
the JAX package's.

Rows, cols, valid and nnz must be exact. Values are run sums taken in a
different order (index_add_ here, a segmented doubling scan there), so
they match within rtol 1e-5, atol 1e-6, the tolerance of the JAX
package's own epilogue test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outerspace_tpu.ops.pallas.scan import merge_epilogue_scan as j_scan
from outerspace_tpu.ops.spgemm import merge_epilogue as j_epilogue
from outerspace_tpu.ops.spgemm import pack_key_biased as j_pack
from outerspace_tpu.ops.spgemm import unpack_key_biased as j_unpack
from outerspace_tpu_torch.ops.kernels.scan import (
    merge_epilogue_plain,
    merge_epilogue_scan,
)
from outerspace_tpu_torch.ops.spgemm import (
    merge_biased_keys,
    pack_key_biased,
    unpack_key_biased,
)

I32_MAX = np.int32(2**31 - 1)
RTOL, ATOL = 1e-5, 1e-6


def make_stream(n, n_cols, m, pad, seed, max_dup=6, corner=0):
    """Sorted biased-key stream with duplicate runs, sentinel padding
    and, with ``corner`` > 0, that many real products at the (m-1, n-1)
    corner, whose key is the sentinel's bit pattern when m·n = 2³²."""
    rng = np.random.default_rng(seed)
    real = n - pad
    coords = rng.choice(m * n_cols, size=real, replace=False)
    dups = rng.integers(1, max_dup + 1, size=real)
    flat = np.repeat(coords.astype(np.int64), dups)[:real]
    if corner:
        flat[-corner:] = m * n_cols - 1
    flat.sort()
    biased = (flat - 2**31).astype(np.int32)
    key = np.sort(np.concatenate([biased, np.full(pad, I32_MAX, np.int32)]))
    vals = rng.normal(size=n).astype(np.float32)
    vals[key == I32_MAX] = 0.0
    if corner:
        sent = np.nonzero(key == I32_MAX)[0]
        vals[sent[:corner]] = rng.normal(size=corner).astype(np.float32)
    return key, vals


def assert_epilogue_equal(got, exp):
    for g, e, name in zip(got, exp, ["rows", "cols", "vals", "valid", "nnz"]):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        e = np.asarray(e)
        if name == "vals":
            np.testing.assert_allclose(g, e, rtol=RTOL, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, e, err_msg=name)


def run_both(key, vals, n_cols, m, pad_count):
    got = merge_epilogue_scan(
        torch.from_numpy(key), torch.from_numpy(vals), pad_count,
        n_cols=n_cols, sentinel_row=m,
    )
    exp = j_scan(
        jnp.asarray(key), jnp.asarray(vals), jnp.int32(pad_count),
        n_cols=n_cols, sentinel_row=m, max_run=8, interpret=True,
    )
    return got, exp


CASES = [
    dict(n=4096, n_cols=500, m=400, pad=700, seed=0),
    dict(n=8192, n_cols=65536, m=65536, pad=100, seed=1),
    dict(n=2048, n_cols=370, m=290, pad=0, seed=3),
    dict(n=2048, n_cols=37, m=29, pad=2048, seed=4),  # all padding
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c['n']}_pad{c['pad']}")
def test_k2_plain_matches_pallas(case):
    key, vals = make_stream(**case)
    got, exp = run_both(key, vals, case["n_cols"], case["m"], case["pad"])
    assert_epilogue_equal(got, exp)


@pytest.mark.parametrize("pad_count", [96, 97, 98, 99])
def test_k2_plain_matches_pallas_at_2e32_corner(pad_count):
    # m·n = 2³²: the corner (65535, 65535) packs to INT32_MAX. The stream
    # holds 97 padding slots plus 3 corner products (100 sentinel slots);
    # the terminal slot is real iff 100 > pad_count, on both sides.
    key, vals = make_stream(8192, 65536, 65536, pad=97, seed=2, corner=3)
    assert int(np.sum(key == I32_MAX)) == 100
    got, exp = run_both(key, vals, 65536, 65536, pad_count)
    assert_epilogue_equal(got, exp)
    corner_real = 100 > pad_count
    assert bool(got[3][-1]) == corner_real
    if corner_real:
        assert (int(got[0][-1]), int(got[1][-1])) == (65535, 65535)
        np.testing.assert_allclose(
            float(got[2][-1]), float(vals[key == I32_MAX].sum()), rtol=RTOL, atol=ATOL
        )


def test_k2_plain_run_spanning_chunks():
    # runs of 1..5 crossing the Pallas kernel's 1024-slot chunk bounds,
    # and one run of 300 that spans a whole chunk boundary
    n, n_cols, m = 4096, 1000, 1000
    rng = np.random.default_rng(7)
    flat = np.repeat(np.arange(1500, dtype=np.int64) * 661 % (n_cols * m),
                     rng.integers(1, 6, size=1500))[:n]
    flat[900:1200] = flat[900]
    flat.sort()
    key = (flat - 2**31).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    got = merge_epilogue_scan(torch.from_numpy(key), torch.from_numpy(vals), 0,
                              n_cols=n_cols, sentinel_row=m)
    exp = j_scan(jnp.asarray(key), jnp.asarray(vals), jnp.int32(0), n_cols=n_cols,
                 sentinel_row=m, max_run=512, interpret=True)
    assert_epilogue_equal(got, exp)


@pytest.mark.parametrize("n,pad", [(1, 0), (1, 1), (999, 17), (3000, 0), (5001, 2000)])
def test_k2_plain_any_length(n, pad):
    # The port takes streams of any length (the Pallas kernel needs a
    # power-of-two chunk ≥ 1024); the JAX package's XLA epilogue is the
    # reference there.
    key, vals = make_stream(n, 97, 89, pad, seed=n)
    got = merge_epilogue_scan(torch.from_numpy(key), torch.from_numpy(vals), pad,
                              n_cols=97, sentinel_row=89)
    exp = j_epilogue(jnp.asarray(key), jnp.asarray(vals), 97, 89, max_run=None,
                     pad_count=pad, epilogue="xla")
    assert_epilogue_equal(got, exp)


def test_k2_plain_empty_stream():
    key = torch.zeros(0, dtype=torch.int32)
    rows, cols, vals, valid, nnz = merge_epilogue_plain(
        key, torch.zeros(0), 0, n_cols=5, sentinel_row=5
    )
    assert rows.shape == cols.shape == vals.shape == valid.shape == (0,)
    assert int(nnz) == 0


def test_merge_biased_keys_sorts_first():
    key, vals = make_stream(3000, 97, 89, 100, seed=11)
    perm = np.random.default_rng(12).permutation(key.shape[0])
    got = merge_biased_keys(torch.from_numpy(key[perm]), torch.from_numpy(vals[perm]),
                            97, 89, pad_count=100)
    exp = j_epilogue(jnp.asarray(key), jnp.asarray(vals), 97, 89, max_run=None,
                     pad_count=100, epilogue="xla")
    assert_epilogue_equal(got, exp)


def test_k2_wrapper_checks_inputs():
    key = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        merge_epilogue_scan(key, torch.zeros(8, dtype=torch.float64), 0, n_cols=4, sentinel_row=4)
    with pytest.raises(ValueError):
        merge_epilogue_scan(key, torch.zeros(7), 0, n_cols=4, sentinel_row=4)
    with pytest.raises(ValueError):
        merge_epilogue_scan(key[::2], torch.zeros(4), 0, n_cols=4, sentinel_row=4)
    with pytest.raises(ValueError):
        merge_epilogue_scan(key, torch.zeros(8), 0, n_cols=0, sentinel_row=4)
    with pytest.raises(ValueError):
        merge_epilogue_scan(key.to("meta"), torch.zeros(8, device="meta"), 0,
                            n_cols=4, sentinel_row=4)


@pytest.mark.parametrize("m,n", [(29, 37), (65536, 65536), (50_000, 50_000), (1, 2**31 - 1)])
def test_pack_unpack_match_jax(m, n):
    rng = np.random.default_rng(m)
    rows = rng.integers(0, m, size=1000).astype(np.int32)
    cols = rng.integers(0, n, size=1000).astype(np.int32)
    rows[:2], cols[:2] = [0, m - 1], [0, n - 1]  # both ends of the key space
    key = pack_key_biased(torch.from_numpy(rows), torch.from_numpy(cols), n)
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy(), np.asarray(j_pack(jnp.asarray(rows), jnp.asarray(cols), n)))
    r, c = unpack_key_biased(key, n)
    jr, jc = j_unpack(jnp.asarray(key.numpy()), n)
    np.testing.assert_array_equal(r.numpy(), rows)
    np.testing.assert_array_equal(c.numpy(), cols)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
