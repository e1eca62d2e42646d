"""The expand of each MCL loop squaring (``ops/kernels/loop_expand.py``):
on the CPU, ``_mcl_iteration``'s gather join through the wrapper against
the inline expand it replaced, the wrapper's refusals and the division
by m; on the card (marker ``cuda``; skipped without one), the CUDA
kernel bit-equal to its plain version for both key types, on flows
that put a tile past ``p_clamped`` and one across it, elements of degree
0 and the sentinel tail, one owner over many tiles, a tile over more
elements than the kernel stages, P past ``p_pad`` and m not a power of
two; and ``mcl_run`` launching it once a loop iteration. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_loop_expand.py
"""

import numpy as np
import pytest
import torch

from outerspace_tpu_torch.formats import rmat
from outerspace_tpu_torch.ops import chain
from outerspace_tpu_torch.ops.kernels import loop_expand as le
from outerspace_tpu_torch.ops.spgemm import expand_partial_products

TILE = 4096  # the kernel's slots a block
STAGE = 1024  # the elements a block stages


def flow_state(seed, m, dtype, *, hub=0, light=0, empty=0.2, deg=4.0, tail=1000):
    """A random CSC state of an m×m flow: (kcsc, vals, starts_ext).

    Columns of Poisson(``deg``) random rows, a share ``empty`` of them
    empty (their elements' pairs have degree 0); with ``hub``, column 0
    holds ``hub`` rows and row 0 lies in 5 columns, so each of those
    elements owns ``hub`` slots; with ``light``, the last ``light``
    columns hold one row each and columns 1-3 draw 3,000 rows from
    them, so runs of elements of degree 1 fill whole tiles. ``tail``
    sentinel slots end the stream."""
    rng = np.random.default_rng(seed)
    sizes = rng.poisson(deg, m)
    sizes[rng.random(m) < empty] = 0
    if light:
        sizes[m - light:], sizes[1:4] = 0, 0
    rows, cols = [], []
    for c in np.flatnonzero(sizes):
        rows.append(rng.choice(m, size=min(sizes[c], m), replace=False))
        cols.append(np.full(rows[-1].shape, c))
    if hub:
        rows.append(rng.choice(np.arange(1, m), size=hub, replace=False))
        cols.append(np.zeros(hub, np.int64))
        rows.append(np.zeros(5, np.int64))
        cols.append(rng.choice(np.arange(1, m), size=5, replace=False))
    if light:
        lite = np.arange(m - light, m)
        rows.append(rng.integers(0, m, light))
        cols.append(lite)
        for c in (1, 2, 3):
            rows.append(rng.choice(lite, size=3000, replace=False))
            cols.append(np.full(3000, c))
    key = np.unique(np.concatenate(cols).astype(np.int64) * m + np.concatenate(rows))
    vals = rng.uniform(0.0, 1.0, key.shape[0]).astype(np.float32)
    vals[::7] = rng.uniform(0.0, 1e-30, vals[::7].shape[0]).astype(np.float32)
    if dtype == torch.int32:
        kt = torch.from_numpy((key - 2**31).astype(np.int32))
    else:
        kt = torch.from_numpy(key)
    kcsc = torch.cat([kt, torch.full((tail,), chain._sentinel(dtype), dtype=dtype)])
    vt = torch.cat([torch.from_numpy(vals), torch.zeros(tail)])
    return kcsc, vt, chain._column_starts(kcsc, m)


def expand_inputs(kcsc, starts_ext, m, p_pad):
    """``offsets`` and ``p_clamped`` as ``_mcl_iteration`` derives them."""
    _, row_f = chain._unpack(kcsc, m)
    valid_f = kcsc != chain._sentinel(kcsc.dtype)
    col_deg = starts_ext[1:] - starts_ext[:-1]
    deg = torch.where(valid_f, col_deg[torch.where(valid_f, row_f, 0).long().clamp(max=m - 1)], 0)
    offsets = torch.cat([deg.new_zeros(1, dtype=torch.int64), torch.cumsum(deg, 0)])
    return offsets, offsets[-1].clamp(0, p_pad)


def old_expand(kcsc, vals, indptr, offsets, p_clamped, *, p_pad, m):
    """The gather join's expand as ``_mcl_iteration`` had it inline."""
    col_f, row_f = chain._unpack(kcsc, m)
    valid_f = kcsc != chain._sentinel(kcsc.dtype)
    a_k = torch.where(valid_f, row_f, 0)
    c_bcast, r_gath, v = expand_partial_products(
        torch.where(valid_f, col_f, m), torch.where(valid_f, vals, 0.0),
        a_k, indptr, row_f, vals, offsets, p_clamped, p_pad, m,
    )
    key = torch.where(torch.arange(p_pad) < p_clamped,
                      chain._pack(c_bcast, r_gath, m, kcsc.dtype), chain._sentinel(kcsc.dtype))
    return key, v


M32, M64 = 30011, 70001  # not powers of two; 70001² ≥ 2³²
# name: (flow_state keywords, p_pad from P)
CASES = {
    "straddle": (dict(deg=12.0), lambda p: p + 3 * TILE + 1000),
    "hub": (dict(deg=12.0, hub=13000), lambda p: p + TILE),
    "light": (dict(deg=12.0, light=12000), lambda p: p + 2),
    "past_p_pad": (dict(deg=12.0, hub=9000), lambda p: p - TILE - 3),
    "ragged": (dict(deg=2.0, empty=0.5), lambda p: 4 * (p // 4) + TILE + 3),
}


def case(name, dtype):
    kw, pad = CASES[name]
    m = M32 if dtype == torch.int32 else M64
    kcsc, vals, starts = flow_state(len(name) + 31 * (dtype == torch.int64), m, dtype, **kw)
    offsets, _ = expand_inputs(kcsc, starts, m, 2**31 - 1)
    p_pad = pad(int(offsets[-1]))
    offsets, p_clamped = expand_inputs(kcsc, starts, m, p_pad)
    return (kcsc, vals, starts, offsets, p_clamped), dict(p_pad=p_pad, m=m)


def test_the_cases_reach_what_they_name():
    """P and the tiles each case was made for: a tile past P and one
    across it, degree-0 elements, an owner over more than 3 tiles, runs
    of more than STAGE elements in one tile, P past p_pad."""
    for dtype in (torch.int32, torch.int64):
        for name in CASES:
            (kcsc, _, starts, offsets, pc), kw = case(name, dtype)
            deg = (offsets[1:] - offsets[:-1]).numpy()
            valid = (kcsc != chain._sentinel(dtype)).numpy()
            p_total, p_pad = int(offsets[-1]), kw["p_pad"]
            assert (deg[valid] == 0).any() and not deg[~valid].any()
            assert (p_total > p_pad) == (name == "past_p_pad") and int(pc) == min(p_total, p_pad)
            if name == "straddle":
                assert p_total % TILE and p_pad - p_total > 2 * TILE
            if name == "ragged":
                assert p_pad % 4
            if name == "hub":
                assert deg.max() > 3 * TILE
            if name == "light":
                per_tile = np.diff(np.searchsorted(offsets.numpy(), np.arange(0, p_total, TILE)))
                assert per_tile.max() > STAGE


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_the_inline_expand(name, dtype):
    args, kw = case(name, dtype)
    got = le.loop_expand(*args, **kw)
    want = old_expand(*args, **kw)
    assert got[0].dtype == dtype and torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
def test_mcl_iteration_through_the_wrapper_equals_the_inline_expand(dtype, monkeypatch):
    """The whole iteration, state for state, through the wrapper and
    through the inline expand it replaced."""
    m = M32 if dtype == torch.int32 else M64
    kcsc, vals, starts = flow_state(5, m, dtype, hub=5000, light=6000, tail=800_000)
    state = (kcsc, vals, starts, torch.ones((), dtype=torch.bool))
    p_total = int(expand_inputs(kcsc, starts, m, 2**31 - 1)[0][-1])
    kw = dict(p_pad=p_total + 5000, elem_pad=kcsc.shape[0], m=m, inflation=2.0,
              threshold=1e-4)
    got = chain._mcl_iteration(state, **kw)
    monkeypatch.setattr(chain, "loop_expand", old_expand)
    want = chain._mcl_iteration(state, **kw)
    assert bool(got[3]) and bool(want[3])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.view(torch.int32) if g.is_floating_point()
                                                  else g, w.view(torch.int32)
                                                  if w.is_floating_point() else w)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    (kcsc, vals, starts, offsets, pc), kw = case("ragged", torch.int32)
    args = [kcsc, vals, starts, offsets, pc]
    bad = {
        0: (kcsc.to(torch.int16), TypeError),
        1: (vals.double(), TypeError),
        2: (starts.long(), TypeError),
        3: (offsets.int(), TypeError),
        4: (pc.int(), TypeError),
    }
    for i, (x, err) in bad.items():
        with pytest.raises(err):
            le.loop_expand(*args[:i], x, *args[i + 1:], **kw)
    lengths = {0: kcsc[:-1], 1: vals[:-1], 2: starts[:-1], 3: offsets[:-1], 4: pc.reshape(1)}
    for i, x in lengths.items():
        with pytest.raises(ValueError):
            le.loop_expand(*args[:i], x, *args[i + 1:], **kw)
    strided = {0: torch.stack([kcsc, kcsc], 1)[:, 0], 1: torch.stack([vals, vals], 1)[:, 0],
               3: torch.stack([offsets, offsets], 1)[:, 0]}
    for i, x in strided.items():
        assert not x.is_contiguous()
        with pytest.raises(ValueError, match="contiguous"):
            le.loop_expand(*args[:i], x, *args[i + 1:], **kw)
    for bad_kw in (dict(kw, m=0), dict(kw, p_pad=2**31), dict(kw, m=kw["m"] + 1)):
        with pytest.raises(ValueError):
            le.loop_expand(*args, **bad_kw)


@pytest.mark.parametrize("m", [1, 2, 3, 1000, 30011, 65536, 70001, 524288, 2**31 - 1])
def test_divider_is_exact_below_2_63(m):
    """The kernel's division by m: (u·magic) >> shift == u // m for keys
    up to 2⁶³ − 1, the 64-bit arithmetic of ``div_m`` written out."""
    magic, shift = le.divider(m)
    assert 0 < magic < 2**64 and 63 <= shift <= 94
    rng = np.random.default_rng(m)
    us = [0, 1, m - 1, m, m + 1, m * m - 1, 2**32 - 1, 2**62, 2**63 - 1]
    us += [int(x) for x in rng.integers(0, 2**63 - 1, 500, dtype=np.int64)]
    for u in us:
        hi = (u * magic) >> 64
        q = hi >> (shift - 64) if shift >= 64 else (
            ((hi << (64 - shift)) | ((u * magic) % 2**64 >> shift)) % 2**64)
        assert q == u // m, (u, m)


# ---- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_bit_equal_to_plain(cuda, name, dtype):
    args, kw = case(name, dtype)
    want = le.loop_expand_plain(*args, **kw)
    kernel = le.KERNEL_64 if dtype == torch.int64 else le.KERNEL
    before = kernel.launches
    got = [x.cpu() for x in le.loop_expand(*(x.to(cuda) for x in args), **kw)]
    assert kernel.launches == before + 1
    assert got[0].dtype == dtype and torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.cuda
def test_kernel_writes_only_sentinels_without_products(cuda):
    for dtype in (torch.int32, torch.int64):
        (kcsc, vals, starts, offsets, _), kw = case("straddle", dtype)
        zero = torch.zeros((), dtype=torch.int64, device=cuda)
        key, val = le.loop_expand(kcsc.to(cuda), vals.to(cuda), starts.to(cuda),
                                  offsets.to(cuda), zero, **kw)
        assert bool((key == chain._sentinel(dtype)).all()) and not bool(val.view(torch.int32).any())


@pytest.mark.cuda
def test_mcl_run_launches_the_kernel_once_a_loop_iteration(cuda, tmp_path, monkeypatch):
    from outerspace_tpu_torch.ops import graph

    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(tmp_path / "c.json"))
    flow = graph._mcl_setup(rmat(10, edge_factor=8, seed=11))
    want = graph.mcl_run(graph.mcl_prepare(flow, iters=4, device="cpu")).to_csr()
    prep = graph.mcl_prepare(flow, iters=4, device=cuda)
    for _ in range(3):
        before = (le.KERNEL.launches, le.KERNEL_64.launches)
        got = graph.mcl_run(prep).to_csr()
        assert (le.KERNEL.launches, le.KERNEL_64.launches) == (before[0] + 3, before[1])
        assert got.nnz == want.nnz
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, want.data, rtol=5e-4, atol=1e-5)
