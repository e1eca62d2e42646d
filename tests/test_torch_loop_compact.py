"""The prune and in-order compaction of each MCL loop squaring
(``ops/kernels/compact.py:loop_compact``): on the CPU, the plain version
against the compaction it replaced in ``_mcl_iteration`` (the prune, then
``_to_front``) and against a numpy statement of it, on sorted, K2-merged
streams of both key widths with the survivors below, at, one past and far
past ``elem_pad``, none and all; a whole ``_mcl_iteration`` through the
wrapper against the inline compaction; the wrapper's refusals. On the
card (marker ``cuda``; skipped without one): the CUDA kernel bit-equal
to its plain version on streams of thousands of tiles, with no survivor,
with every slot surviving and with a ragged end, the same over two
launches; its refusal of unaligned streams; ``mcl_run`` launching it once
a loop iteration. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_loop_compact.py
"""

import numpy as np
import pytest
import torch

from outerspace_tpu_torch.formats import rmat
from outerspace_tpu_torch.ops import chain
from outerspace_tpu_torch.ops.kernels import compact
from outerspace_tpu_torch.ops.spgemm import merge_epilogue

TILE = compact.TILE
M32, M64 = 30011, 70001  # 70001² ≥ 2³²
THR = float(np.float32(1e-2))


def sentinel(dtype):
    return chain._sentinel(dtype)


def merged_stream(seed, dtype, *, products=40_000, runs=9_000, tail=3 * TILE + 77,
                  live=0.3, dead=False):
    """A loop squaring's merged stream as ``_mcl_iteration`` hands it on:
    ``products`` product keys over ``runs`` distinct (col, row) of an
    m×m flow (m = M32 or M64 by ``dtype``), then ``tail`` sentinels,
    sorted, summed by K2 (``merge_epilogue`` with the stream length as
    ``pad_count``). Values: a share ``live`` of the products lie in
    [THR, 1), the others in [−THR, THR); ``dead``: every value at most 0.
    Then some merged values are set to THR, 0, −0, negative and NaN."""
    rng = np.random.default_rng(seed)
    m = M32 if dtype == torch.int32 else M64
    flat = rng.choice(m * m, size=runs, replace=False).astype(np.int64)
    key = flat[rng.integers(0, runs, products)]
    vals = rng.uniform(-THR, THR, products).astype(np.float32)
    if dead:
        vals = -np.abs(vals)
    else:
        up = rng.random(products) < live
        vals[up] = rng.uniform(THR, 1.0, int(up.sum())).astype(np.float32)
    kt = torch.from_numpy(key if dtype == torch.int64 else (key - 2**31).astype(np.int32))
    kt = torch.cat([kt, torch.full((tail,), sentinel(dtype), dtype=dtype)])
    vt = torch.cat([torch.from_numpy(vals), torch.zeros(tail)])
    key_s, order = torch.sort(kt)
    _, _, v2, valid2, _ = merge_epilogue(key_s, vt[order], m, m, key_s.shape[0])
    if not live == 1.0:
        edge = torch.from_numpy(rng.permutation(np.flatnonzero(valid2.numpy()))[:250])
        for i, x in enumerate((THR, 0.0, -0.0, -0.5, float("nan"))):
            v2[edge[i::5]] = x
    return key_s, v2, valid2


def survivors(v2, valid2):
    return int((valid2 & (torch.clamp(v2, min=0.0) > THR)).sum())


def before(key_s, v2, valid2, *, thr_root, elem_pad):
    """The compaction as ``_mcl_iteration`` ran it inline before the
    kernel: the prune, the survivors' sum, then ``_to_front``."""
    sent = chain._sentinel(key_s.dtype)
    v2r = torch.where(valid2, torch.clamp(v2, min=0.0), 0.0)
    survive = valid2 & (v2r > thr_root)
    ok = survive.sum() <= elem_pad
    k_next, vp_next = chain._to_front(survive, elem_pad, (key_s, sent), (v2r, 0.0))
    return k_next, vp_next, ok


def in_numpy(key_s, v2, valid2, *, thr_root, elem_pad):
    """The same in numpy: the first ``elem_pad`` survivors in stream
    order, their keys and max(v, 0), then (the sentinel, 0)."""
    key, v, valid = key_s.numpy(), v2.numpy(), valid2.numpy()
    r = np.where(v < 0, np.float32(0), v)
    idx = np.flatnonzero(valid & (r > np.float32(thr_root)))
    take = idx[:elem_pad]
    kp = np.full(elem_pad, sentinel(key_s.dtype), key.dtype)
    vp = np.zeros(elem_pad, np.float32)
    kp[:take.size], vp[:take.size] = key[take], r[take]
    return kp, vp, idx.size <= elem_pad


def assert_bit_equal(got, want):
    assert got[0].dtype == want[0].dtype and torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert got[2].dim() == 0 and bool(got[2]) == bool(want[2])


# name: (merged_stream keywords, elem_pad from the survivors S)
CASES = {
    "below_elem_pad": ({}, lambda s: s + 500),
    "exactly_elem_pad": ({}, lambda s: s),
    "one_past_elem_pad": ({}, lambda s: s - 1),
    "far_past_elem_pad": ({}, lambda s: s // 3),
    "no_survivors": (dict(dead=True), lambda s: 4096),
    "all_valid_survive": (dict(live=1.0, tail=0), lambda s: s),
}


def case(name, dtype):
    kw, pad = CASES[name]
    stream = merged_stream(len(name) + 17 * (dtype == torch.int64), dtype, **kw)
    return stream, pad(survivors(*stream[1:]))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_the_compaction_it_replaced(name, dtype):
    (key_s, v2, valid2), elem_pad = case(name, dtype)
    s = survivors(v2, valid2)
    assert (s == 0) == (name == "no_survivors")
    if name == "all_valid_survive":
        assert s == int(valid2.sum())
    kw = dict(thr_root=THR, elem_pad=elem_pad)
    got = compact.loop_compact(key_s, v2, valid2, **kw)
    assert_bit_equal(got, before(key_s, v2, valid2, **kw))
    want = in_numpy(key_s, v2, valid2, **kw)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy().view(np.int32), want[1].view(np.int32))
    assert bool(got[2]) == want[2] == (s <= elem_pad)
    # in order: the kept keys stay sorted, the sentinel tail after them
    kept = got[0][got[0] != sentinel(dtype)]
    assert kept.shape[0] == min(s, elem_pad) and bool((kept[1:] > kept[:-1]).all())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
def test_mcl_iteration_through_the_wrapper_equals_the_inline_compaction(dtype, monkeypatch):
    """A whole iteration, state for state, through the wrapper and
    through the inline compaction it replaced."""
    m = M32 if dtype == torch.int32 else M64
    rng = np.random.default_rng(3)
    flat = np.unique(rng.choice(m * m, size=60_000, replace=False).astype(np.int64))
    kt = torch.from_numpy(flat if dtype == torch.int64 else (flat - 2**31).astype(np.int32))
    kcsc = torch.cat([kt, torch.full((200_000,), sentinel(dtype), dtype=dtype)])
    vals = torch.cat([torch.from_numpy(rng.uniform(0.0, 1.0, flat.size).astype(np.float32)),
                      torch.zeros(200_000)])
    starts = chain._column_starts(kcsc, m)
    state = (kcsc, vals, starts, torch.ones((), dtype=torch.bool))
    kw = dict(p_pad=600_000, elem_pad=kcsc.shape[0], m=m, inflation=2.0, threshold=1e-4)
    got = chain._mcl_iteration(state, **kw)
    monkeypatch.setattr(chain, "loop_compact", before)
    want = chain._mcl_iteration(state, **kw)
    assert bool(got[3]) and bool(want[3])
    assert int((got[0] != sentinel(dtype)).sum()) > 1000
    for g, w in zip(got, want):
        g, w = (x.view(torch.int32) if x.is_floating_point() else x for x in (g, w))
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    key_s, v2, valid2 = merged_stream(7, torch.int64, products=5000, runs=900, tail=100)
    kw = dict(thr_root=THR, elem_pad=1024)
    with pytest.raises(TypeError):
        compact.loop_compact(key_s.to(torch.int16), v2, valid2, **kw)
    with pytest.raises(TypeError):
        compact.loop_compact(key_s, v2.double(), valid2, **kw)
    with pytest.raises(TypeError):
        compact.loop_compact(key_s, v2, valid2.to(torch.uint8), **kw)
    with pytest.raises(ValueError):
        compact.loop_compact(key_s[:-1], v2, valid2, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        compact.loop_compact(key_s[::2], v2[::2], valid2[::2], **kw)
    with pytest.raises(ValueError):
        compact.loop_compact(key_s, v2, valid2, thr_root=THR, elem_pad=2**31)
    with pytest.raises(ValueError):  # CPU tensors run the plain version, CUDA the kernel
        compact.loop_compact(*(x.to("meta") for x in (key_s, v2, valid2)), **kw)


# ---- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def card_stream(seed, dtype, n, *, live, valid_share=0.5, device):
    """A sorted key stream of ``n`` slots with random valid flags and
    values (a share ``live`` of them above THR, some NaN), made on the
    card: the kernel reads keys only by index, so they need not be
    K2's."""
    g = torch.Generator(device=device).manual_seed(seed)
    hi = 2**40 if dtype == torch.int64 else 2**31 - 1
    key = torch.randint(0, hi, (n,), generator=g, device=device, dtype=torch.int64)
    key = torch.sort(key if dtype == torch.int64 else (key - 2**30).to(dtype))[0]
    valid = torch.rand(n, generator=g, device=device) < valid_share
    vals = torch.rand(n, generator=g, device=device) * 2 * THR - THR
    up = torch.rand(n, generator=g, device=device) < live
    vals = torch.where(up, 2 * THR + torch.rand(n, generator=g, device=device), vals)
    vals[torch.rand(n, generator=g, device=device) < 0.001] = float("nan")
    return key, vals, valid


# name: (slots, live share, valid share, elem_pad from the slots n and survivors s)
CARD_CASES = {
    "3000_tiles": (3000 * TILE + 4, 0.05, 0.5, lambda n, s: s + 4096),
    "3000_tiles_past_elem_pad": (3000 * TILE, 0.05, 0.5, lambda n, s: s // 2),
    "no_survivors": (700 * TILE, 0.0, 0.5, lambda n, s: 4096),
    "every_slot_survives": (500 * TILE, 1.0, 1.0, lambda n, s: n),
    "ragged_end": (37 * TILE + 4093, 0.3, 0.5, lambda n, s: s),
    "one_slot": (1, 1.0, 1.0, lambda n, s: 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernel_bit_equal_to_plain(cuda, name, dtype):
    n, live, valid_share, pad = CARD_CASES[name]
    key, vals, valid = card_stream(len(name), dtype, n, live=live, valid_share=valid_share,
                                   device=cuda)
    s = int((valid & (torch.clamp(vals, min=0.0) > THR)).sum())
    if name == "every_slot_survives":  # the NaN slots are the only ones dropped
        assert s == n - int(vals.isnan().sum())
    kw = dict(thr_root=THR, elem_pad=pad(n, s))
    kernel = compact.LOOP_KERNEL_64 if dtype == torch.int64 else compact.LOOP_KERNEL
    before_launches = kernel.launches
    got = compact.loop_compact(key, vals, valid, **kw)
    again = compact.loop_compact(key, vals, valid, **kw)
    want = compact.loop_compact_plain(key, vals, valid, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before_launches + 2
    assert_bit_equal(got, want)
    assert_bit_equal(again, want)
    assert bool(got[2]) == (s <= kw["elem_pad"])


@pytest.mark.cuda
def test_kernel_refuses_unaligned_streams(cuda):
    """vals must start 16-byte and valid 4-byte aligned (the kernel's
    vector loads); the wrapper raises before any launch."""
    key, vals, valid = card_stream(5, torch.int64, 9 * TILE, live=0.1, device=cuda)
    kw = dict(thr_root=THR, elem_pad=4 * TILE)
    before_launches = compact.LOOP_KERNEL_64.launches
    for offset in (1, 2, 3):
        with pytest.raises(ValueError, match="aligned"):
            compact.loop_compact(key[offset:], vals[offset:], valid[offset:], **kw)
    assert compact.LOOP_KERNEL_64.launches == before_launches
    got = compact.loop_compact(key[4:], vals[4:], valid[4:], **kw)  # aligned again
    assert compact.LOOP_KERNEL_64.launches == before_launches + 1
    assert_bit_equal(got, compact.loop_compact_plain(key[4:], vals[4:], valid[4:], **kw))


@pytest.mark.cuda
def test_mcl_run_launches_the_kernel_once_a_loop_iteration(cuda, tmp_path, monkeypatch):
    from outerspace_tpu_torch.ops import graph

    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(tmp_path / "c.json"))
    flow = graph._mcl_setup(rmat(10, edge_factor=8, seed=11))
    want = graph.mcl_run(graph.mcl_prepare(flow, iters=4, device="cpu")).to_csr()
    prep = graph.mcl_prepare(flow, iters=4, device=cuda)
    for _ in range(3):
        before_launches = (compact.LOOP_KERNEL.launches, compact.LOOP_KERNEL_64.launches)
        got = graph.mcl_run(prep).to_csr()
        assert (compact.LOOP_KERNEL.launches, compact.LOOP_KERNEL_64.launches) == (
            before_launches[0] + 3, before_launches[1])
        assert got.nnz == want.nnz
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, want.data, rtol=5e-4, atol=1e-5)
