"""The prune and compaction after the MCL chain's first squaring
(``outerspace_tpu_torch/ops/kernels/compact.py``): the plain version,
sorted as the chain sorts it, against a numpy statement of the chain's
compaction and against the chain's compaction before the kernel on
random merged streams, and, on the card (marker ``cuda``; skipped
without one), the CUDA kernel bit-equal to the plain version, its
refusal of unaligned streams, and ``mcl_run`` launching it once a run.
This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_prune_compact.py
"""

import numpy as np
import pytest
import torch

from outerspace_tpu_torch.formats import rmat
from outerspace_tpu_torch.ops import chain
from outerspace_tpu_torch.ops.kernels import compact
from outerspace_tpu_torch.ops.spgemm import pack_key_biased

I32_MAX = 2**31 - 1
CAP_BLOCK = 8192
M = 3000
THR = float(np.float32(1e-2))


def merged_stream(seed, L, n_valid, n_surv, *, edges=False):
    """A random merged stream as K2 leaves it: row-major (row, col)
    unique over the valid slots, which lie anywhere in the stream;
    ``n_surv`` valid values above ``THR``, the other valid ones in
    [0, THR); invalid slots hold row ``M``, column 0 and random values.
    ``edges``: some valid values negative, zero or exactly ``THR``."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(L, size=n_valid, replace=False))
    flat = np.sort(rng.choice(M * M, size=n_valid, replace=False))
    rows = np.full(L, M, np.int32)
    cols = np.zeros(L, np.int32)
    rows[pos], cols[pos] = flat // M, flat % M
    vals = rng.uniform(-1.0, 2.0, L).astype(np.float32)  # invalid slots: anything
    v = rng.uniform(0.0, THR, n_valid).astype(np.float32)
    live = rng.choice(n_valid, size=n_surv, replace=False)
    v[live] = rng.uniform(THR, 1.0, n_surv).astype(np.float32) + np.float32(1e-6)
    if edges:
        dead = np.setdiff1d(np.arange(n_valid), live)
        k = len(dead) // 4
        v[dead[:k]] = -rng.uniform(0.0, 1.0, k).astype(np.float32)
        v[dead[k:2 * k]] = 0.0
        v[dead[2 * k:2 * k + 8]] = -0.0
        v[dead[2 * k + 8:3 * k]] = THR
    vals[pos] = v
    valid = np.zeros(L, bool)
    valid[pos] = True
    return rows, cols, vals, valid


def expected(rows, cols, vals, valid, *, elem_pad, cap):
    """The chain's compaction in numpy: survivors valid & max(v, 0) > thr,
    keys (col·m + row) ^ 2³¹ as int32, sorted, sentinel-padded; ok from
    the total and the per-block counts."""
    vr = np.where(vals < 0, np.float32(0), vals)
    surv = valid & (vr > np.float32(THR))
    idx = np.flatnonzero(surv)
    u = cols[idx].astype(np.uint64) * np.uint64(M) + rows[idx].astype(np.uint64)
    keys = (u ^ np.uint64(2**31)).astype(np.uint32).view(np.int32)
    order = np.argsort(keys)
    kp = np.full(elem_pad, I32_MAX, np.int32)
    vp = np.zeros(elem_pad, np.float32)
    take = min(len(idx), elem_pad)
    kp[:take], vp[:take] = keys[order][:take], vr[idx][order][:take]
    ok = len(idx) <= elem_pad
    if cap:
        ok &= np.bincount(idx // CAP_BLOCK, minlength=1).max(initial=0) <= cap
    return kp, vp, bool(ok), dict(zip(keys.tolist(), vr[idx].tolist()))


def before_kernel(rows, cols, vals, valid, *, elem_pad, cap):
    """The chain's compaction as ``mcl_whole_traced`` ran it before the
    kernel: the prune and the keys over every slot, then the blocked
    compaction with a cap, else a compaction in stream order, and a
    sort."""
    v_raw = torch.where(valid, torch.clamp(vals, min=0.0), 0.0)
    survive = valid & (v_raw > THR)
    kcsc = torch.where(survive, pack_key_biased(cols, rows, M), I32_MAX)
    ok = survive.sum() <= elem_pad
    if cap:
        kp, vp, ok_cap = chain.compact_masked_stream(kcsc, v_raw, elem_pad, cap=cap)
        return kp, vp, ok & ok_cap
    return (*chain._sort_pair(*chain._to_front(survive, elem_pad, (kcsc, I32_MAX),
                                               (v_raw, 0.0))), ok)


def sorted_out(out):
    """(kp, vp, ok) with the ``elem_pad`` slots sorted as the chain sorts
    them."""
    return (*chain._sort_pair(out[0], out[1]), out[2])


def block_counts(valid, vals):
    surv = valid & (np.where(vals < 0, 0, vals) > np.float32(THR))
    return np.bincount(np.flatnonzero(surv) // CAP_BLOCK, minlength=1)


L = 5 * CAP_BLOCK + 1234  # a ragged last block
# name: (seed, valid slots, survivors, edges, elem_pad, cap: None for the
# stream's own block maximum, "-1" for one less, which one block exceeds,
# else the number)
CASES = {
    "cap_ok": (1, 9000, 700, False, 1024, None),
    "cap_exceeded_by_one_block": (2, 9000, 700, False, 1024, "-1"),
    "over_elem_pad": (3, 9000, 1500, False, 1024, 0),
    "no_cap": (4, 9000, 700, False, 1024, 0),
    "no_survivors": (5, 9000, 0, False, 1024, 0),
    "negative_zero_at_threshold": (6, 9000, 300, True, 1024, None),
}


def case_stream(name):
    seed, n_valid, n_surv, edges, elem_pad, cap = CASES[name]
    rows, cols, vals, valid = merged_stream(seed, L, n_valid, n_surv, edges=edges)
    counts = block_counts(valid, vals)
    if cap is None:
        cap = int(counts.max())
    elif cap == "-1":
        cap = int(counts.max()) - 1
        assert (counts > cap).sum() == 1
    return (rows, cols, vals, valid), elem_pad, cap


def tensors(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def check_against_expected(got, arrays, elem_pad, cap):
    kp, vp, ok = (x.cpu() for x in got)
    want_k, want_v, want_ok, by_key = expected(*arrays, elem_pad=elem_pad, cap=cap)
    assert kp.shape == (elem_pad,) and vp.shape == (elem_pad,)  # nothing past elem_pad
    assert ok.dim() == 0 and bool(ok) == want_ok
    if want_ok:
        np.testing.assert_array_equal(kp.numpy(), want_k)
        np.testing.assert_array_equal(vp.numpy().view(np.int32), want_v.view(np.int32))
    else:  # unused by the chain; still only survivors, each with its value
        real = kp.numpy() != I32_MAX
        keys = kp.numpy()[real].tolist()
        assert len(set(keys)) == len(keys) and set(keys) <= set(by_key)
        np.testing.assert_array_equal(vp.numpy()[real], np.float32([by_key[k] for k in keys]))
        assert real.sum() == min(len(by_key), elem_pad)
    return want_ok


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_the_chains_compaction(name):
    arrays, elem_pad, cap = case_stream(name)
    t = tensors(arrays)
    raw = compact.prune_compact(*t, thr_root=THR, m=M, elem_pad=elem_pad, cap=cap)
    got = sorted_out(raw)
    ok = check_against_expected(got, arrays, elem_pad, cap)
    assert ok == (name not in ("cap_exceeded_by_one_block", "over_elem_pad"))
    old = before_kernel(*t, elem_pad=elem_pad, cap=cap)
    assert bool(old[2]) == ok
    if ok:
        assert torch.equal(got[0], old[0])
        assert torch.equal(got[1].view(torch.int32), old[1].view(torch.int32))
    # unsorted: the first elem_pad survivors in stream order, then the sentinel tail
    n_real = int((raw[0] != I32_MAX).sum())
    assert (raw[0][:n_real] != I32_MAX).all() and not raw[1][n_real:].any()
    vr = np.where(arrays[2] < 0, np.float32(0), arrays[2])
    first = np.flatnonzero(arrays[3] & (vr > np.float32(THR)))[:elem_pad]
    np.testing.assert_array_equal(raw[1][:n_real].numpy(), vr[first])


def test_wrapper_checks_its_streams():
    rows, cols, vals, valid = tensors(merged_stream(7, 4096, 100, 10))
    kw = dict(thr_root=THR, m=M, elem_pad=1024, cap=0)
    with pytest.raises(TypeError):
        compact.prune_compact(rows.long(), cols, vals, valid, **kw)
    with pytest.raises(TypeError):
        compact.prune_compact(rows, cols, vals, valid.to(torch.uint8), **kw)
    with pytest.raises(ValueError):
        compact.prune_compact(rows[:-1], cols, vals, valid, **kw)
    with pytest.raises(ValueError):
        compact.prune_compact(rows[::2], cols[::2], vals[::2], valid[::2], **kw)
    with pytest.raises(ValueError):  # CPU tensors run the plain version, CUDA the kernel
        compact.prune_compact(*(x.to("meta") for x in (rows, cols, vals, valid)), **kw)


# ---- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_bit_equal_to_plain(cuda, name):
    """The kernel against the plain version on the same stream, on the
    card, each sorted as the chain sorts it."""
    arrays, elem_pad, cap = case_stream(name)
    t = tensors(arrays, cuda)
    kw = dict(thr_root=THR, m=M, elem_pad=elem_pad, cap=cap)
    before = compact.KERNEL.launches
    raw = compact.prune_compact(*t, **kw)
    plain = sorted_out(compact.prune_compact_plain(*t, **kw))
    got = sorted_out(raw)
    torch.cuda.synchronize()
    assert compact.KERNEL.launches == before + 1
    assert bool(got[2]) == bool(plain[2])
    ok = check_against_expected(got, arrays, elem_pad, cap)
    if ok:
        assert torch.equal(got[0], plain[0])
        assert torch.equal(got[1].view(torch.int32), plain[1].view(torch.int32))
    # unsorted: the survivors first, then the sentinel tail
    real = (raw[0] != I32_MAX).cpu().numpy()
    n_real = int(real.sum())
    assert real[:n_real].all() and not real[n_real:].any()
    assert not raw[1][n_real:].any()


@pytest.mark.cuda
def test_kernel_refuses_unaligned_streams(cuda):
    """vals must start 16-byte and valid 4-byte aligned (the kernel's
    vector loads); the wrapper raises before any launch."""
    arrays, elem_pad, cap = case_stream("no_cap")
    t = tensors(arrays, cuda)
    kw = dict(thr_root=THR, m=M, elem_pad=elem_pad, cap=cap)
    before = compact.KERNEL.launches
    for offset in (1, 2, 3):
        with pytest.raises(ValueError, match="aligned"):
            compact.prune_compact(*(x[offset:] for x in t), **kw)
    assert compact.KERNEL.launches == before
    compact.prune_compact(*(x[4:] for x in t), **kw)  # vals 16-byte, valid 4-byte aligned
    assert compact.KERNEL.launches == before + 1


@pytest.mark.cuda
def test_mcl_run_launches_the_kernel_once_a_run(cuda, tmp_path, monkeypatch):
    from outerspace_tpu_torch.ops import graph

    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(tmp_path / "c.json"))
    flow = graph._mcl_setup(rmat(10, edge_factor=8, seed=11))
    want = graph.mcl_run(graph.mcl_prepare(flow, iters=4, device="cpu")).to_csr()
    prep = graph.mcl_prepare(flow, iters=4, device=cuda)
    for _ in range(3):
        before = compact.KERNEL.launches
        got = graph.mcl_run(prep).to_csr()
        assert compact.KERNEL.launches == before + 1
        assert got.nnz == want.nnz
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, want.data, rtol=5e-4, atol=1e-5)
