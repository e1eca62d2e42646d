"""The prune and compaction after the MCL chain's first squaring
(``outerspace_tpu_torch/ops/kernels/compact.py``): the plain version,
sorted as the chain sorts it, against a numpy statement of the chain's
compaction, against the chain's compaction before the kernel and, where
the JAX package imports, against its ``compact_masked_stream`` with a
cap that bounds nothing, on random merged streams with the survivors
below, at and past ``elem_pad``; ``ok`` at exactly ``elem_pad``
survivors and at one more, for both key widths; and, on the card
(marker ``cuda``; skipped without one), the CUDA kernel bit-equal to the
plain version, its refusal of unaligned streams, and ``mcl_run``
launching it once a run. The file needs neither JAX nor the JAX
package:

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
I64_MAX = 2**63 - 1
TILE = 8192  # the kernel's tile of slots
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


def expected(rows, cols, vals, valid, *, elem_pad):
    """The chain's compaction in numpy: survivors valid & max(v, 0) > thr,
    keys (col·m + row) ^ 2³¹ as int32, sorted, sentinel-padded; ok from
    the total."""
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
    return kp, vp, bool(ok), dict(zip(keys.tolist(), vr[idx].tolist()))


def before_kernel(rows, cols, vals, valid, *, elem_pad):
    """The chain's compaction as ``mcl_whole_traced`` ran it before the
    kernel: the prune and the keys over every slot, then a compaction in
    stream order and a sort. Also returns the keys before the compaction."""
    v_raw = torch.where(valid, torch.clamp(vals, min=0.0), 0.0)
    survive = valid & (v_raw > THR)
    kcsc = torch.where(survive, pack_key_biased(cols, rows, M), I32_MAX)
    ok = survive.sum() <= elem_pad
    return (*chain._sort_pair(*chain._to_front(survive, elem_pad, (kcsc, I32_MAX),
                                               (v_raw, 0.0))), ok), (kcsc, v_raw)


def jax_compaction(kcsc, v_raw, elem_pad):
    """The JAX package's ``compact_masked_stream`` of the masked stream,
    its cap the whole block (no bound), or None where JAX does not
    import (the card's machine)."""
    try:
        import jax.numpy as jnp

        from outerspace_tpu.ops import chain as jc
    except ImportError:
        return None
    v_masked = torch.where(kcsc != I32_MAX, v_raw, 0.0)  # masked slots' values 0
    k, v, ok = jc.compact_masked_stream(jnp.asarray(kcsc.numpy()), jnp.asarray(v_masked.numpy()),
                                        elem_pad, cap=TILE)
    assert bool(ok)  # no block holds more than all of its slots
    return torch.from_numpy(np.array(k)), torch.from_numpy(np.array(v))


def sorted_out(out):
    """(kp, vp, ok) with the ``elem_pad`` slots sorted as the chain sorts
    them."""
    return (*chain._sort_pair(out[0], out[1]), out[2])


L = 5 * TILE + 1234  # a ragged last tile
# name: (seed, valid slots, survivors, edges, elem_pad)
CASES = {
    "below_elem_pad": (1, 9000, 700, False, 1024),
    "exactly_elem_pad": (2, 9000, 1024, False, 1024),
    "one_over_elem_pad": (4, 9000, 1025, False, 1024),
    "over_elem_pad": (3, 9000, 1500, False, 1024),
    "no_survivors": (5, 9000, 0, False, 1024),
    "negative_zero_at_threshold": (6, 9000, 300, True, 1024),
}


def case_stream(name):
    seed, n_valid, n_surv, edges, elem_pad = CASES[name]
    return merged_stream(seed, L, n_valid, n_surv, edges=edges), elem_pad


def tensors(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def check_against_expected(got, arrays, elem_pad):
    kp, vp, ok = (x.cpu() for x in got)
    want_k, want_v, want_ok, by_key = expected(*arrays, elem_pad=elem_pad)
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
    arrays, elem_pad = case_stream(name)
    t = tensors(arrays)
    raw = compact.prune_compact(*t, thr_root=THR, m=M, elem_pad=elem_pad)
    got = sorted_out(raw)
    ok = check_against_expected(got, arrays, elem_pad)
    assert ok == (name not in ("one_over_elem_pad", "over_elem_pad"))
    old, masked = before_kernel(*t, elem_pad=elem_pad)
    assert bool(old[2]) == ok
    if ok:
        assert torch.equal(got[0], old[0])
        assert torch.equal(got[1].view(torch.int32), old[1].view(torch.int32))
        jax_out = jax_compaction(*masked, elem_pad)
        if jax_out is not None:
            assert torch.equal(got[0], jax_out[0])
            assert torch.equal(got[1].view(torch.int32), jax_out[1].view(torch.int32))
    # unsorted: the first elem_pad survivors in stream order, then the sentinel tail
    n_real = int((raw[0] != I32_MAX).sum())
    assert (raw[0][:n_real] != I32_MAX).all() and not raw[1][n_real:].any()
    vr = np.where(arrays[2] < 0, np.float32(0), arrays[2])
    first = np.flatnonzero(arrays[3] & (vr > np.float32(THR)))[:elem_pad]
    np.testing.assert_array_equal(raw[1][:n_real].numpy(), vr[first])


@pytest.mark.parametrize("m", [M, 70_000], ids=["int32", "int64"])
@pytest.mark.parametrize("extra", [0, 1], ids=["exactly_elem_pad", "one_more"])
def test_plain_ok_at_the_elem_pad_boundary(m, extra):
    """``elem_pad`` survivors fit: ``ok`` holds and every one is kept;
    one more does not: ``ok`` is false and the first ``elem_pad`` in
    stream order are kept. Both key widths (m² ≥ 2³² keys int64)."""
    elem_pad = 777
    rng = np.random.default_rng(extra + m)
    slots = 3 * TILE + 5
    pos = np.sort(rng.choice(slots, size=elem_pad + extra + 400, replace=False))
    surv = np.sort(rng.choice(pos, size=elem_pad + extra, replace=False))
    flat = np.sort(rng.choice(m * m, size=pos.size, replace=False))
    rows, cols = np.full(slots, m, np.int32), np.zeros(slots, np.int32)
    rows[pos], cols[pos] = flat // m, flat % m
    vals = np.zeros(slots, np.float32)
    vals[pos] = THR / 2
    vals[surv] = rng.uniform(THR, 1.0, surv.size).astype(np.float32) + np.float32(1e-6)
    valid = np.zeros(slots, bool)
    valid[pos] = True
    kp, vp, ok = compact.prune_compact_plain(*tensors((rows, cols, vals, valid)), thr_root=THR,
                                             m=m, elem_pad=elem_pad)
    wide = m * m >= 2**32
    assert kp.dtype == (torch.int64 if wide else torch.int32) and bool(ok) == (extra == 0)
    take = surv[:elem_pad]
    u = cols[take].astype(np.int64) * m + rows[take]
    want = u if wide else (u ^ 2**31).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(kp.numpy(), want)
    np.testing.assert_array_equal(vp.numpy(), vals[take])


def test_wrapper_checks_its_streams():
    rows, cols, vals, valid = tensors(merged_stream(7, 4096, 100, 10))
    kw = dict(thr_root=THR, m=M, elem_pad=1024)
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
    arrays, elem_pad = case_stream(name)
    t = tensors(arrays, cuda)
    kw = dict(thr_root=THR, m=M, elem_pad=elem_pad)
    before = compact.KERNEL.launches
    raw = compact.prune_compact(*t, **kw)
    plain = sorted_out(compact.prune_compact_plain(*t, **kw))
    got = sorted_out(raw)
    torch.cuda.synchronize()
    assert compact.KERNEL.launches == before + 1
    assert bool(got[2]) == bool(plain[2])
    ok = check_against_expected(got, arrays, elem_pad)
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
    arrays, elem_pad = case_stream("below_elem_pad")
    t = tensors(arrays, cuda)
    kw = dict(thr_root=THR, m=M, elem_pad=elem_pad)
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
