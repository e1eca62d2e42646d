"""K1's plain version vs the JAX package's Pallas windowed-gather expand
(``expand_gather_packed``, interpret mode), stream for stream.

The port and the JAX package build identical plans (tests/test_torch_plans.py),
so keys and values must be bit-equal: the kernel has no reduction.
"""

import functools

import numpy as np
import pytest
import torch

import outerspace_tpu.ops.gather_pipeline as jgp
import outerspace_tpu_torch.ops.gather_pipeline as tgp
from outerspace_tpu.formats import erdos_renyi
from outerspace_tpu.ops.pallas.gexpand import expand_gather_packed
from outerspace_tpu.sched import gplanner as jplanner
from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays
from outerspace_tpu_torch.ops.kernels.gexpand import (
    expand_gather,
    expand_gather_plain,
    group_search_bits,
)
from outerspace_tpu_torch.sched import gplanner as tplanner


def both_plans(a, b, key_space=None, monkeypatch=None):
    a_csc, b_csr = a.to_csc(), b.to_csr()
    if key_space is not None:
        monkeypatch.setattr(
            jgp, "row_partition",
            lambda x, y: jplanner.row_partition(x, y, key_space=key_space),
        )
        monkeypatch.setattr(
            tgp, "row_partition",
            functools.partial(tplanner.row_partition, key_space=key_space),
        )
    jp = jgp.plan_spgemm_gather(a_csc, b_csr)
    tp = tgp.plan_spgemm_gather(
        csc_from_arrays(a_csc.shape, a_csc.indptr, a_csc.indices, a_csc.data),
        csr_from_arrays(b_csr.shape, b_csr.indptr, b_csr.indices, b_csr.data),
        device="cpu",
    )
    assert len(jp.parts) == len(tp.parts)
    return jp, tp


def jax_stream(part, call_bits):
    """The Pallas kernel over a part, one call per slab as the JAX
    pipeline runs it."""
    layout = jplanner.group_slab_layout(part.ngroups)
    keys, vals = [], []
    for (g0, size), bits in zip(layout, call_bits):
        k, v = expand_gather_packed(
            part.dev["bases"][g0 * 2:(g0 + size) * 2],
            part.dev["table"][g0:g0 + size],
            part.dev["a_pack"], part.dev["b_pack"],
            ngroups=size, b_win=part.b_win, search_bits=bits, interpret=True,
        )
        keys.append(np.asarray(k))
        vals.append(np.asarray(v))
    return np.concatenate(keys), np.concatenate(vals)


def port_stream(part, call_bits):
    d = part.dev
    group_bits = d["group_bits"]
    if call_bits != part.call_bits:
        group_bits = torch.from_numpy(group_search_bits(call_bits, part.ngroups))
    k, v = expand_gather(
        d["bases"], d["table"], d["a_pack"], d["b_pack"], group_bits, b_win=part.b_win
    )
    return k.numpy(), v.numpy()


def assert_streams_equal(jp, tp, depth=None):
    for pj, pt in zip(jp.parts, tp.parts):
        bits = pj.call_bits if depth is None else (depth,) * len(pj.call_bits)
        kj, vj = jax_stream(pj, bits)
        kt, vt = port_stream(pt, bits)
        np.testing.assert_array_equal(kt, kj)
        np.testing.assert_array_equal(vt.view(np.int32), vj.view(np.int32))
        live = int(np.sum(kt != np.int32(2**31 - 1)))
        if depth is None:
            assert live == pt.p_real


def test_k1_plain_matches_pallas_zoo(operand_pair):
    a, b = operand_pair
    jp, tp = both_plans(a, b)
    assert all(p.b_win == tplanner.B_WIN for p in tp.parts)
    assert_streams_equal(jp, tp)


CASES = {
    # wide B rows: few owners per subtile, so the plan emits shallow depths
    "wide_rows": lambda: (erdos_renyi(40, 64, 0.1, seed=7), erdos_renyi(64, 900, 0.2, seed=8), None),
    # forced row split: per-part compacted B, the wide window (b_win 5)
    "multipart": lambda: (erdos_renyi(300, 260, 0.02, seed=44), None, 12_000),
    # m·n ≥ 2³¹: biased keys span the whole int32 range
    "keys_2e31": lambda: (erdos_renyi(50_000, 50_000, 4e-6, seed=45), None, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_k1_plain_matches_pallas_cases(name, monkeypatch):
    a, b, key_space = CASES[name]()
    b = a.transpose() if b is None else b
    jp, tp = both_plans(a, b, key_space, monkeypatch)
    if name == "wide_rows":
        assert min(min(p.call_bits) for p in tp.parts) < 8
    if name == "multipart":
        assert len(tp.parts) > 1
        assert all(p.b_win == tplanner.WIDE_B_WIN for p in tp.parts)
    assert_streams_equal(jp, tp)


@pytest.mark.parametrize(
    "name,depth",
    # with the plans' own depths above (wide_rows: 4, multipart: 8) this
    # covers depths 4, 6 and 8 at both b_win 3 and b_win 5
    [("wide_rows", 6), ("wide_rows", 8), ("multipart", 4), ("multipart", 6)],
)
def test_k1_plain_matches_pallas_every_depth(name, depth, monkeypatch):
    # One search depth forced on every group: the two must run the same
    # search, so the streams agree even where a shallow depth would not
    # cover a subtile's owner span.
    a, b, key_space = CASES[name]()
    b = a.transpose() if b is None else b
    jp, tp = both_plans(a, b, key_space, monkeypatch)
    assert_streams_equal(jp, tp, depth=depth)


def test_k1_wrapper_checks_inputs():
    g = erdos_renyi(64, 64, 0.08, seed=1)
    _, tp = both_plans(g, g)
    d = tp.parts[0].dev
    args = [d["bases"], d["table"], d["a_pack"], d["b_pack"], d["group_bits"]]
    k, v = expand_gather(*args, b_win=3)
    kp, vp = expand_gather_plain(*args, b_win=3)
    assert k.dtype == torch.int32 and v.dtype == torch.float32
    assert torch.equal(k, kp) and torch.equal(v, vp)
    bad = list(args)
    bad[1] = args[1].long()
    with pytest.raises(TypeError):
        expand_gather(*bad, b_win=3)
    bad = list(args)
    bad[4] = args[4][:-1]
    with pytest.raises(ValueError):
        expand_gather(*bad, b_win=3)
    bad = list(args)
    bad[2] = args[2].transpose(0, 1)
    with pytest.raises(ValueError):
        expand_gather(*bad, b_win=3)
    with pytest.raises(ValueError):
        expand_gather(*[t.to("meta") for t in args], b_win=3)
