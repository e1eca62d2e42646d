"""The port's native planner core (``csrc/gplan.cpp``, built with g++ at
first use) against the Python loops that define it: bit-equal subtile
cuts, group packing and whole gather plans."""

import functools

import numpy as np
import pytest

import outerspace_tpu_torch.ops.gather_pipeline as tgp
from outerspace_tpu_torch.formats import erdos_renyi, rmat
from outerspace_tpu_torch.runtime import build
from outerspace_tpu_torch.sched import gplanner


def loop_planner(monkeypatch):
    monkeypatch.setattr(gplanner, "_cut_subtiles", gplanner._cut_subtiles_loop)
    monkeypatch.setattr(gplanner, "_pack_groups", gplanner._pack_groups_loop)


def assert_plans_equal(pn, pp):
    assert len(pn.parts) == len(pp.parts)
    for qa, qb in zip(pn.parts, pp.parts):
        assert (qa.merge_pad, qa.ngroups, qa.call_bits, qa.p_out, qa.p_real) == (
            qb.merge_pad, qb.ngroups, qb.call_bits, qb.p_out, qb.p_real
        )
        assert qa.dev.keys() == qb.dev.keys()
        for k in qa.dev:
            np.testing.assert_array_equal(qa.dev[k].numpy(), qb.dev[k].numpy(), err_msg=k)


PLANS = {
    "rmat11": lambda: (rmat(11, edge_factor=8, seed=2),) * 2,
    "er_wide": lambda: (erdos_renyi(300, 260, 0.05, seed=9), erdos_renyi(260, 900, 0.2, seed=10)),
}


def native_and_loop_plans(a, b, monkeypatch, **split):
    if split:
        monkeypatch.setattr(tgp, "row_partition",
                            functools.partial(gplanner.row_partition, **split))
    a_csc, b_csr = a.to_csc(), b.to_csr()
    pn = tgp.plan_spgemm_gather(a_csc, b_csr, device="cpu")
    with monkeypatch.context() as mp:
        loop_planner(mp)
        pp = tgp.plan_spgemm_gather(a_csc, b_csr, device="cpu")
    return pn, pp


@pytest.mark.parametrize("name", sorted(PLANS))
def test_native_plans_equal_the_loops(name, monkeypatch):
    pn, pp = native_and_loop_plans(*PLANS[name](), monkeypatch)
    assert pn.parts
    assert_plans_equal(pn, pp)


def test_native_plans_equal_the_loops_zoo(operand_pair, monkeypatch):
    from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays

    a, b = operand_pair
    a_csc, b_csr = a.to_csc(), b.to_csr()
    ta = csc_from_arrays(a_csc.shape, a_csc.indptr, a_csc.indices, a_csc.data)
    tb = csr_from_arrays(b_csr.shape, b_csr.indptr, b_csr.indices, b_csr.data)
    assert_plans_equal(*native_and_loop_plans(ta.to_coo(), tb.to_coo(), monkeypatch))


def test_native_plans_equal_the_loops_multipart(monkeypatch):
    pn, pp = native_and_loop_plans(rmat(10, edge_factor=8, seed=1), rmat(10, edge_factor=8, seed=1),
                                   monkeypatch, key_space=200_000)
    assert len(pn.parts) > 1
    assert_plans_equal(pn, pp)


def random_ranges(seed, b_win=3, nk=3000):
    """Monotone element ranges as the planner hands them over: jb and
    jend non-decreasing, rows that fit a window (up to (b_win-1)·128),
    gaps between rows and runs of one k repeated."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(1, (b_win - 1) * 128 + 1, size=nk)
    jb = np.cumsum(np.concatenate([[0], nb[:-1]])) + np.cumsum(rng.integers(0, 40, size=nk))
    # same-k repeats restart at the k's jb
    rep = rng.random(nk) < 0.3
    rep[0] = False
    for i in np.nonzero(rep)[0]:
        jb[i], nb[i] = jb[i - 1], nb[i - 1]
    jb = np.maximum.accumulate(jb)
    cum = np.zeros(nk + 1, np.int64)
    np.cumsum(nb, out=cum[1:])
    return cum, jb.astype(np.int64), (jb + nb).astype(np.int64)


@pytest.mark.parametrize("b_win", [3, 5, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_cut_subtiles_and_pack_groups_equal_the_loops(seed, b_win):
    cum, jb, jend = random_ranges(seed, b_win)
    got = gplanner._cut_subtiles(cum, jb, jend, b_win)
    want = gplanner._cut_subtiles_loop(cum, jb, jend, b_win)
    assert len(got[0]) > 100
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    p0, owners, b_anchor = got
    a_blk = owners // 128
    assert gplanner._pack_groups(a_blk, b_anchor, b_win) == gplanner._pack_groups_loop(
        a_blk, b_anchor, b_win)
    assert gplanner._pack_groups(a_blk[:0], b_anchor[:0], b_win) == []


def test_capacity_overflow_cuts_by_the_loop(monkeypatch):
    # the core returns -1 when a plan overflows its output capacity: the
    # loop cuts that plan (a property of the plan, not a failed build)
    cum, jb, jend = random_ranges(2)
    lib = gplanner._gplan_library()

    class Full:
        osp_pack_groups = lib.osp_pack_groups

        @staticmethod
        def osp_plan_subtiles(*args):
            return -1

    monkeypatch.setattr(gplanner, "_gplan_library", lambda: Full)
    calls = []
    loop = gplanner._cut_subtiles_loop
    monkeypatch.setattr(gplanner, "_cut_subtiles_loop", lambda *a: calls.append(1) or loop(*a))
    got = gplanner._cut_subtiles(cum, jb, jend, 3)
    assert calls == [1]
    for g, w in zip(got, loop(cum, jb, jend, 3)):
        np.testing.assert_array_equal(g, w)


def test_core_is_built_from_the_port_into_build(tmp_path, monkeypatch):
    path = build.build_host("gplan")
    assert path == build.host_library_path("gplan") and path.exists()
    assert path.parent == build.BUILD_DIR and path.name.startswith("libgplan-")
    assert (build.CSRC / "gplan.cpp").read_text().count('extern "C" {') == 1
    # a source that does not compile raises with the compiler's output
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "bad.cpp").write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on bad.cpp:\n.*error"):
        build.build_host("bad")
    assert not build.host_library_path("bad").exists()
