"""The staged MCL past n² = 2³², where the chain's keys ``col·m + row``
take int64 (``ops.kernels.compact.key_dtype``): on the CPU with the kernels' plain
versions, a community graph of 65,600 vertices through
``markov_cluster`` against scipy's MCL and the benchmark's plain
reference, its fallbacks exact; the 64-bit plain versions of K2 and of
the prune-and-compact kernel against scalar walks; the 32-bit path
unchanged below 2³². On the card (marker ``cuda``; skipped without
one) each 64-bit instantiation bit-equal to its plain version and the
wide chain launching them. This file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_mcl_wide.py
"""

import numpy as np
import pytest
import torch

from benchmark.reference import mcl as ref_mcl
from benchmark.reference.compare import compare_flows
from outerspace_tpu_torch.formats.coo import COO
from outerspace_tpu_torch.ops import chain, graph
from outerspace_tpu_torch.ops.kernels import compact, counters, scan
from outerspace_tpu_torch.perf import timer

I32_MAX = 2**31 - 1
I64_MAX = 2**63 - 1
N_WIDE = 65_600  # n² > 2³²
ITERS = 4
RTOL, ATOL = 5e-4, 1e-5


def community_graph(n, size=5, cross=0.2, seed=1):
    """Cliques of ``size`` vertices and ``cross``·n random edges between
    any two vertices, undirected, weights 1: MCL's flow stays within a
    few vertices of each clique, so the loop's streams stay small."""
    rng = np.random.default_rng(seed)
    a, b = np.meshgrid(np.arange(size), np.arange(size))
    base = (np.arange(n // size) * size)[:, None]
    r, c = (base + a.ravel()).ravel(), (base + b.ravel()).ravel()
    keep = r != c
    cr, cc = rng.integers(0, n, int(cross * n)), rng.integers(0, n, int(cross * n))
    rows = np.concatenate([r[keep], cr, cc]).astype(np.int32)
    cols = np.concatenate([c[keep], cc, cr]).astype(np.int32)
    return COO((n, n), rows, cols, np.ones(rows.shape[0], np.float32)).deduplicated()


@pytest.fixture(autouse=True)
def sizing_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(tmp_path / "sizing.json"))


@pytest.fixture(scope="module")
def wide():
    g = community_graph(N_WIDE)
    return g, graph.markov_cluster(g, iters=ITERS, backend="scipy")


def assert_flows_equal(got, want):
    assert got.shape == want.shape and got.nnz == want.nnz
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=RTOL, atol=ATOL)
    as_sets = lambda f: {tuple(sorted(c.tolist())) for c in graph.mcl_clusters(f)}  # noqa: E731
    assert as_sets(got) == as_sets(want)


def spy_key_dtypes(monkeypatch):
    """The key dtypes K2 and the prune-and-compact step are handed."""
    seen = {"k2": set(), "prune": set()}
    k2, prune = scan.merge_epilogue_plain, compact.prune_compact_plain

    def k2_spy(key, *a, **kw):
        seen["k2"].add(key.dtype)
        return k2(key, *a, **kw)

    def prune_spy(*a, **kw):
        out = prune(*a, **kw)
        seen["prune"].add(out[0].dtype)
        return out

    monkeypatch.setattr(scan, "merge_epilogue_plain", k2_spy)
    monkeypatch.setattr(compact, "prune_compact_plain", prune_spy)
    return seen


def test_key_dtype_from_n_alone():
    assert compact.key_dtype(65_535) == torch.int32  # 65,535² < 2³²
    assert compact.key_dtype(65_536) == torch.int64
    assert compact.key_dtype(N_WIDE) == torch.int64
    assert compact.key_dtype(65_535, 65_537) == torch.int32  # 2³² − 1
    assert compact.key_dtype(65_535, 65_538) == torch.int64
    with pytest.raises(ValueError):
        chain._check_square((N_WIDE, N_WIDE + 1))
    assert chain._check_square((N_WIDE, N_WIDE)) == (N_WIDE, N_WIDE)


def test_wide_staged_chain_equals_scipy_and_the_reference(wide, monkeypatch):
    g, want = wide
    seen = spy_key_dtypes(monkeypatch)
    before = timer.counters()
    report = {}
    got = graph.markov_cluster(g, iters=ITERS, device="cpu", report=report)
    after = timer.counters()
    # the staged chain ran, on its fast path, with 64-bit keys past the first squaring
    for name, step in (("mcl.runs", 1), ("mcl.wide_runs", 1), ("mcl.fallbacks", 0)):
        assert after.get(name, 0) - before.get(name, 0) == step, name
    assert report["fast_path"] and report["stage1_parts"] >= 2
    assert seen["prune"] == {torch.int64} and torch.int64 in seen["k2"]
    assert_flows_equal(got, want)
    # the benchmark's plain reference, over the columns no prune tie touches
    c = g.to_csr()
    flow = ref_mcl.flow_of((c.shape, c.indptr, c.indices, c.data))
    ref, uncertain, _ = ref_mcl.mcl(flow, iters=ITERS, inflation=2.0, threshold=1e-4, band=1e-4)
    r = compare_flows((got.shape, got.indptr, got.indices, got.data), ref, uncertain)
    assert r["struct_mismatch"] == 0 and r["cluster_mismatch"] == 0
    assert r["val_rel_err"] < 1e-4 and r["uncertain_share"] < 0.5


def test_markov_cluster_takes_the_staged_chain_past_2e32(monkeypatch):
    g = community_graph(N_WIDE, cross=0.05, seed=2)
    runs = []
    real = graph.mcl_run
    monkeypatch.setattr(graph, "mcl_run", lambda prep: runs.append(prep["n"]) or real(prep))
    monkeypatch.setattr(graph, "_mcl_inflate_prune",
                        lambda *a: pytest.fail("the host loop ran"))
    graph.markov_cluster(g, iters=2, device="cpu")
    assert runs == [N_WIDE]


def test_wide_run_with_starved_budgets_falls_back_exactly(wide, monkeypatch):
    g, want = wide
    flow = graph._mcl_setup(g)
    prep = graph.mcl_prepare(flow, iters=ITERS, device="cpu")
    # budgets far below the flow's: ok is false, the exact chain runs
    prep.update(p_pad=8192, nnz_pad=1024, elem_pad=4096, p_pads=None)
    prep.pop("flow")
    seen = spy_key_dtypes(monkeypatch)
    before = timer.counters().get("mcl.fallbacks", 0)
    got = graph.mcl_run(prep).to_csr()
    assert timer.counters()["mcl.fallbacks"] == before + 1
    assert prep["p_pad"] == 16384  # doubled for the next run
    assert torch.int64 in seen["k2"]
    assert_flows_equal(got, want)


def test_wide_stepwise_chain_is_exact(wide, monkeypatch):
    """The fused fallback with its own budget starved runs the stepwise
    chain (``square_device``, ``spgemm_from_device_csr``) on int64 keys."""
    g, want = wide
    monkeypatch.setattr(chain, "P_HEADROOM", 1e-3)
    steps = []
    real = chain.square_device
    monkeypatch.setattr(chain, "square_device", lambda m: steps.append(1) or real(m))
    seen = spy_key_dtypes(monkeypatch)
    flow = graph._mcl_setup(g)
    prep = graph.mcl_prepare(flow, iters=ITERS, device="cpu")
    sq = chain._stage1_squaring(prep["tplan"])
    v1, valid1, nnz1 = chain.inflate_device(sq.rows, sq.cols, sq.vals, sq.valid, m=N_WIDE,
                                            inflation=2.0, threshold=1e-4)
    merged = chain.MergedCOO(sq.shape, sq.rows, sq.cols, v1, valid1, nnz1)
    got = chain.markov_cluster_device_fused(merged, inflation=2.0, iters=ITERS - 1,
                                            prune_threshold=1e-4).to_csr()
    assert len(steps) == ITERS - 1 and torch.int64 in seen["k2"]
    assert_flows_equal(got, want)


# ---- the 64-bit plain versions against scalar walks ---------------------------


def k2_wide_stream(n, pad, seed, n_cols=70_001):
    """A sorted int64 key stream of ``n`` slots past 2³² (runs of 1-6
    equal keys, then ``pad`` sentinels); values are multiples of 1/8
    below 8 in magnitude, so every run sum is exact in any order."""
    rng = np.random.default_rng(seed)
    lengths = []
    while sum(lengths) < n - pad:
        lengths.append(int(min(rng.integers(1, 7), n - pad - sum(lengths))))
    coords = np.sort(rng.choice(70_000 * n_cols, size=len(lengths), replace=False)).astype(np.int64)
    coords[-1] = 70_000 * n_cols - 1  # the last real key, far past 2³²
    key = np.concatenate([np.repeat(coords, lengths), np.full(pad, I64_MAX, np.int64)])
    return key, (rng.integers(-63, 64, size=n) / 8).astype(np.float32), n_cols


def k2_scalar_walk(key, vals, n_cols, sentinel_row):
    n = key.shape[0]
    rows, cols = np.full(n, sentinel_row, np.int32), np.zeros(n, np.int32)
    out, valid, run = np.zeros(n, np.float32), np.zeros(n, bool), 0.0
    for i in range(n):
        run = vals[i] if i == 0 or key[i] != key[i - 1] else run + vals[i]
        if (i == n - 1 or key[i + 1] != key[i]) and key[i] != I64_MAX:
            rows[i], cols[i], out[i], valid[i] = key[i] // n_cols, key[i] % n_cols, run, True
    return rows, cols, out, valid, int(valid.sum())


@pytest.mark.parametrize("n,pad,pad_count",
                         [(3000, 40, 40), (3000, 40, 0), (1, 0, 0), (1024, 1, 1)])
def test_k2_plain_64_bit_equals_a_scalar_walk(n, pad, pad_count):
    key, vals, n_cols = k2_wide_stream(n, pad, seed=n + pad_count)
    got = scan.merge_epilogue_plain(torch.from_numpy(key), torch.from_numpy(vals), pad_count,
                                    n_cols=n_cols, sentinel_row=70_000)
    want = k2_scalar_walk(key, vals, n_cols, 70_000)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), w)
    # a sentinel slot is never real in 64 bits, whatever pad_count says
    assert int(got[4]) == want[4] and not got[3][key == I64_MAX].any()
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32


def test_k2_wrapper_takes_int64_and_refuses_other_keys():
    key, vals, n_cols = k2_wide_stream(500, 3, seed=9)
    kt, vt = torch.from_numpy(key), torch.from_numpy(vals)
    got = scan.merge_epilogue_scan(kt, vt, 3, n_cols=n_cols, sentinel_row=70_000)
    want = scan.merge_epilogue_plain(kt, vt, 3, n_cols=n_cols, sentinel_row=70_000)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(TypeError):
        scan.merge_epilogue_scan(kt.to(torch.int16), vt, 3, n_cols=n_cols, sentinel_row=70_000)
    with pytest.raises(ValueError):
        scan.merge_epilogue_scan(kt.to("meta"), vt.to("meta"), 3, n_cols=n_cols,
                                 sentinel_row=70_000)


M_WIDE = 70_000
THR = float(np.float32(1e-2))


def prune_stream(seed, L, n_valid, n_surv, m=M_WIDE):
    """A merged stream as K2 leaves it (unique row-major (row, col) over
    the valid slots, anywhere in the stream), ``n_surv`` valid values
    above ``THR``, some valid ones negative or zero, on an m×m flow."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(L, size=n_valid, replace=False))
    flat = np.sort(rng.choice(m * m, size=n_valid, replace=False))
    rows, cols = np.full(L, m, np.int32), np.zeros(L, np.int32)
    rows[pos], cols[pos] = flat // m, flat % m
    vals = rng.uniform(-1.0, 2.0, L).astype(np.float32)
    v = rng.uniform(-THR, THR, n_valid).astype(np.float32)
    live = rng.choice(n_valid, size=n_surv, replace=False)
    v[live] = rng.uniform(THR, 1.0, n_surv).astype(np.float32) + np.float32(1e-6)
    vals[pos] = v
    valid = np.zeros(L, bool)
    valid[pos] = True
    return rows, cols, vals, valid


def prune_scalar_walk(rows, cols, vals, valid, *, m, elem_pad):
    keys, vs = [], []
    for i in range(rows.shape[0]):
        r = max(float(vals[i]), 0.0)
        if valid[i] and np.float32(r) > np.float32(THR):
            keys.append(int(cols[i]) * m + int(rows[i]))
            vs.append(np.float32(r))
    kp = np.full(elem_pad, I64_MAX, np.int64)
    vp = np.zeros(elem_pad, np.float32)
    kp[:min(len(keys), elem_pad)] = keys[:elem_pad]
    vp[:min(len(vs), elem_pad)] = vs[:elem_pad]
    return kp, vp, len(keys) <= elem_pad


# (elem_pad, ok) around the stream's 1,200 survivors
BOUNDARIES = [(4096, True), (1000, False), (1200, True), (1199, False)]
TILE = 8192  # the kernel's tile of slots


@pytest.mark.parametrize("elem_pad,ok", BOUNDARIES)
def test_prune_compact_plain_64_bit_equals_a_scalar_walk(elem_pad, ok):
    arrays = prune_stream(3, 3 * TILE + 77, 3000, 1200)
    t = [torch.from_numpy(a) for a in arrays]
    kp, vp, got_ok = compact.prune_compact(*t, thr_root=THR, m=M_WIDE, elem_pad=elem_pad)
    want = prune_scalar_walk(*arrays, m=M_WIDE, elem_pad=elem_pad)
    assert kp.dtype == torch.int64 and bool(got_ok) == want[2] == ok
    np.testing.assert_array_equal(kp.numpy(), want[0])
    np.testing.assert_array_equal(vp.numpy(), want[1])
    assert int(kp[kp != I64_MAX].max()) >= 2**32


@pytest.mark.parametrize("m,dtype", [(3000, torch.int32), (65_535, torch.int32),
                                     (65_536, torch.int64), (M_WIDE, torch.int64)])
def test_prune_compact_keys_take_64_bits_from_m_squared_2e32(m, dtype):
    t = [torch.from_numpy(a) for a in prune_stream(4, 4096, 200, 50, m=m)]
    kp, _, _ = compact.prune_compact(*t, thr_root=THR, m=m, elem_pad=1024)
    assert kp.dtype == dtype == compact.key_dtype(m)
    assert int(kp.max()) == (I64_MAX if dtype == torch.int64 else I32_MAX)


def test_int32_path_unchanged_below_2e32(monkeypatch):
    g = community_graph(4000, seed=3)
    seen = spy_key_dtypes(monkeypatch)
    before = timer.counters()
    got = graph.markov_cluster(g, iters=ITERS, device="cpu")
    after = timer.counters()
    assert seen["prune"] == {torch.int32} and seen["k2"] == {torch.int32}
    assert after.get("mcl.wide_runs", 0) == before.get("mcl.wide_runs", 0)
    assert after["mcl.runs"] == before["mcl.runs"] + 1
    assert_flows_equal(got, graph.markov_cluster(g, iters=ITERS, backend="scipy"))
    # the loop state's keys: biased int32, sentinel INT32_MAX
    kcsc, _ = chain._to_csc_state(torch.tensor([1, 0], dtype=torch.int32),
                                  torch.tensor([2, 3], dtype=torch.int32),
                                  torch.ones(2), torch.tensor([True, False]), p_pad=4, m=4000)
    assert kcsc.dtype == torch.int32
    assert kcsc.tolist() == [2 * 4000 + 1 - 2**31, I32_MAX, I32_MAX, I32_MAX]


def test_counters_name_each_instantiation():
    names = counters()
    assert names["K2_64"] is scan.KERNEL_64 and names["prune_compact_64"] is compact.KERNEL_64
    assert names["K2"] is scan.KERNEL and names["prune_compact"] is compact.KERNEL
    assert scan.KERNEL_64.symbol == "scan64_launch"
    assert compact.KERNEL_64.symbol == "prune_compact64_launch"


# ---- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,pad,offset", [(5 * scan.TILE + 77, 300, 0), (3 * scan.TILE, 1, 0),
                                          (1, 0, 0), (2 * scan.TILE + 333, 40, 1)])
def test_k2_64_kernel_bit_equal_to_plain(cuda, n, pad, offset):
    key, vals, n_cols = k2_wide_stream(n + offset, pad, seed=n)
    kt, vt = torch.from_numpy(key).to(cuda)[offset:], torch.from_numpy(vals).to(cuda)[offset:]
    before = (scan.KERNEL.launches, scan.KERNEL_64.launches)
    got = scan.merge_epilogue_scan(kt, vt, pad, n_cols=n_cols, sentinel_row=70_000)
    want = scan.merge_epilogue_plain(kt, vt, pad, n_cols=n_cols, sentinel_row=70_000)
    again = scan.merge_epilogue_scan(kt, vt, pad, n_cols=n_cols, sentinel_row=70_000)
    torch.cuda.synchronize()
    assert (scan.KERNEL.launches, scan.KERNEL_64.launches) == (before[0], before[1] + 2)
    for i in (0, 1, 3, 4):
        assert torch.equal(got[i], want[i]), i
        assert torch.equal(got[i], again[i]), i
    assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))
    assert torch.equal(got[2].view(torch.int32), again[2].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("elem_pad,ok", BOUNDARIES)
def test_prune_compact_64_kernel_bit_equal_to_plain(cuda, elem_pad, ok):
    arrays = prune_stream(5, 3 * TILE + 77, 3000, 1200)
    t = [torch.from_numpy(a).to(cuda) for a in arrays]
    kw = dict(thr_root=THR, m=M_WIDE, elem_pad=elem_pad)
    before = (compact.KERNEL.launches, compact.KERNEL_64.launches)
    raw = compact.prune_compact(*t, **kw)
    plain = compact.prune_compact_plain(*t, **kw)
    torch.cuda.synchronize()
    assert (compact.KERNEL.launches, compact.KERNEL_64.launches) == (before[0], before[1] + 1)
    assert raw[0].dtype == torch.int64 and bool(raw[2]) == bool(plain[2]) == ok
    n_real = int((raw[0] != I64_MAX).sum())
    assert not (raw[0][n_real:] != I64_MAX).any() and not raw[1][n_real:].any()
    if bool(plain[2]):  # the kernel writes in any order; sorted, the two agree bit for bit
        gk, order = torch.sort(raw[0])
        pk, porder = torch.sort(plain[0])
        assert torch.equal(gk, pk)
        assert torch.equal(raw[1][order].view(torch.int32), plain[1][porder].view(torch.int32))


@pytest.mark.cuda
def test_wide_mcl_run_on_card_launches_the_64_bit_kernels(cuda, wide):
    g, want = wide
    prep = graph.mcl_prepare(graph._mcl_setup(g), iters=ITERS, device=cuda)
    for _ in range(2):
        before = {k: v.launches for k, v in counters().items()}
        got = graph.mcl_run(prep).to_csr()
        launched = {k: v.launches - before[k] for k, v in counters().items()}
        assert launched["prune_compact_64"] == 1 and launched["prune_compact"] == 0
        # one loop merge per iteration; the column sums keep 32-bit column keys
        assert launched["K2_64"] == ITERS - 1 and launched["K2"] >= ITERS
        assert_flows_equal(got, want)


@pytest.mark.cuda
def test_wide_mcl_run_on_card_compacts_each_loop_squaring_by_the_kernel(cuda, wide, monkeypatch):
    """A warm wide run launches ``loop_compact_64`` once a loop iteration,
    the 32-bit loop compaction never, and no loop iteration reaches
    ``_to_front`` (whose scatters the kernel replaced there; the fetch
    to CSR still compacts by it)."""
    g, want = wide
    in_loop, fronts = [], []
    real_front, real_iteration = compact._to_front, chain._mcl_iteration

    def front_spy(*args, **kw):
        if in_loop:
            fronts.append(args[1])
        return real_front(*args, **kw)

    def iteration_spy(*args, **kw):
        in_loop.append(True)
        try:
            return real_iteration(*args, **kw)
        finally:
            in_loop.pop()

    monkeypatch.setattr(compact, "_to_front", front_spy)
    monkeypatch.setattr(chain, "_to_front", front_spy)
    monkeypatch.setattr(chain, "_mcl_iteration", iteration_spy)
    prep = graph.mcl_prepare(graph._mcl_setup(g), iters=ITERS, device=cuda)
    graph.mcl_run(prep).to_csr()  # a first run: the fast path's budgets
    for _ in range(2):
        fronts.clear()
        before = {k: v.launches for k, v in counters().items()}
        got = graph.mcl_run(prep).to_csr()
        launched = {k: v.launches - before[k] for k, v in counters().items()}
        assert launched["loop_compact_64"] == ITERS - 1 and launched["loop_compact"] == 0
        assert fronts == []
        assert_flows_equal(got, want)
