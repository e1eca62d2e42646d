"""The port's event model (``perf/perfsim.py`` + ``csrc/perfsim.cpp``)
against the JAX package's (``outerspace_tpu.perf.perfsim``).

Under the JAX package's machine, passed in by the test (its calibrated
config, the ring, the bitonic sort, its clock, link rate and gather
cost, all read from the JAX package here and never written into the
port), every entry point gives the JAX package's integers: cycles, hits,
misses, grants, stalls, link busy, and the stats dump byte for byte.
Rebased sharded plans are held to the JAX machinery charged at each
bucket's stream length (the JAX package's capacity overcharge is a
divergence by design). Under the card's machine: the four selftests pass,
predictions grow with size, a switch exchange takes the busiest card's
bytes over the link rate, the cub_radix sort charge is the roofline's
bytes over the HBM rate, and the spec-sheet fields are ``GPUConfig``'s
rates over the clock."""

import dataclasses
import inspect
import re

import numpy as np
import pytest

from outerspace_tpu.formats import COO, erdos_renyi, rmat
from outerspace_tpu.perf import perfsim as J
from outerspace_tpu.sched import autotune as jat
from outerspace_tpu.sched import planner as jpl
from outerspace_tpu.shard import tiled as jtl
from outerspace_tpu_torch.perf import perfsim as P
from outerspace_tpu_torch.perf import roofline
from outerspace_tpu_torch.sched import autotune as tat
from outerspace_tpu_torch.sched import planner as tpl
from outerspace_tpu_torch.shard import tiled as ttl

import torch_cases  # tests/ is on sys.path under pytest
import torch_mcl_shard_cases as mc
from conftest import random_matrices
from torch_shard_cases import port


def jax_machine() -> dict:
    """The JAX package's machine as the port's config: its calibrated
    SimConfig and the defaults of its wrapper's signatures and source."""
    J.load()
    sig = inspect.signature
    gather = re.search(r"gather_cyc = (\d+)", inspect.getsource(J.simulate_mcl_sharded_iteration))
    return dict(J.CALIBRATED_CONFIG, topology="ring", sort_impl="xla_bitonic",
                clock_hz=sig(J.simulate_expand_schedule).parameters["clock_hz"].default,
                link_bw_bytes=sig(J.simulate_sharded_tiled).parameters["ici_bw_bytes"].default,
                gather_cyc=int(gather.group(1)))


@pytest.fixture
def card():
    """The card's machine, restored afterwards (the config is a process
    global of the library)."""
    P.load()
    yield P.CARD_CONFIG
    P.set_config(**P.CARD_CONFIG)
    P.set_stats_dump(None, 0)


@pytest.fixture
def jax(card):
    """The JAX package's machine in the port and the JAX package's own
    built-in one; the card's machine and both stats dumps restored after."""
    J.set_config(**J.CALIBRATED_CONFIG)
    P.set_config(**jax_machine())
    yield
    J.set_config(**J.CALIBRATED_CONFIG)
    J.set_stats_dump(None, 0)


@pytest.fixture
def jax_weights(monkeypatch):
    torch_cases.set_jax_cost_weights(monkeypatch, jat, tat, tpl.TILE_A_CLASSES)


# ---- under the JAX package's machine: integer for integer

def tables(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(64, 9000, n), rng.integers(64, 40000, n), rng.integers(8, 200000, n),
            rng.integers(0, max(n // 3, 1), n))


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 37), (2, 300), (3, 1200)])
def test_tables_equal_jax(jax, seed, n):
    ib, ob, fl, bb = tables(seed, n)
    for mxu in (False, True):
        assert P.simulate_kernel(ib, ob, fl, use_mxu=mxu) == J.simulate_kernel(ib, ob, fl, mxu)
    for slots, line in ((16, 8192), (4, 1024), (64, 4096)):
        assert (P.simulate_kernel_cached(ib, ob, fl, bb, cache_slots=slots, line_bytes=line)
                == J.simulate_kernel_cached(ib, ob, fl, bb, cache_slots=slots, line_bytes=line))
    parts = np.random.default_rng(seed).integers(1, 300000, max(n // 100, 1))
    assert P.simulate_merge_parts(parts) == J.simulate_merge_parts(parts)
    assert P.simulate_merge_parts(parts, parts * 3) == J.simulate_merge_parts(parts, parts * 3)
    for pairs in (0, 1, 2, 3, 1000, n * 1000, 1 << 22):
        assert P.sort_cycles(pairs) == J.sort_cycles(pairs)


@pytest.mark.parametrize("ndev,chunks,parts,skip", [(1, 1, 1, True), (2, 2, 1, False),
                                                    (4, 1, 3, False), (8, 2, 2, False),
                                                    (3, 3, 1, True)])
def test_sharded_pipeline_equal_jax(jax, ndev, chunks, parts, skip):
    rng = np.random.default_rng(ndev * 10 + chunks)
    args = (ndev, rng.integers(100, 50000, ndev), rng.integers(0, 200000, ndev),
            rng.integers(0, 400000, (chunks, ndev, ndev)),
            rng.integers(0, 100000, (ndev, chunks, parts)))
    want = J.simulate_sharded_pipeline(*args, merge_sort_skip=skip)
    assert P.simulate_sharded_pipeline(*args, merge_sort_skip=skip) == want
    out = rng.integers(0, 9000, (ndev, chunks, parts))
    assert (P.simulate_sharded_pipeline(*args, merge_out_bytes=out, merge_sort_skip=skip)
            == J.simulate_sharded_pipeline(*args, merge_out_bytes=out, merge_sort_skip=skip))


@pytest.mark.parametrize("case", random_matrices(), ids=lambda c: c[0])
def test_zoo_class_plans_equal_jax(jax, jax_weights, case):
    _, a, b = case
    for wl in (1.1, 3.0, 8.0):
        want = jpl.plan_outer_classes(a.to_csc(), b.to_csr(), waste_limit=wl)
        got = tpl.plan_outer_classes(port(a).to_csc(), port(b).to_csr(), waste_limit=wl)
        for gc, wc in zip(got.classes, want.classes, strict=True):
            assert P.simulate_expand_schedule(gc) == J.simulate_expand_schedule(wc)
            # the JAX machine's cache: 16 lines of eight 128-lane B blocks
            assert (P.simulate_expand_cached(gc, cache_slots=16, line_blocks=8)
                    == J.simulate_expand_cached(wc))


PLANS = {
    "rmat7_1": (lambda: (mc.rmat(7, edge_factor=8, seed=71),) * 2, dict(kx=1)),
    "rmat8_2": (lambda: (rmat(8, edge_factor=5, seed=75),) * 2, dict(kx=2)),
    "rmat8_4": (lambda: (rmat(8, edge_factor=5, seed=75),) * 2, dict(kx=4)),
    "rmat8_2x2": (lambda: (rmat(8, edge_factor=5, seed=75),) * 2, dict(kx=2, ny=2)),
    "rmat8_4x2": (lambda: (rmat(8, edge_factor=5, seed=75),) * 2, dict(kx=4, ny=2)),
    "er256_4_chunks2": (lambda: (erdos_renyi(256, 256, 0.02, seed=72),) * 2,
                        dict(kx=4, exchange_chunks=2)),
    "rmat8_ef16_2_parts2": (lambda: (rmat(8, edge_factor=16, seed=1),) * 2,
                            dict(kx=2, merge_parts=2, waste_limit=2.0)),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_sharded_tiled_equal_jax(jax, jax_weights, case):
    make, kw = PLANS[case]
    a, b = make()
    want = jtl.shard_plan_tiled(a.to_csc(), b.to_csr(), **kw)
    got = ttl.shard_plan_tiled(port(a).to_csc(), port(b).to_csr(), **kw)
    assert not got.rebase
    assert P.simulate_sharded_tiled(got) == J.simulate_sharded_tiled(want)


REBASED = {
    "forced_8": (lambda: (mc.rmat(7, edge_factor=8, seed=71).deduplicated(),) * 2,
                 dict(kx=8, rebase=True)),
    "forced_4x2_chunks2": (lambda: (mc.rmat(7, edge_factor=8, seed=71).deduplicated(),) * 2,
                           dict(kx=4, ny=2, exchange_chunks=2, rebase=True)),
    "auto_er80000_4": (lambda: (erdos_renyi(80000, 80000, 2e-6, seed=5),) * 2, dict(kx=4)),
    "corner_2": (lambda: (COO((1 << 16, 1 << 16), np.array([0, 0, 1, 65535, 65535, 7]),
                              np.array([1, 65535, 0, 65535, 0, 7]),
                              np.arange(1, 7, dtype=np.float32)),) * 2, dict(kx=2)),
}


def jax_rebased(plan) -> dict:
    """The JAX machinery on a rebased plan with each bucket's sort charged
    at that bucket's stream length (not at the exchange capacity)."""
    from outerspace_tpu.sched.gplanner import GROUP_SUBS, SUB_P, SUPER_A, SUPER_B

    def expand(class_T, tile_as, ngroups):
        cyc = 0
        for T, ta in zip(class_T, tile_as):
            if T:
                cyc += J.simulate_kernel(np.full(T, ta * 8 + 128 * 8), np.full(T, ta * 128 * 8),
                                         np.full(T, ta * 128))[0]
        if ngroups:
            in_b = (SUPER_A * 8 * 4 * 128 + SUPER_B * 8 * 2 * 128 + 8 * 128) * 4
            cyc += J.simulate_kernel(np.full(ngroups, in_b), np.full(ngroups, GROUP_SUBS * SUB_P * 8),
                                     np.full(ngroups, GROUP_SUBS * SUB_P))[0]
        return cyc

    stream = [sum(t * ta * 128 for t, ta in zip(bk["class_T"], bk["tile_as"]))
              + bk["ngroups"] * GROUP_SUBS * SUB_P for bk in plan.buckets]
    cyc = sum(expand(bk["class_T"], bk["tile_as"], bk["ngroups"]) + J.sort_cycles(n)
              for bk, n in zip(plan.buckets, stream))
    kx = plan.kx
    out = J.simulate_sharded_pipeline(
        kx, np.full(kx, cyc), np.zeros(kx), np.full((plan.chunks, kx, kx), plan.capacity * 8),
        np.full((kx, plan.chunks, plan.merge_parts), kx * plan.mcap), merge_sort_skip=kx == 1)
    out["expand_cycles_per_dev"] = int(cyc)
    return out


@pytest.mark.parametrize("case", list(REBASED))
def test_rebased_charged_per_bucket_stream(jax, jax_weights, case):
    make, kw = REBASED[case]
    a, b = make()
    plan = ttl.shard_plan_tiled(port(a).to_csc(), port(b).to_csr(), **kw)
    assert plan.rebase
    jplan = jtl.shard_plan_tiled(a.to_csc(), b.to_csr(), **kw)
    assert P.simulate_sharded_tiled(plan) == jax_rebased(jplan)
    # the charge differs from the JAX package's where a bucket's stream
    # is not the capacity
    if any(ttl._bucket_stream_len(bk) < plan.capacity for bk in plan.buckets):
        assert P.simulate_sharded_tiled(plan) != J.simulate_sharded_tiled(jplan)


MCL_CASES = [c for c, spec in mc.MCL.items() if spec[2] == "device" and not c.startswith("dense")]


@pytest.mark.parametrize("case", MCL_CASES)
def test_mcl_iteration_equal_jax(jax, case):
    from outerspace_tpu.ops.graph import _mcl_setup as j_setup
    from outerspace_tpu.shard.mcl import plan_mcl_sharded_device as j_plan
    from outerspace_tpu_torch.ops.graph import _mcl_setup
    from outerspace_tpu_torch.shard.mcl import plan_mcl_sharded_device

    _, shape, _, make, iters, _ = mc.MCL[case]
    kx, ny = shape[0], (shape[1] if len(shape) > 1 else 1)
    want = j_plan(j_setup(make()), kx=kx, ny=ny, iters=iters)
    got = plan_mcl_sharded_device(_mcl_setup(port(make())), kx=kx, ny=ny, iters=iters)
    assert (got.p_pad, got.cap, got.ecap, got.na, got.m) == (
        want.p_pad, want.cap, want.ecap, want.na, want.m)
    assert P.simulate_mcl_sharded_iteration(got) == J.simulate_mcl_sharded_iteration(want)


def test_stats_dump_byte_for_byte(jax, tmp_path):
    ib, ob, fl, bb = tables(7, 60)
    for name, mod in (("port", P), ("jax", J)):
        assert mod.set_stats_dump(str(tmp_path / f"{name}.txt"), 500)
        mod.simulate_kernel(ib, ob, fl)
        mod.simulate_kernel_cached(ib, ob, fl, bb, cache_slots=16, line_bytes=8192)
        mod.simulate_merge_parts(ib * 4)
        mod.set_stats_dump(None, 0)
    got, want = ((tmp_path / f"{n}.txt").read_bytes() for n in ("port", "jax"))
    assert got == want and b"vmem_cache: hits=" in got and b"sort_unit" in got


# ---- under the card's machine

def test_selftests_pass_on_the_card(card):
    assert P.get_config() == card
    assert P.selftests() == {"fifo": 0, "arbiter": 0, "ici": 0, "rowbuffer": 0}


def test_defaults_are_the_cards(card):
    gpu = roofline.GPUConfig()
    clock = card["clock_hz"]
    assert card["hbm_bytes_per_cycle"] == gpu.hbm_bw_bytes / clock
    assert card["vpu_lanes"] == gpu.fp32_ops / clock
    assert card["mxu_ops_per_cycle"] == gpu.tensor_ops / clock
    assert card["link_bw_bytes"] == gpu.nvlink_bw_bytes
    assert card["gather_cyc"] == tat.FLAT_NS * (clock / 1e9)
    assert card["sort_impl"] == "cub_radix" and card["topology"] == "switch"
    # no field keeps the JAX package's (its device's) value
    for k, v in jax_machine().items():
        assert card[k] != v, k
    # the docstring's table names every field
    for k in card:
        assert re.search(rf"^{k}\s", P.__doc__, re.M), k


def test_cub_radix_sort_is_the_rooflines_bytes(card):
    bpc = card["hbm_bytes_per_cycle"]
    for n in (1, 2, 1000, 123457, 1 << 22, 25165824):
        assert P.sort_cycles(n) == int(roofline.sort_bytes(n) / bpc) + int(card["grid_overhead"])
    assert P.sort_cycles(0) == 0
    parts = [1 << 16, 3 << 15, 5000]
    out = P.simulate_merge_parts(parts)
    assert out["total_stages"] == roofline.RADIX_PASSES * len(parts)
    assert out["sort_busy_cycles"] >= sum(int(roofline.sort_bytes(n) / bpc) for n in parts)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_switch_exchange_is_busiest_card_over_link(card, ndev):
    rng = np.random.default_rng(ndev)
    xfer = rng.integers(0, 3_000_000, (1, ndev, ndev))
    out = P.simulate_sharded_pipeline(ndev, np.zeros(ndev), np.zeros(ndev), xfer,
                                      np.zeros((ndev, 1, 1)))
    rate = card["link_bw_bytes"] / card["clock_hz"]
    sent = xfer[0] * (1 - np.eye(ndev, dtype=np.int64))  # the local bucket stays home
    busiest = int(sent.sum(axis=1).max()) / rate
    # each message may leave at most one cycle's credit unused
    assert busiest <= out["max_link_busy"] <= busiest + ndev
    assert out["ici_hop_bytes"] == int(sent.sum())  # one hop each
    assert out["max_link_busy"] <= out["exchange_done_cycles"] <= out["max_link_busy"] + 2
    # the ring takes longer for the same exchange (hops store and forward)
    P.set_config(topology="ring")
    ring = P.simulate_sharded_pipeline(ndev, np.zeros(ndev), np.zeros(ndev), xfer,
                                       np.zeros((ndev, 1, 1)))
    assert ring["ici_hop_bytes"] >= out["ici_hop_bytes"]
    if ndev > 2:
        assert ring["exchange_done_cycles"] > out["exchange_done_cycles"]


def test_predictions_grow_with_size(card):
    last = [0] * 5
    for n in (8, 64, 512, 4096):
        ib, ob, fl, bb = tables(n, n)
        merge = P.simulate_merge_parts(np.full(4, n * 500))["cycles"]
        sharded = P.simulate_sharded_pipeline(
            4, np.full(4, n * 10), np.full(4, n * 100), np.full((1, 4, 4), n * 1000),
            np.full((4, 1, 2), n * 200))["cycles"]
        now = [P.simulate_kernel(np.full(n, 1088), np.full(n, 8192), np.full(n, 1024))[0],
               P.simulate_kernel_cached(np.full(n, 64), np.full(n, 8192), np.full(n, 1024),
                                        np.arange(n) // 4)["cycles"],
               merge, sharded, P.sort_cycles(n * 100)]
        assert all(a > b for a, b in zip(now, last)), (n, now, last)
        last = now


def test_mcl_iteration_grows_and_uses_the_card(card):
    @dataclasses.dataclass
    class Plan:
        kx: int
        p_pad: int
        cap: int
        ecap: int
        na: int
        m: int

    small = P.simulate_mcl_sharded_iteration(Plan(2, 1 << 16, 1 << 14, 1 << 12, 1 << 13, 4096))
    big = P.simulate_mcl_sharded_iteration(Plan(2, 1 << 20, 1 << 18, 1 << 16, 1 << 17, 65536))
    assert big["cycles"] > small["cycles"] > 0
    assert big["seconds"] == big["cycles"] / card["clock_hz"]


def test_config_checks(card):
    with pytest.raises(ValueError, match="unknown config keys"):
        P.set_config(ici_bw_bytes=1.0)
    with pytest.raises(ValueError, match="sort_impl 'radix'"):
        P.set_config(sort_impl="radix")
    P.set_config(**P.SPEC_CONFIG)
    assert P.get_config()["grid_overhead"] == 0
    P.set_config(topology="ring", sort_impl="xla_bitonic", gather_cyc=3.5)
    got = P.get_config()
    assert (got["topology"], got["sort_impl"], got["gather_cyc"]) == ("ring", "xla_bitonic", 3.5)
    P.set_config(**card)
    assert P.get_config() == card


def test_simcal_probes_are_built_as_the_kernels_are():
    from outerspace_tpu_torch.perf import simcal
    from outerspace_tpu_torch.runtime import build

    src = (build.CSRC / "simcal.cu").read_text()
    assert "torch/extension.h" not in src
    assert 'extern "C" const char* cuda_error_string(' in src
    for kernel in (simcal.CHASE, simcal.NOOP):
        assert kernel.source == "simcal"
        assert f'extern "C" int {kernel.symbol}(' in src
    with pytest.raises(ValueError, match="on the card only"):
        simcal.measure("cpu")


def test_threads_take_turns(card):
    # the library's machine is a process global: calls from threads
    # (the command line's sharded runs side by side) must not interleave
    import threading

    rng = np.random.default_rng(5)
    args = (4, rng.integers(100, 5000, 4), rng.integers(0, 90000, 4),
            rng.integers(0, 90000, (2, 4, 4)), rng.integers(0, 20000, (4, 2, 2)))
    want = P.simulate_sharded_pipeline(*args)
    got = []
    threads = [threading.Thread(target=lambda: got.append(P.simulate_sharded_pipeline(*args)))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert got == [want] * 6
