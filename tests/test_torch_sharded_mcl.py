"""The port's sharded Markov clustering on the CPU (gloo worlds of CPU
ranks) against the JAX package's on its 8-virtual-device CPU mesh and
against scipy (``tests/torch_mcl_shard_cases.py`` holds the cases):

- the device-resident loop (``shard.mcl.markov_cluster_sharded_device``)
  and the host-planned loop (``ops.graph.markov_cluster_sharded``) on
  (8,), (4, 2) and (2, 2): nnz, indptr, indices and cluster sets exact
  against the JAX package's result and scipy's MCL, values within rtol
  1e-4, atol 1e-5 (the JAX tests' bar), the same flow on every rank; m =
  10 and m = 23 on 8 ranks (ranks with no rows, a partial last range);
  a graph that converges before its iterations run out (the frozen
  carry), its iterations equal to the host loop's;
- a starved expansion budget falls back to the host loop, exact, and
  the report says so;
- the plan: budgets and staged arrays equal to the JAX package's
  wherever it plans; past m² = 2³², where the JAX package refuses, keys
  in int64; on the dense ``erdos_renyi(512, 512, 0.4)`` with kx
  = 2 the JAX plan refuses the initial flow and the port's loop returns
  scipy's answer;
- ``perf.roofline.predict_mcl_sharded_iteration`` finite and positive.

One world per size runs every case of that size (spawning one costs
seconds)."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_mcl_shard_cases as mc
from outerspace_tpu_torch.formats.csr import CSR


@pytest.fixture(scope="module")
def worlds():
    cases, starved = {}, {}
    for world in (8, 4, 2):
        got, _, st = mc.run_mcl_world(world)
        cases.update(got)
        starved.update(st)
    return cases, starved


def scipy_mcl(case):
    from outerspace_tpu_torch.ops.graph import markov_cluster

    from torch_shard_cases import port

    return markov_cluster(port(mc.MCL[case][3]()), iters=mc.MCL[case][4], backend="scipy")


JAX_CASES = [c for c in mc.MCL if not c.startswith("dense")]


@pytest.mark.parametrize("case", JAX_CASES)
def test_mcl_equals_jax_and_scipy(worlds, case):
    ranks = worlds[0][case]
    want = scipy_mcl(case)
    jax_flow = mc.jax_mcl(case)
    mc.assert_flow_equal(jax_flow, want, "JAX vs scipy")
    for r, res in enumerate(ranks):
        got = CSR(*res["csr"])
        mc.assert_flow_equal(got, jax_flow, f"rank {r} vs JAX")
        mc.assert_flow_equal(got, want, f"rank {r} vs scipy")
        assert mc.cluster_sets(got) == mc.cluster_sets(want) == mc.cluster_sets(jax_flow)
    record = mc.MCL[case][5]
    if record is not None:
        assert (want.nnz, len(mc.cluster_sets(want))) == record
    if mc.MCL[case][2] == "device":
        assert all(r["report"]["fast_path"] and r["report"]["host_reads"] == 2 for r in ranks)


def test_dense_initial_flow_sized_where_jax_refuses(worlds):
    from outerspace_tpu.ops.graph import _mcl_setup as j_setup
    from outerspace_tpu.shard.mcl import plan_mcl_sharded_device as j_plan

    case = "dense_er512_2_device"
    _, _, _, make, iters, _ = mc.MCL[case]
    with pytest.raises(ValueError, match="initial flow exceeds"):
        j_plan(j_setup(make()), kx=2, iters=iters)
    want = scipy_mcl(case)
    for res in worlds[0][case]:
        mc.assert_flow_equal(CSR(*res["csr"]), want, "dense")
        assert res["report"]["fast_path"] is True


def test_converging_graph_stops_where_the_host_loop_does(worlds):
    from outerspace_tpu_torch.ops.graph import _converged, _mcl_inflate_prune, _mcl_setup
    from outerspace_tpu_torch.ops.reference import spgemm_scipy

    from torch_shard_cases import port

    for case in ("rmat8_8_device_converges", "rmat8_4x2_device_converges"):
        flow, n = _mcl_setup(port(mc.MCL[case][3]())), 0
        while True:  # the host loop's iterations to convergence
            new = _mcl_inflate_prune(spgemm_scipy(flow, flow), 2.0, 1e-4)
            n += 1
            if _converged(flow, new):
                break
            flow = new
        assert n < mc.MCL[case][4]
        for res in worlds[0][case]:
            assert res["report"]["converged"] is True
            assert res["report"]["iterations"] == n, (res["report"], n)


def test_starved_budget_falls_back_exact(worlds):
    from outerspace_tpu_torch.ops.graph import markov_cluster

    from torch_shard_cases import port

    for case, ranks in worlds[1].items():
        _, _, make, iters = mc.STARVED[case]
        want = markov_cluster(port(make()), iters=iters, backend="scipy")
        for flow, report in ranks:
            mc.assert_flow_equal(CSR(*flow), want, case)
            assert report["fast_path"] is False
            assert report["host_reads"] == 1  # the flags; the host loop then ran
            assert report["fallback"]["loop"] == "host"


PLANS = [  # (operand maker, kx, ny, iters)
    (lambda: mc.erdos_renyi(24, 24, 0.15, seed=4), 8, 1, 4),
    (lambda: mc.erdos_renyi(20, 20, 0.18, seed=7), 4, 2, 2),
    (lambda: mc.erdos_renyi(10, 10, 0.3, seed=2), 8, 1, 3),
    (lambda: mc.erdos_renyi(23, 23, 0.2, seed=8), 8, 1, 3),
    (lambda: mc.rmat(8, edge_factor=4, seed=11).deduplicated(), 8, 1, 6),
    (lambda: mc.erdos_renyi(64, 64, 0.1, seed=3), 4, 1, 3),
    (lambda: mc.rmat(9, edge_factor=8, seed=2), 2, 4, 3),
]


@pytest.mark.parametrize("i", range(len(PLANS)))
def test_plan_equals_jax(i):
    from outerspace_tpu.ops.graph import _mcl_setup as j_setup
    from outerspace_tpu.shard.mcl import plan_mcl_sharded_device as j_plan
    from outerspace_tpu_torch.ops.graph import _mcl_setup
    from outerspace_tpu_torch.shard.mcl import plan_mcl_sharded_device

    from torch_shard_cases import port

    make, kx, ny, iters = PLANS[i]
    want = j_plan(j_setup(make()), kx=kx, ny=ny, iters=iters)
    got = plan_mcl_sharded_device(_mcl_setup(port(make())), kx=kx, ny=ny, iters=iters)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
        else:
            assert a == b, (f.name, a, b)


def test_plan_refusals():
    from outerspace_tpu_torch.formats import erdos_renyi
    from outerspace_tpu_torch.ops.graph import _mcl_setup
    from outerspace_tpu_torch.shard.mcl import plan_mcl_sharded_device

    with pytest.raises(ValueError, match="square"):
        plan_mcl_sharded_device(erdos_renyi(8, 9, 0.5, seed=1).to_csr(), kx=2)
    # past m² = 2³² the plan keys the flow in int64 (once refused)
    big = erdos_renyi(1 << 16, 1 << 16, 1e-9, seed=1)
    flow = _mcl_setup(big)
    plan = plan_mcl_sharded_device(flow, kx=2)
    assert plan.key_dtype == torch.int64 and plan.flow_k.dtype == np.int64
    assert (plan.flow_k != 2**63 - 1).sum() == flow.nnz


@pytest.mark.parametrize("kx,ny", [(1, 1), (4, 1), (4, 2)])
def test_roofline_finite_and_positive(kx, ny):
    from outerspace_tpu_torch.formats import erdos_renyi
    from outerspace_tpu_torch.ops.graph import _mcl_setup
    from outerspace_tpu_torch.perf.roofline import predict_mcl_sharded_iteration
    from outerspace_tpu_torch.shard.mcl import plan_mcl_sharded_device

    plan = plan_mcl_sharded_device(_mcl_setup(erdos_renyi(64, 64, 0.1, seed=3)), kx=kx, ny=ny,
                                   iters=3)
    t = predict_mcl_sharded_iteration(plan)
    assert np.isfinite(t) and t > 0
    # more budget slots cost more time
    assert predict_mcl_sharded_iteration(dataclasses.replace(plan, p_pad=4 * plan.p_pad)) > t
