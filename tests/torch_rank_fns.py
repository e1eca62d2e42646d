"""Functions the sharded tests run in every rank of a world: the port's
modules only (no JAX in a rank), importable by name in a spawned rank."""

import dataclasses


def starved_mcl(adj, iters):
    """The device MCL loop on (8,) with its expansion budget cut to 64
    slots: its ``ok`` flag must trip and the exact host-planned loop
    run. Returns (the flow as a CSR tuple, the report)."""
    from outerspace_tpu_torch.ops.graph import _mcl_setup
    from outerspace_tpu_torch.shard import mcl
    from outerspace_tpu_torch.shard.mesh import make_mesh

    mesh = make_mesh((8,), ("x",))
    plan = mcl.plan_mcl_sharded_device(_mcl_setup(adj), kx=8, iters=iters, mesh=mesh)
    plan = dataclasses.replace(plan, p_pad=64)
    report = {}
    flow = mcl.run_to_csr(mcl.build_mcl_sharded_device(plan, mesh, "x"), report)
    return (flow.shape, flow.indptr, flow.indices, flow.data), report


def jobs_and_starved(jobs, starved):
    """``shard.world.run_jobs(jobs)``, then :func:`starved_mcl` of each
    (adjacency, iterations) of ``starved``."""
    from outerspace_tpu_torch.shard.world import run_jobs

    return run_jobs(jobs), [starved_mcl(adj, iters) for adj, iters in starved]


def wide_mcl(adj, iters, starve=False, device=None):
    """The device MCL loop on (4,) from ``adj``: every rank sizes nothing
    (rank 0 broadcasts the budgets), and with ``starve`` the expansion
    budget is cut to 64 slots so that ``ok`` trips and the exact
    host-planned loop runs. Returns (the flow as a CSR tuple, the
    report, the dtypes of the keys K2 was handed, the rank's counters'
    change)."""
    from outerspace_tpu_torch.ops.graph import _mcl_setup
    from outerspace_tpu_torch.ops.kernels import scan
    from outerspace_tpu_torch.perf import timer
    from outerspace_tpu_torch.shard import mcl
    from outerspace_tpu_torch.shard.mesh import make_mesh

    mesh = make_mesh((4,), ("x",), device=device)
    sized = []
    real_sizing = mcl._sharded_mcl_sizing
    mcl._sharded_mcl_sizing = lambda *a: sized.append(1) or real_sizing(*a)
    plan = mcl.plan_mcl_sharded_device(_mcl_setup(adj), kx=4, iters=iters, mesh=mesh)
    mcl._sharded_mcl_sizing = real_sizing
    if starve:
        plan = dataclasses.replace(plan, p_pad=64)
    seen = set()
    real_k2 = scan.merge_epilogue_plain

    def k2_spy(key, *a, **kw):
        seen.add(str(key.dtype))
        return real_k2(key, *a, **kw)

    scan.merge_epilogue_plain = k2_spy
    before = timer.counters()
    report = {}
    try:
        flow = mcl.run_to_csr(mcl.build_mcl_sharded_device(plan, mesh, "x"), report)
    finally:
        scan.merge_epilogue_plain = real_k2
    after = timer.counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    report["sized_here"] = bool(sized)
    return (flow.shape, flow.indptr, flow.indices, flow.data), report, sorted(seen), delta
