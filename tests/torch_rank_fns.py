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
    plan = mcl.plan_mcl_sharded_device(_mcl_setup(adj), kx=8, iters=iters)
    plan = dataclasses.replace(plan, p_pad=64)
    report = {}
    flow = mcl.run_to_csr(mcl.build_mcl_sharded_device(plan, mesh, "x"), adj, report)
    return (flow.shape, flow.indptr, flow.indices, flow.data), report


def jobs_and_starved(jobs, starved):
    """``shard.world.run_jobs(jobs)``, then :func:`starved_mcl` of each
    (adjacency, iterations) of ``starved``."""
    from outerspace_tpu_torch.shard.world import run_jobs

    return run_jobs(jobs), [starved_mcl(adj, iters) for adj, iters in starved]
