"""Cases of the sharded MCL and NN tests: the port's jobs run in gloo
worlds of CPU ranks (``shard.world.run_jobs``), the JAX package's
counterparts on its 8-virtual-device CPU mesh, on the operands of
``tests/test_sharded_mcl.py`` and of the multi-device dryrun.

An MCL case: (world size, mesh shape, loop, operand maker, iterations,
the final nnz and cluster count where a record states them)."""


import numpy as np

from outerspace_tpu.formats import erdos_renyi, rmat
from torch_shard_cases import port

MCL = {
    # the JAX tests' operands (tests/test_sharded_mcl.py) and the dryrun's
    "er24_8_device": (8, (8,), "device", lambda: erdos_renyi(24, 24, 0.15, seed=4), 4, None),
    "er24_8_host": (8, (8,), "host", lambda: erdos_renyi(24, 24, 0.15, seed=4), 4, None),
    "er20_4x2_device": (8, (4, 2), "device", lambda: erdos_renyi(20, 20, 0.18, seed=7), 2, None),
    "er20_4x2_host": (8, (4, 2), "host", lambda: erdos_renyi(20, 20, 0.18, seed=7), 2, None),
    "dryrun_er24_8_host": (8, (8,), "host", lambda: erdos_renyi(24, 24, 0.15, seed=4), 3,
                           (287, 7)),
    "dryrun_er24_8_device": (8, (8,), "device", lambda: erdos_renyi(24, 24, 0.15, seed=4), 3,
                             (287, 7)),
    "dryrun_er24_4x2_device": (8, (4, 2), "device", lambda: erdos_renyi(24, 24, 0.15, seed=4), 3,
                               (287, 7)),
    # m = 10 on kx = 8: ranks 5-7 own no rows; m = 23: a partial last range
    "er10_8_device": (8, (8,), "device", lambda: erdos_renyi(10, 10, 0.3, seed=2), 3, None),
    "er23_8_device": (8, (8,), "device", lambda: erdos_renyi(23, 23, 0.2, seed=8), 3, None),
    "er10_8_host": (8, (8,), "host", lambda: erdos_renyi(10, 10, 0.3, seed=2), 3, None),
    # converges before its iterations run out: the frozen carry
    "rmat8_8_device_converges": (8, (8,), "device",
                                 lambda: rmat(8, edge_factor=4, seed=11).deduplicated(), 40, None),
    "rmat8_4x2_device_converges": (8, (4, 2), "device",
                                   lambda: rmat(8, edge_factor=4, seed=11).deduplicated(), 40,
                                   None),
    "er60_2x2_device": (4, (2, 2), "device", lambda: erdos_renyi(60, 60, 0.1, seed=3), 4, None),
    "er60_2x2_host": (4, (2, 2), "host", lambda: erdos_renyi(60, 60, 0.1, seed=3), 4, None),
    # dense: the JAX plan refuses the initial flow; the port sizes from it
    "dense_er512_2_device": (2, (2,), "device", lambda: erdos_renyi(512, 512, 0.4, seed=1), 3,
                             None),
}

# a starved expansion budget: the device loop's ok flag must trip and
# the exact host-planned loop run instead
STARVED = {"er24_8_starved": (8, (8,), lambda: erdos_renyi(24, 24, 0.2, seed=9), 3)}


def mcl_of(world):
    return [c for c, spec in MCL.items() if spec[0] == world]


def mcl_jobs(world):
    return [dict(program="mcl", loop=MCL[c][2], mesh=MCL[c][1], adj=port(MCL[c][3]()),
                 iters=MCL[c][4]) for c in mcl_of(world)]


def starved_of(world):
    return [c for c, spec in STARVED.items() if spec[0] == world]


def run_mcl_world(world, extra_jobs=()):
    """Every MCL case of ``world`` (then ``extra_jobs``) as jobs, and every
    starved case, in one gloo world of CPU ranks; returns ({case: each
    rank's result}, [each extra job's ranks' results], {starved case:
    each rank's (flow, report)})."""
    from outerspace_tpu_torch.shard.mesh import run_world

    import torch_rank_fns

    starved = [(port(STARVED[c][2]()), STARVED[c][3]) for c in starved_of(world)]
    jobs = mcl_jobs(world) + list(extra_jobs)
    res = run_world(torch_rank_fns.jobs_and_starved, world, backend="gloo", device="cpu",
                    args=(jobs, starved), timeout=600)
    per_job = [[r[0][i] for r in res] for i in range(len(jobs))]
    cases = mcl_of(world)
    return (dict(zip(cases, per_job)), per_job[len(cases):],
            {c: [r[1][i] for r in res] for i, c in enumerate(starved_of(world))})


def jax_mcl(case):
    """The JAX package's result of ``case`` on the virtual CPU mesh."""
    import jax

    from outerspace_tpu.ops.graph import markov_cluster_sharded
    from outerspace_tpu.shard import make_mesh
    from outerspace_tpu.shard.mcl import markov_cluster_sharded_device

    world, shape, loop, make, iters, _ = MCL[case]
    names = ("x", "y")[:len(shape)]
    mesh = make_mesh(shape, names, devices=jax.devices()[:world])
    kx, ny = shape[0], (shape[1] if len(shape) > 1 else 1)
    fn = markov_cluster_sharded_device if loop == "device" else markov_cluster_sharded
    return fn(make(), mesh, axes=names if ny > 1 else "x", kx=kx, ny=ny, iters=iters)


def assert_flow_equal(got, want, label=""):
    """nnz, indptr and indices exact, values within the JAX tests' bar
    (rtol 1e-4, atol 1e-5)."""
    assert got.nnz == want.nnz, (label, got.nnz, want.nnz)
    np.testing.assert_array_equal(np.asarray(got.indptr), np.asarray(want.indptr), err_msg=label)
    np.testing.assert_array_equal(np.asarray(got.indices), np.asarray(want.indices),
                                  err_msg=label)
    np.testing.assert_allclose(np.asarray(got.data), np.asarray(want.data), rtol=1e-4, atol=1e-5,
                               err_msg=label)


def cluster_sets(flow):
    from outerspace_tpu_torch.ops.graph import mcl_clusters

    return {tuple(sorted(np.asarray(c).tolist())) for c in mcl_clusters(flow)}
