"""Cases of the sharded-mode tests: each runs one program of the port in
a gloo world of CPU ranks and the same program of the JAX package under
``shard_map`` on the 8-virtual-device CPU mesh (Pallas in interpret
mode), on the operands of ``tests/test_sharded.py`` (its tier-1 ones)
and of the multi-device dryrun (``__graft_entry__.py``).

A case: (world size, mesh shape, program, operand maker, plan keyword
arguments, the product's nnz where a record states it)."""

import importlib

import numpy as np

from outerspace_tpu.formats import COO, erdos_renyi, rmat
from outerspace_tpu_torch.formats import COO as TCOO


def port(coo):
    """The same operand as the port's COO."""
    return TCOO(coo.shape, np.asarray(coo.row), np.asarray(coo.col), np.asarray(coo.val))


def square(make):
    return lambda: (make(),) * 2


def skewed():
    rng = np.random.default_rng(5)
    return (COO((64, 64), np.zeros(32, np.int64), np.arange(32),
                rng.random(32).astype(np.float32) + 0.5),
            erdos_renyi(64, 64, 0.1, seed=44))


def corner_2_32():
    m = 1 << 16
    return COO((m, m), np.array([0, 0, 1, m - 1, m - 1, 7]), np.array([1, m - 1, 0, m - 1, 0, 7]),
               np.arange(1, 7, dtype=np.float32))


def rect_2_33():
    m, n, k = 1 << 20, 1 << 13, 64
    rng = np.random.default_rng(11)
    a = COO((m, k), rng.integers(0, m, 300), rng.integers(0, k, 300),
            rng.random(300).astype(np.float32) + 0.1).deduplicated()
    b = COO((k, n), rng.integers(0, k, 200), rng.integers(0, n, 200),
            rng.random(200).astype(np.float32) + 0.1).deduplicated()
    return a, b


def er128():
    return erdos_renyi(128, 128, 0.05, seed=7)


def rmat7_dryrun():
    return rmat(7, edge_factor=8, seed=9).deduplicated()


def rmat71():
    return rmat(7, edge_factor=8, seed=71)


def rmat8_ef16():  # with waste limit 2 it has tile classes in every layout (K3)
    return rmat(8, edge_factor=16, seed=1)


DRYRUN_NNZ = {"er128": 4546, "rmat7": 5401, "corner": 8}

CASES = {
    # world of 8: 1-D (8,)
    "sharded_er256_8": (8, (8,), "sharded", square(lambda: erdos_renyi(256, 256, 0.02, seed=31)), {}, None),
    "sharded_rmat7_8": (8, (8,), "sharded", square(lambda: rmat(7, edge_factor=8, seed=32)), {}, None),
    "sharded_rect_8": (8, (8,), "sharded", lambda: (erdos_renyi(100, 300, 0.05, seed=33),
                                                     erdos_renyi(300, 300, 0.03, seed=99)), {}, None),
    "sharded_empty_8": (8, (8,), "sharded", square(lambda: COO((64, 64), [0, 1], [0, 1], [1.0, 2.0])),
                        {}, None),
    "sharded_skewed_8": (8, (8,), "sharded", skewed, {}, None),
    "dryrun_sharded_8": (8, (8,), "sharded", square(er128), {}, DRYRUN_NNZ["er128"]),
    "dryrun_tiled_8": (8, (8,), "tiled", square(rmat7_dryrun), {}, DRYRUN_NNZ["rmat7"]),
    "tiled_chunks2_8": (8, (8,), "tiled", square(rmat71), dict(exchange_chunks=2), None),
    "tiled_parts2_8": (8, (8,), "tiled", square(rmat71), dict(merge_parts=2), None),
    "tiled_k3_8": (8, (8,), "tiled", square(rmat8_ef16), dict(waste_limit=2.0), None),
    "dryrun_rebased_8": (8, (8,), "tiled", square(corner_2_32), {}, DRYRUN_NNZ["corner"]),
    "rebased_forced_8": (8, (8,), "tiled", square(lambda: rmat71().deduplicated()),
                         dict(rebase=True), None),
    # world of 8: 2-D (4, 2) and (2, 4)
    "sharded2d_er200_4x2": (8, (4, 2), "sharded_2d", square(lambda: erdos_renyi(200, 200, 0.02, seed=61)),
                            {}, None),
    "sharded2d_rmat8_4x2": (8, (4, 2), "sharded_2d", square(lambda: rmat(8, edge_factor=4, seed=62)),
                            {}, None),
    "sharded2d_rect_4x2": (8, (4, 2), "sharded_2d", lambda: (erdos_renyi(150, 260, 0.03, seed=63),
                                                             erdos_renyi(260, 180, 0.03, seed=64)),
                           {}, None),
    "sharded2d_rmat8_2x4": (8, (2, 4), "sharded_2d", square(lambda: rmat(8, edge_factor=5, seed=65)),
                            {}, None),
    "dryrun_sharded2d_4x2": (8, (4, 2), "sharded_2d", square(er128), {}, DRYRUN_NNZ["er128"]),
    "tiled_rmat8_4x2": (8, (4, 2), "tiled", square(lambda: rmat(8, edge_factor=5, seed=75)), {}, None),
    "dryrun_tiled_4x2_chunks2": (8, (4, 2), "tiled", square(rmat7_dryrun), dict(exchange_chunks=2),
                                 DRYRUN_NNZ["rmat7"]),
    "tiled_k3_4x2": (8, (4, 2), "tiled", square(rmat8_ef16), dict(waste_limit=2.0), None),
    # worlds of 4, 2 and 1
    "rebased_er80000_4": (4, (4,), "tiled", square(lambda: erdos_renyi(80000, 80000, 2e-6, seed=5)),
                          {}, None),
    "rebased_rect_2_33_4": (4, (4,), "tiled", rect_2_33, {}, None),
    "rebased_k3_parts2_4": (4, (4,), "tiled", square(rmat8_ef16),
                            dict(waste_limit=2.0, rebase=True, merge_parts=2), None),
    "sharded_twokey_er80000_4": (4, (4,), "sharded", square(lambda: erdos_renyi(80000, 80000, 2e-6, seed=5)),
                                 {}, None),
    "tiled_k3_2x2": (4, (2, 2), "tiled", square(rmat8_ef16), dict(waste_limit=2.0), None),
    "rebased_corner_2": (2, (2,), "tiled", square(corner_2_32), {}, DRYRUN_NNZ["corner"]),
    "tiled_kx2_auto_2": (2, (2,), "tiled", square(rmat71), {}, None),
    "sharded_er256_2": (2, (2,), "sharded", square(lambda: erdos_renyi(256, 256, 0.02, seed=31)), {}, None),
    "tiled_sort_skip_1": (1, (1,), "tiled", square(rmat71), {}, None),
    "rebased_kx1_chunks2_1": (1, (1,), "tiled", square(lambda: rmat71().deduplicated()),
                              dict(exchange_chunks=2, rebase=True), None),
    "rebased_k3_kx1_chunks2_1": (1, (1,), "tiled", square(rmat8_ef16),
                                 dict(waste_limit=2.0, exchange_chunks=2, rebase=True), None),
    "sharded_er128_1": (1, (1,), "sharded", square(er128), {}, DRYRUN_NNZ["er128"]),
}

TRIANGLES = {
    "dryrun_er60_8": (8, (8,), lambda: erdos_renyi(60, 60, 0.12, seed=6), 416),
    "rmat9_4x2": (8, (4, 2), lambda: rmat(9, edge_factor=6, seed=3).deduplicated(), None),
    "er60_2x2": (4, (2, 2), lambda: erdos_renyi(60, 60, 0.12, seed=6), 416),
}


def cases_of(world):
    return [c for c, spec in CASES.items() if spec[0] == world]


def triangles_of(world):
    return [c for c, spec in TRIANGLES.items() if spec[0] == world]


def port_plan(case):
    """The port's plan of ``case`` (the caller sets the JAX cost weights)."""
    from outerspace_tpu_torch.shard import tiled as ttl

    # the module (``shard`` also exports the function ``spgemm_sharded``)
    tss = importlib.import_module("outerspace_tpu_torch.shard.spgemm_sharded")
    _, mesh, program, make, kw, _ = CASES[case]
    a, b = (port(x) for x in make())
    if program == "sharded":
        return tss.shard_plan(a.to_csc(), b.to_csr(), mesh[0])
    if program == "sharded_2d":
        return tss.shard_plan_2d(a.to_csc(), b.to_csr(), *mesh)
    return ttl.shard_plan_tiled(a.to_csc(), b.to_csr(), kx=mesh[0],
                                ny=mesh[1] if len(mesh) > 1 else 1, **kw)


def world_jobs(world):
    """The jobs of every case of ``world``: each case's program with the
    product gathered to rank 0, then each triangle case."""
    jobs = [dict(program=CASES[c][2], mesh=CASES[c][1], plan=port_plan(c), csr=True)
            for c in cases_of(world)]
    jobs += [dict(program="triangles", mesh=TRIANGLES[c][1], adj=port(TRIANGLES[c][2]()))
             for c in triangles_of(world)]
    return jobs


def run_world_cases(world, monkeypatch):
    """Run every case of ``world`` in one gloo world of CPU ranks; returns
    {case: [each rank's result]}."""
    from outerspace_tpu.sched import autotune as jat
    from outerspace_tpu_torch.sched import autotune as tat
    from outerspace_tpu_torch.sched import planner as tpl
    from outerspace_tpu_torch.shard.mesh import run_world
    from outerspace_tpu_torch.shard.world import run_jobs

    import torch_cases

    torch_cases.set_jax_cost_weights(monkeypatch, jat, tat, tpl.TILE_A_CLASSES)
    ids = cases_of(world) + triangles_of(world)
    res = run_world(run_jobs, world, backend="gloo", device="cpu", args=(world_jobs(world),),
                    timeout=300)
    return {c: [r[i] for r in res] for i, c in enumerate(ids)}


def jax_device_outputs(case):
    """The JAX package's per-device merged outputs of ``case``: (rows,
    cols, vals, valid, nnz), each [devices, ...] in mesh order."""
    import jax

    from outerspace_tpu.shard import make_mesh
    from outerspace_tpu.shard import tiled as jtl

    jss = importlib.import_module("outerspace_tpu.shard.spgemm_sharded")
    world, shape, program, make, kw, _ = CASES[case]
    a, b = make()
    names = ("x", "y")[:len(shape)]
    mesh = make_mesh(shape, names, devices=jax.devices()[:world])
    if program == "sharded":
        out = jss.spgemm_sharded(jss.shard_plan(a.to_csc(), b.to_csr(), world), mesh)
    elif program == "sharded_2d":
        out = jss.spgemm_sharded_2d(jss.shard_plan_2d(a.to_csc(), b.to_csr(), *shape), mesh)
    else:
        plan = jtl.shard_plan_tiled(a.to_csc(), b.to_csr(), kx=shape[0],
                                    ny=shape[1] if len(shape) > 1 else 1, **kw)
        out = jtl.spgemm_sharded_tiled(plan, mesh, axes=names if len(shape) > 1 else "x")
    return tuple(np.asarray(x).reshape(world, -1) for x in out)


def assert_ranks_equal_jax(ranks, jax_out):
    """Each rank's merged entries equal the JAX device's: rows, cols and
    nnz exact, values within rtol 1e-5 (the summation order differs)."""
    mr, mc, mv, mvalid, nnz = jax_out
    for r, got in enumerate(ranks):
        sel = mvalid[r]
        np.testing.assert_array_equal(got["rows"], mr[r][sel], err_msg=f"rank {r} rows")
        np.testing.assert_array_equal(got["cols"], mc[r][sel], err_msg=f"rank {r} cols")
        np.testing.assert_allclose(got["vals"], mv[r][sel], rtol=1e-5, atol=1e-6,
                                   err_msg=f"rank {r} vals")
        assert got["nnz"] == int(nnz[r][0]) == int(sel.sum())


def assert_csr_equals_scipy(case, ranks):
    """The product gathered on rank 0 against scipy (and none elsewhere)."""
    from outerspace_tpu_torch.formats.csr import CSR
    from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_scipy

    a, b = (port(x) for x in CASES[case][3]())
    shape, indptr, indices, data = ranks[0]["csr"]
    got = CSR(shape, indptr, indices, data)
    assert all(r["csr"] is None for r in ranks[1:])
    assert_csr_allclose(got, spgemm_scipy(a, b), rtol=1e-5, atol=1e-6)
    if CASES[case][5] is not None:
        assert got.nnz == CASES[case][5]
    return got
