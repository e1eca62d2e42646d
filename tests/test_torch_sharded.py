"""The port's sharded programs in a gloo world of 8 CPU ranks, on the
meshes (8,), (4, 2) and (2, 4), against the JAX package's ``shard_map``
programs on the 8-virtual-device CPU mesh (``tests/torch_shard_cases.py``
holds the cases): each rank's merged entries equal its JAX device's, the
product gathered on rank 0 exact against scipy, the dryrun's records
held (nnz 4546 in 1-D and 4×2, 5401 in 1-D and 2-D chunked, the rebased
2³²-key nnz 8, 416 triangles). One world runs every case (spawning one
costs seconds); the worlds of 1, 2 and 4 ranks are in
``tests/test_torch_sharded_small.py``."""

import pytest

import torch_shard_cases as cases

WORLD = 8


@pytest.fixture(scope="module")
def world():
    with pytest.MonkeyPatch.context() as mp:
        return cases.run_world_cases(WORLD, mp)


@pytest.mark.parametrize("case", cases.cases_of(WORLD))
def test_rank_outputs_equal_jax(world, case):
    cases.assert_ranks_equal_jax(world[case], cases.jax_device_outputs(case))


@pytest.mark.parametrize("case", cases.cases_of(WORLD))
def test_csr_equals_scipy(world, case):
    cases.assert_csr_equals_scipy(case, world[case])


@pytest.mark.parametrize("case", cases.triangles_of(WORLD))
def test_triangles_equal_jax(world, case):
    import jax

    from outerspace_tpu.ops.graph import triangle_count, triangle_count_sharded
    from outerspace_tpu.shard import make_mesh

    _, shape, make, want = cases.TRIANGLES[case]
    g = make()
    names = ("x", "y")[:len(shape)]
    mesh = make_mesh(shape, names, devices=jax.devices()[:WORLD])
    kx, ny = shape[0], (shape[1] if len(shape) > 1 else 1)
    jax_count = triangle_count_sharded(g, mesh, axes=names if ny > 1 else "x", kx=kx, ny=ny)
    counts = [r["count"] for r in world[case]]
    assert counts == [jax_count] * WORLD
    assert jax_count == triangle_count(g, backend="scipy")
    if want is not None:
        assert jax_count == want


def test_meshes_and_launches(world):
    # the ranks sit at (r // ny, r % ny); on the CPU no kernel launches
    # (each wrapper runs its plain version)
    for case, want in (("dryrun_tiled_8", "(8,)"), ("tiled_k3_4x2", "(4, 2)")):
        for r, res in enumerate(world[case]):
            assert f"shape={want}" in res["mesh"] and "backend=gloo" in res["mesh"]
            assert "staged" not in res["mesh"]
            assert set(res["launches"].values()) == {0}
    assert "rank=5 at (2, 1)" in world["tiled_k3_4x2"][5]["mesh"]
