"""The sharded mode on the card: a world of one rank on nccl and a world
of two ranks sharing the card over gloo (the exchange staged through
host memory), each through ``spgemm_sharded_tiled`` with global and
rebased keys, equal to the single-device ``spgemm`` on the card, with
K3, K1 and K2 launched by the ranks; and the device-resident sharded
MCL loop (K2) and ``SparseMLP.sharded`` (K5) in the same worlds against
the same jobs in a gloo world of CPU ranks: flows exact in structure,
values within the MCL bar (rtol 5e-4, atol 1e-5), on the fast path;
logits bit-equal to the single-device ``SparseMLP`` on the card and
within 1e-5 of the CPU's relative to their largest |y|. Marked
``cuda``: each test skips without a CUDA device. No JAX here, so it
runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_sharded.py
"""

import pytest
import torch

import numpy as np

from outerspace_tpu_torch.convert import load_params
from outerspace_tpu_torch.formats import CSR, rmat
from outerspace_tpu_torch.nn.sparse_infer import SparseMLP
from outerspace_tpu_torch.ops import assert_csr_allclose, spgemm
from outerspace_tpu_torch.shard.mesh import run_world
from outerspace_tpu_torch.shard.tiled import shard_plan_tiled
from outerspace_tpu_torch.shard.world import run_jobs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from outerspace_tpu_torch.runtime import build

    build.build()  # once, before the ranks start
    build.build_host("gplan")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")], ids=["nccl_1", "gloo_2"])
def test_sharded_tiled_on_card_equals_spgemm(cuda, world, backend):
    g = rmat(10, edge_factor=16, seed=1)
    want = spgemm(g, g, device=cuda)
    jobs = [dict(program="tiled", mesh=(world,), csr=True, entries=False,
                 plan=shard_plan_tiled(g.to_csc(), g.to_csr(), kx=world, waste_limit=2.0,
                                       rebase=rebase))
            for rebase in (None, True)]
    ranks = run_world(run_jobs, world, backend=backend, device="cuda", args=(jobs,), timeout=600)
    for j in range(len(jobs)):
        shape, indptr, indices, data = ranks[0][j]["csr"]
        assert_csr_allclose(CSR(shape, indptr, indices, data), want, rtol=1e-5, atol=1e-6)
        launches = {k: sum(r[j]["launches"][k] for r in ranks) for k in ("K1", "K2", "K3")}
        assert all(launches.values()), launches
        for r in ranks:
            assert f"backend={backend}, device=cuda:0" in r[j]["mesh"]
            assert ("staged through host memory" in r[j]["mesh"]) == (backend == "gloo")


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")], ids=["nccl_1", "gloo_2"])
def test_sharded_mcl_and_serving_on_card_equal_cpu(cuda, world, backend):
    params = load_params("data/saved_weights/MLP1w/prune0p01_finetuned.pkl")
    x = np.random.default_rng(0).random((256, 784)).astype(np.float32)
    jobs = [dict(program="mcl", loop="device", mesh=(world,), adj=rmat(10, edge_factor=8, seed=7),
                 iters=4),
            dict(program="serve", mesh=(world,), params=params, x=x)]
    card = run_world(run_jobs, world, backend=backend, device="cuda", args=(jobs,), timeout=600)
    cpu = run_world(run_jobs, world, backend="gloo", device="cpu", args=(jobs,), timeout=600)
    want = CSR(*cpu[0][0]["csr"])
    single = SparseMLP(params, device=cuda)(x).cpu().numpy()
    for r in card:
        got = CSR(*r[0]["csr"])
        assert got.nnz == want.nnz
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.data, want.data, rtol=5e-4, atol=1e-5)
        assert r[0]["report"]["fast_path"] and r[0]["report"]["host_reads"] == 2
        assert np.array_equal(r[1]["logits"], single)
        assert np.abs(r[1]["logits"] - cpu[0][1]["logits"]).max() <= 1e-5 * np.abs(single).max()
    assert sum(r[0]["launches"]["K2"] for r in card) > 0
    assert sum(r[1]["launches"]["K5"] for r in card) == 3 * world
