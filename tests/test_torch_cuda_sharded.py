"""The sharded mode on the card: a world of one rank on nccl and a world
of two ranks sharing the card over gloo (the exchange staged through
host memory), each through ``spgemm_sharded_tiled`` with global and
rebased keys, equal to the single-device ``spgemm`` on the card, with
K3, K1 and K2 launched by the ranks. Marked ``cuda``: each test skips
without a CUDA device. No JAX here, so it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_sharded.py
"""

import pytest
import torch

from outerspace_tpu_torch.formats import CSR, rmat
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
