"""The port's sharded programs in gloo worlds of 1, 2 and 4 CPU ranks
against the JAX package's ``shard_map`` programs on as many virtual CPU
devices (``tests/torch_shard_cases.py``): the rebased keys past 2³² (the
(m−1, n−1) corner at m·n = 2³², m·n ≈ 6.4e9 and a 2³³ rectangle), the
two-key merge of the flat program, K3's tile classes on 2×2 and rebased,
and the single sender's sort skip (kx = 1). One world per size runs
every case of that size."""

import pytest

import torch_shard_cases as cases


@pytest.fixture(scope="module")
def worlds():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for world in (1, 2, 4):
            out.update(cases.run_world_cases(world, mp))
    return out


SMALL = [c for w in (1, 2, 4) for c in cases.cases_of(w)]


@pytest.mark.parametrize("case", SMALL)
def test_rank_outputs_equal_jax(worlds, case):
    cases.assert_ranks_equal_jax(worlds[case], cases.jax_device_outputs(case))


@pytest.mark.parametrize("case", SMALL)
def test_csr_equals_scipy(worlds, case):
    cases.assert_csr_equals_scipy(case, worlds[case])


def test_triangles_2x2(worlds):
    assert [r["count"] for r in worlds["er60_2x2"]] == [416] * 4


def test_a_rank_failure_raises_in_the_caller():
    from outerspace_tpu_torch.shard.mesh import run_world
    from outerspace_tpu_torch.shard.world import run_jobs

    with pytest.raises(RuntimeError, match="rank 0 raised"):
        run_world(run_jobs, 1, backend="gloo", device="cpu",
                  args=([dict(program="nope", mesh=(1,), plan=None)],), timeout=60)


def test_nccl_needs_a_card_per_rank():
    from outerspace_tpu_torch.shard.mesh import run_world
    from outerspace_tpu_torch.shard.world import run_jobs

    with pytest.raises(ValueError, match="one rank per card"):
        run_world(run_jobs, 2, backend="nccl", device="cpu", args=([],))
    with pytest.raises(ValueError, match="backend must be one of"):
        run_world(run_jobs, 2, backend="mpi", device="cpu", args=([],))


def test_run_world_runs_on_the_card_unless_asked(monkeypatch):
    import torch

    from outerspace_tpu_torch.shard.mesh import run_world
    from outerspace_tpu_torch.shard.world import run_jobs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    # the default device is the card, under either backend: never the CPU unasked
    with pytest.raises(ValueError, match="needs a CUDA device"):
        run_world(run_jobs, 1, backend="gloo", args=([],))
    with pytest.raises(ValueError, match="one rank per card"):
        run_world(run_jobs, 1, backend="nccl", args=([],))
