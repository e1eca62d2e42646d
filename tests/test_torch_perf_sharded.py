"""The roofline's sharded predictors (``predict_sharded_tiled``,
``predict_spgemm_time(ndev > 1)``) and the ranks' stream lengths they
charge, which must be the slots a rank's program expands. The program is
staged in this process on a world of one gloo rank (a ``file://``
rendezvous in a temporary directory)."""

import math

import pytest
import torch
import torch.distributed as dist

from outerspace_tpu_torch.formats import COO, rmat
from outerspace_tpu_torch.perf.roofline import (
    GPUConfig,
    predict_merge_time,
    predict_multiply_time,
    predict_sharded_tiled,
    predict_sort_time,
    predict_spgemm_time,
)
from outerspace_tpu_torch.shard.mesh import make_mesh
from outerspace_tpu_torch.shard.tiled import (
    build_sharded_tiled,
    rank_stream_lens,
    shard_plan_tiled,
    sharded_tiled_to_csr,
)


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    init = tmp_path_factory.mktemp("world") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=1, rank=0)
    yield make_mesh((1,), ("x",), device="cpu")
    dist.destroy_process_group()


def tiled_operand():
    return rmat(8, edge_factor=16, seed=1)  # tile classes at waste limit 2


@pytest.mark.parametrize("kw", [dict(), dict(rebase=True, exchange_chunks=2)],
                         ids=["global", "rebased"])
def test_rank_stream_lens_are_the_program_slots(world_of_one, kw):
    from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_scipy

    g = tiled_operand()
    plan = shard_plan_tiled(g.to_csc(), g.to_csr(), kx=1, waste_limit=2.0, **kw)
    prog = build_sharded_tiled(plan, world_of_one, "x")
    assert rank_stream_lens(plan, 0, 0) == [s.slots for s in prog.streams]
    # the common padding is left out: never more than the plan's stream
    assert sum(rank_stream_lens(plan, 0, 0)) <= plan.stream_len
    assert any(s.group is not None for s in prog.streams)  # K3 runs
    got = sharded_tiled_to_csr(plan, prog.run())
    assert_csr_allclose(got, spgemm_scipy(g, g), rtol=1e-5, atol=1e-6)


def test_mesh_of_one_rank(world_of_one):
    assert world_of_one.coords == (0,) and world_of_one.size("x") == 1
    assert world_of_one.device == torch.device("cpu") and not world_of_one.staged
    send = torch.arange(6, dtype=torch.int32).view(1, 6)
    assert torch.equal(world_of_one.all_to_all(send, "x"), send)
    with pytest.raises(ValueError, match="rows"):
        world_of_one.all_to_all(torch.zeros(2, 3), "x")
    with pytest.raises(ValueError, match="world size"):
        make_mesh((2,), ("x",), device="cpu")
    with pytest.raises(ValueError, match="no axis 'y'"):
        world_of_one.size("y")


def test_mesh_takes_the_card_unless_asked(world_of_one, monkeypatch):
    # outside a launched rank a mesh named no device takes card rank % cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh((1,), ("x",)).device == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="pass device='cpu'"):
        make_mesh((1,), ("x",))
    assert make_mesh((1,), ("x",), device="cpu").device == torch.device("cpu")


def test_sharded_tiled_stages():
    g = tiled_operand()
    one = shard_plan_tiled(g.to_csc(), g.to_csr(), kx=1, waste_limit=2.0)
    lens = rank_stream_lens(one, 0, 0)
    # one rank: expand and sort its stream, fill, no exchange, K2 alone
    per = one.mcap
    want = (predict_multiply_time(sum(lens), 0, 0) + predict_sort_time(lens[0])
            + GPUConfig().time(per, per * 16)
            + GPUConfig().time(per, per * 21 + 4))
    assert predict_sharded_tiled(one) == pytest.approx(want)
    four = shard_plan_tiled(g.to_csc(), g.to_csr(), kx=4, waste_limit=2.0)
    slow_link = GPUConfig(nvlink_bw_bytes=1e9)
    # the exchange rides NVLink: a slower link costs the (kx-1) buckets more
    extra = 3 * four.capacity * 8 * (1 / 1e9 - 1 / 450e9)
    assert predict_sharded_tiled(four, slow_link) - predict_sharded_tiled(four) == pytest.approx(extra)


def test_rebased_sort_charged_at_stream_length():
    # a rebased bucket sorts its own stream; charging it at the exchange
    # capacity would overcount where the stream is shorter
    m = 1 << 16
    g = COO((m, m), [0, 0, 1, m - 1, m - 1, 7], [1, m - 1, 0, m - 1, 0, 7],
            [1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    plan = shard_plan_tiled(g.to_csc(), g.to_csr(), kx=2)
    assert plan.rebase
    lens = [n for i in range(2) for n in rank_stream_lens(plan, i, 0)]
    assert all(0 < n < plan.capacity * 16 for n in lens)
    t = predict_sharded_tiled(plan)
    worst = max(predict_multiply_time(sum(rank_stream_lens(plan, i, 0)), 0, 0)
                + sum(predict_sort_time(n) for n in rank_stream_lens(plan, i, 0))
                for i in range(2))
    assert t > worst and math.isfinite(t)


def test_plan_free_estimate():
    p = 1 << 22
    one = predict_spgemm_time(p, 1000, 1000)
    assert one == pytest.approx(predict_multiply_time(p, 1000, 1000) + predict_merge_time(p))
    even = predict_spgemm_time(p, 1000, 1000, ndev=4)
    want = (predict_multiply_time(p // 4, 251, 1000) + predict_sort_time(p // 4)
            + (p // 4) * 8 * 3 / 4 / 450e9 + predict_merge_time(p // 4))
    assert even == pytest.approx(want)
    assert predict_spgemm_time(p, 1000, 1000, ndev=4, per_device_products=[p // 2] * 4) > even
