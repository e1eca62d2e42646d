"""The port's sharded NN paths and its multi-device dryrun on the CPU
(gloo worlds of CPU ranks):

- ``SparseMLP.sharded`` on (8,) with the committed MLP1 weights: each
  rank's whole-batch logits bit-equal to the single-rank port forward;
  the JAX package's ``SparseMLP.sharded`` on its 8 virtual devices is
  bit-equal to its own single-device forward, and the port's logits are
  within the sparse-NN bar of it (1e-5 relative to the largest |y|: the
  kernels sum in other orders, so the two packages are not bit-equal);
  a batch that does not divide the axis raises;
- the dp × tp MLP1 step (``shard.train``) on (4, 2) and (2, 2), from the
  flax-initialised parameters, against the JAX package's ``loss_fn`` and
  optax Adam step in float64 (losses and parameters within 1e-10), and
  in float32 against the port's single-device ``train_step``; the
  shards round-trip through ``shard_params`` / ``unshard_params``;
- ``dryrun_multichip(8)`` and ``(4)`` print the numbers of the JAX
  package's multi-device record (MULTICHIP_r05: nnz 4546 / 4546 / 5401 /
  5401, rebased 8, 416 triangles, MCL nnz 287 in 7 clusters,
  bit-identical serving; the train loss against the single-rank step)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from outerspace_tpu.nn import train as jt
from outerspace_tpu.nn.models import make_model as jmake
from outerspace_tpu_torch.convert import load_params, state_dict_from_params
from outerspace_tpu_torch.nn import data
from outerspace_tpu_torch.nn import train as tt

REL = 1e-5  # the sparse-NN bar (tests/test_torch_nn.py)
MLP1 = "data/saved_weights/MLP1/pruned10_finetuned.pkl"
TRAIN = {"4x2": (8, (4, 2)), "2x2": (4, (2, 2))}


@pytest.fixture(scope="module")
def mnist():
    return data.synthetic_mnist(512, seed=0)


def flax_params(x):
    return jmake("MLP1").init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))["params"]


def as_state_dict(p, dtype):
    host = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
    return {k: v.to(dtype) for k, v in state_dict_from_params(host).items()}


def train_jobs(world, mnist):
    x, y = mnist["train"][0][:128].reshape(128, -1), mnist["train"][1][:128]
    p = flax_params(x)
    cfg = tt.TrainConfig(l2reg=True)
    return [dict(program="train", mesh=shape, state_dict=as_state_dict(p, dtype), cfg=cfg,
                 x=x.astype(np.float64 if dtype == torch.float64 else np.float32), y=y,
                 steps=3)
            for w, shape in TRAIN.values() if w == world for dtype in (torch.float64,
                                                                        torch.float32)]


def world_jobs(world, mnist):
    """The jobs of the world of ``world`` ranks: serving (8 only), then
    the tp steps."""
    x = mnist["test"][0][:16].reshape(16, -1)
    serve = [dict(program="serve", mesh=(8,), params=load_params(MLP1), x=x)]
    return (serve if world == 8 else []) + train_jobs(world, mnist)


@pytest.fixture(scope="module")
def worlds(mnist):
    from outerspace_tpu_torch.shard.mesh import run_world
    from outerspace_tpu_torch.shard.world import run_jobs

    out = {}
    for world in (8, 4):
        jobs = world_jobs(world, mnist)
        res = run_world(run_jobs, world, backend="gloo", device="cpu", args=(jobs,), timeout=600)
        out[world] = [[r[i] for r in res] for i in range(len(jobs))]
    return out


def train_result(worlds, mnist, mesh, dtype):
    """(the job, every rank's result) of the tp step on ``mesh`` in ``dtype``."""
    world, shape = TRAIN[mesh]
    for i, job in enumerate(world_jobs(world, mnist)):
        if (job["program"] == "train" and job["mesh"] == shape
                and job["state_dict"]["dense.0.bias"].dtype == dtype):
            return job, worlds[world][i]
    raise KeyError(mesh)


def test_sharded_serving_bit_equal(worlds, mnist):
    from outerspace_tpu.nn.sparse_infer import SparseMLP as JSparseMLP
    from outerspace_tpu.shard import make_mesh
    from outerspace_tpu_torch.nn.sparse_infer import SparseMLP

    params = load_params(MLP1)
    x = mnist["test"][0][:16].reshape(16, -1)
    single = SparseMLP(params, device="cpu")(x).numpy()
    for r, res in enumerate(worlds[8][0]):
        assert np.array_equal(res["logits"], single), f"rank {r}"
        assert set(res["launches"].values()) == {0}  # the plain versions on the CPU
    jmodel = JSparseMLP(params, interpret=True)
    mesh = make_mesh((8,), ("dp",), devices=jax.devices()[:8])
    jax_sharded = np.asarray(jmodel.sharded(mesh, axis="dp")(x))
    assert np.array_equal(jax_sharded, np.asarray(jmodel(x)))
    assert np.abs(single - jax_sharded).max() <= REL * np.abs(jax_sharded).max()


def test_serving_batch_must_divide_the_axis():
    import tempfile

    import torch.distributed as dist

    from outerspace_tpu_torch.nn.sparse_infer import SparseMLP
    from outerspace_tpu_torch.shard.mesh import make_mesh

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rdv", world_size=1, rank=0)
        try:
            mesh = make_mesh((1,), ("dp",), device="cpu")
            model = SparseMLP(load_params(MLP1), device="cpu")
            x = np.zeros((3, 784), np.float32)
            assert np.array_equal(model.sharded(mesh, "dp")(x).numpy(), model(x).numpy())
            meta = make_mesh((1,), ("dp",), device="meta")
            with pytest.raises(ValueError, match="weights are on cpu"):
                model.sharded(meta, "dp")
        finally:
            dist.destroy_process_group()

    class TwoRanks:  # rank 0 of a 2-rank axis; the batch is checked before any collective
        device = torch.device("cpu")
        size = staticmethod(lambda axis: 2)
        index = staticmethod(lambda axis: 0)

    with pytest.raises(ValueError, match="batch 3 does not divide the 2 ranks"):
        model.sharded(TwoRanks(), "dp")(x)


def jax_three_steps(p32, x, y):
    cfg = jt.TrainConfig(l2reg=True)
    model = jmake("MLP1")
    with jax.enable_x64(True):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), p32)
        tx = optax.adam(cfg.lr)
        state = tx.init(p)
        losses = []
        for _ in range(3):
            p, state, loss, _ = jt.train_step(p, state, jnp.asarray(x, jnp.float64),
                                              jnp.asarray(y), None, apply_fn=model.apply,
                                              cfg=cfg, tx=tx)
            losses.append(float(loss))
        return losses, {k: as_state_dict_64(v, k) for k, v in p.items()}


def as_state_dict_64(layer, name):
    i = name.split("_")[1]
    return {f"dense.{i}.weight": np.asarray(layer["kernel"], np.float64).T,
            f"dense.{i}.bias": np.asarray(layer["bias"], np.float64)}


@pytest.mark.parametrize("mesh", list(TRAIN))
def test_tp_step_equals_jax_float64(worlds, mnist, mesh):
    job, ranks = train_result(worlds, mnist, mesh, torch.float64)
    x, y = mnist["train"][0][:128].reshape(128, -1), mnist["train"][1][:128]
    jlosses, jparams = jax_three_steps(flax_params(x), x, y)
    want = {k: v for layer in jparams.values() for k, v in layer.items()}
    for res in ranks:
        np.testing.assert_allclose(res["losses"], jlosses, rtol=0, atol=1e-10)
    got = ranks[0]["state_dict"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-10, err_msg=k)
    assert job["steps"] == 3 and job["cfg"].l2reg


@pytest.mark.parametrize("mesh", list(TRAIN))
def test_tp_step_equals_single_rank_float32(worlds, mnist, mesh):
    job, ranks = train_result(worlds, mnist, mesh, torch.float32)
    model = tt.load_model("MLP1", job["state_dict"], device="cpu")
    opt = tt.make_optimizer(model, job["cfg"])
    xt, yt = torch.from_numpy(job["x"]), torch.from_numpy(job["y"]).long()
    losses = [float(tt.train_step(model, opt, xt, yt, job["cfg"])[0]) for _ in range(3)]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    for k, v in model.state_dict().items():
        got = ranks[0]["state_dict"][k]
        assert np.abs(got - v.numpy()).max() <= 1e-5 * float(v.abs().max()), k


def test_shard_round_trip_and_refusals():
    import tempfile

    import torch.distributed as dist

    from outerspace_tpu_torch.nn.models import MLP1, init_lecun_normal_
    from outerspace_tpu_torch.shard.mesh import make_mesh
    from outerspace_tpu_torch.shard.train import shard_params, tp_shape, unshard_params

    sd = init_lecun_normal_(MLP1(), seed=3).state_dict()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rdv", world_size=1, rank=0)
        try:
            assert [tp_shape(n) for n in (1, 3, 4, 8)] == [(1, 1), (3, 1), (2, 2), (4, 2)]
            mesh = make_mesh(tp_shape(1), ("dp", "tp"), device="cpu")
            local = shard_params(sd, mesh)
            back = unshard_params(local, mesh)
            assert all(torch.equal(back[k], sd[k]) for k in sd)
            with pytest.raises(ValueError, match="MLP1 state_dict"):
                shard_params({"dense.0.weight": sd["dense.0.weight"]}, mesh)
            assert make_mesh((1,), ("x",), device="cpu").psum(torch.ones(2), "x").tolist() == [1, 1]
        finally:
            dist.destroy_process_group()


RECORD = ("sharded spgemm nnz=4546, 2-D ({k}) spgemm nnz=4546, pallas-tiled sharded nnz=5401 "
          "(1-D) / 5401 (2-D), rebased 2^32-key nnz=8 (exact), triangles_sharded=416 (exact), "
          "mcl_sharded nnz=287 clusters=7 (exact, host and device loops), sparse-serving dp={n} "
          "bit-identical")


@pytest.mark.parametrize("n,dims", [(8, "4x2"), (4, "2x2")])
def test_dryrun_multichip(n, dims, capsys):
    from outerspace_tpu_torch.shard.dryrun import dryrun_multichip

    line = dryrun_multichip(n, device="cpu")
    assert line in capsys.readouterr().out
    dp = n // 2
    assert line.startswith(f"dryrun_multichip OK: mesh dp={dp} tp=2, train loss=")
    assert line.endswith(RECORD.format(k=dims, n=n))
    loss, one = re.search(r"train loss=([\d.]+) \(one rank ([\d.]+)\)", line).groups()
    assert loss == one
