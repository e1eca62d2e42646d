"""The sharded mode stands alone: with ``jax`` and the JAX package
blocked from import in a process and in every rank it spawns (a
``sitecustomize`` on the ``PYTHONPATH`` installs the blocker in each
interpreter), the sharded programs run in a world of one gloo rank in
the process itself (the flat 1-D and 2-D programs, the tiled one with
global and rebased keys, triangles, both MCL loops, sharded serving,
the tp train step), and the command line's ``spgemm --mesh 2``,
``graph triangles --mesh 2`` and ``graph mcl --mesh 2 --loop device``
spawn their ranks (each running its job with JAX blocked) and finish;
and no source of ``shard/`` names either package."""

import os
import pathlib
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKER = r"""
import sys

class Blocker:
    BLOCKED = ("jax", "outerspace_tpu")

    def find_spec(self, name, path=None, target=None):
        for b in self.BLOCKED:
            if name == b or name.startswith(b + "."):
                raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
"""

RUN = r"""
import contextlib, io, sys, tempfile
import numpy as np
import torch.distributed as dist
from outerspace_tpu_torch import cli
from outerspace_tpu_torch.formats import COO, rmat, write_mtx
from outerspace_tpu_torch.ops.graph import triangle_count, triangle_count_sharded
from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_scipy
from outerspace_tpu_torch.shard import make_mesh, shard_plan, shard_plan_tiled, spgemm_sharded
from outerspace_tpu_torch.shard.spgemm_sharded import (
    shard_plan_2d, sharded_2d_result_to_csr, sharded_result_to_csr, spgemm_sharded_2d)
from outerspace_tpu_torch.shard.tiled import sharded_tiled_to_csr, spgemm_sharded_tiled
from outerspace_tpu_torch.convert import load_params
from outerspace_tpu_torch.formats import erdos_renyi
from outerspace_tpu_torch.nn.models import MLP1, init_lecun_normal_
from outerspace_tpu_torch.nn.sparse_infer import SparseMLP
from outerspace_tpu_torch.nn.train import TrainConfig
from outerspace_tpu_torch.ops.graph import markov_cluster, markov_cluster_sharded
from outerspace_tpu_torch.shard.mcl import markov_cluster_sharded_device
from outerspace_tpu_torch.shard.train import stage_tp, tp_train_step

t = rmat(8, edge_factor=16, seed=1)
want = spgemm_scipy(t, t)
with tempfile.TemporaryDirectory() as d:
    dist.init_process_group("gloo", init_method=f"file://{d}/rdv", world_size=1, rank=0)
    mesh, mesh2 = (make_mesh((1,), ("x",), device="cpu"),
                   make_mesh((1, 1), ("x", "y"), device="cpu"))
    plan = shard_plan(t.to_csc(), t.to_csr(), 1)
    assert_csr_allclose(sharded_result_to_csr(plan, spgemm_sharded(plan, mesh)), want, rtol=1e-5)
    plan = shard_plan_2d(t.to_csc(), t.to_csr(), 1, 1)
    assert_csr_allclose(sharded_2d_result_to_csr(plan, spgemm_sharded_2d(plan, mesh2)), want,
                        rtol=1e-5)
    for rebase in (None, True):
        plan = shard_plan_tiled(t.to_csc(), t.to_csr(), kx=1, waste_limit=2.0, rebase=rebase)
        got = sharded_tiled_to_csr(plan, spgemm_sharded_tiled(plan, mesh, "x"))
        assert_csr_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert triangle_count_sharded(t, mesh, axes="x") == triangle_count(t, backend="scipy")
    g = erdos_renyi(24, 24, 0.15, seed=4)
    ref = markov_cluster(g, iters=3, backend="scipy")
    report = {}
    got = markov_cluster_sharded_device(g, mesh, axes="x", iters=3, report=report)
    assert got.nnz == ref.nnz and report["fast_path"], report
    assert markov_cluster_sharded(g, mesh, axes="x", iters=3).nnz == ref.nnz
    params = load_params("data/saved_weights/MLP1/pruned10_finetuned.pkl")
    x = np.random.default_rng(0).random((4, 784)).astype(np.float32)
    serve = SparseMLP(params, device="cpu")
    dp = make_mesh((1,), ("dp",), device="cpu")
    assert np.array_equal(serve.sharded(dp, "dp")(x).numpy(), serve(x).numpy())
    sd = init_lecun_normal_(MLP1(), seed=0).state_dict()
    cfg = TrainConfig(l2reg=True)
    tp_mesh = make_mesh((1, 1), ("dp", "tp"), device="cpu")
    model, opt, xd, yd = stage_tp(sd, x, np.zeros(4, np.int64), cfg, tp_mesh)
    assert np.isfinite(float(tp_train_step(model, opt, xd, yd, cfg)))
    dist.destroy_process_group()
    write_mtx(d + "/t.mtx", t)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["spgemm", d + "/t.mtx", d + "/t.mtx", "--no-transpose", "--mesh", "2",
                         "--device", "cpu"]) == 0
        assert cli.main(["graph", "triangles", d + "/t.mtx", "--mesh", "2", "--device", "cpu"]) == 0
        write_mtx(d + "/g.mtx", g)
        assert cli.main(["graph", "mcl", d + "/g.mtx", "--iters", "3", "--mesh", "2", "--loop",
                         "device", "--device", "cpu"]) == 0
    text = buf.getvalue()
    assert "mcl (mesh 2x1, device loop): 7 clusters (" in text, text
    assert f"nnz: {want.nnz}" in text, text
    assert f"triangles (mesh 2x1, gloo): {triangle_count(t, backend='scipy')} (" in text, text
leaked = [m for m in sys.modules if m in ("jax", "outerspace_tpu") or m.startswith(("jax.", "outerspace_tpu."))]
assert not leaked, leaked
print("isolated")
"""


def test_sharded_mode_runs_with_jax_blocked(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(BLOCKER)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", RUN], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("isolated")


def test_shard_sources_name_neither_package():
    shard = pathlib.Path(REPO, "outerspace_tpu_torch", "shard")
    for src in shard.glob("*.py"):
        text = src.read_text()
        assert "import jax" not in text and "from jax" not in text, src
        assert "outerspace_tpu." not in text.replace("outerspace_tpu_torch.", ""), src
