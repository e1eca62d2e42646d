"""The port stands alone: with ``jax`` and the JAX package blocked from
import, every module of ``outerspace_tpu_torch`` imports, the SpGEMM
main path runs on the CPU (gather, tiles, flat and "auto", with the
native planner core), triangles are counted by both routes, a
``SparseMLP`` serves one forward with the committed weights, Markov
clustering runs through its staged chain and its host loop, the NN
pipeline takes a training step, prunes, exports and trains through the
``nn`` CLI, and the CLI's ``spgemm`` (one operand gzipped) and ``graph
triangles`` run with a ``.gz`` file read by the native reader, the event
model passes its selftests, the residency study runs and ``predict``
models a mesh; and no source of the port names either."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED_RUN = r"""
import importlib, pkgutil, sys

class Blocker:
    BLOCKED = ("jax", "outerspace_tpu")

    def find_spec(self, name, path=None, target=None):
        for b in self.BLOCKED:
            if name == b or name.startswith(b + "."):
                raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
for b in Blocker.BLOCKED:
    for mod in [m for m in sys.modules if m == b or m.startswith(b + ".")]:
        del sys.modules[mod]

import outerspace_tpu_torch
names = [m.name for m in pkgutil.walk_packages(outerspace_tpu_torch.__path__, "outerspace_tpu_torch.")]
for name in names:
    importlib.import_module(name)
try:
    import jax  # noqa: F401
except ImportError:
    pass
else:
    raise SystemExit("blocker failed")

from outerspace_tpu_torch.formats import rmat
from outerspace_tpu_torch.ops import assert_csr_allclose, spgemm, spgemm_scipy

a = rmat(6, edge_factor=8, seed=5)
assert_csr_allclose(spgemm(a, a, device="cpu"), spgemm_scipy(a, a), rtol=1e-5)
# the tiled strategy: K3 (packed) and K4 (packed=False) on tile classes
from outerspace_tpu_torch.ops.spgemm import plan_tiled
t = rmat(8, edge_factor=16, seed=1)
assert plan_tiled(t.to_csc(), t.to_csr(), waste_limit=2.0, device="cpu").class_tables()
for packed in (None, False):
    got = spgemm(t, t, strategy="tiles", packed=packed, device="cpu")
    assert_csr_allclose(got, spgemm_scipy(t, t), rtol=1e-5, atol=1e-6)
# the flat strategy, the strategy pick and the native planner core
from outerspace_tpu_torch.sched import gplanner
from outerspace_tpu_torch.sched.planner import choose_strategy
assert choose_strategy(t.to_csc(), t.to_csr()) in ("gather", "tiles", "flat")
assert gplanner._gplan_library().osp_plan_subtiles
for strategy in ("flat", "auto"):
    got = spgemm(t, t, strategy=strategy, device="cpu")
    assert_csr_allclose(got, spgemm_scipy(t, t), rtol=1e-5, atol=1e-6)
# triangle counting by both routes
from outerspace_tpu_torch.ops.graph import triangle_count
tri = triangle_count(a, backend="scipy")
assert tri > 0 and all(triangle_count(a, strategy=s, device="cpu") == tri
                       for s in ("dense", "sparse"))
# sparse-NN inference: the committed pickles load without JAX
import numpy as np
from outerspace_tpu_torch.convert import load_params
from outerspace_tpu_torch.nn.data import synthetic_mnist
from outerspace_tpu_torch.nn.sparse_infer import SparseMLP, mlp_forward_dense
p = load_params("data/saved_weights/MLP1/pruned10_finetuned.pkl")
xs = synthetic_mnist(80, seed=0)["test"][0]
ref = mlp_forward_dense(p, xs)
y = SparseMLP(p, device="cpu")(xs).numpy()
assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()
# Markov clustering: the staged chain's entry points and the host loop
from outerspace_tpu_torch.ops.graph import (
    _mcl_setup, markov_cluster, mcl_clusters, mcl_prepare, mcl_run)
ref = markov_cluster(t, iters=3, backend="scipy")
prep = mcl_prepare(_mcl_setup(t), iters=3, device="cpu")
for _ in range(2):  # the sizing sweep, then its budgets
    flow = mcl_run(prep).to_csr()
    assert flow.nnz == ref.nnz and np.abs(flow.to_dense() - ref.to_dense()).max() <= 1e-4
assert len(mcl_clusters(flow)) == len(mcl_clusters(ref)) > 0
assert markov_cluster(t, iters=3, expansion=3, device="cpu").nnz > 0
# the NN training pipeline: one step, pruning, export and the nn CLI
import contextlib, io, tempfile
import torch
from outerspace_tpu_torch import cli
from outerspace_tpu_torch.nn import models, prune, train
from outerspace_tpu_torch.nn.export import export_mlp1
model = models.init_lecun_normal_(models.make_model("MLP1"), 0)
cfg = train.TrainConfig(l2reg=True)
loss, acc = train.train_step(model, train.make_optimizer(model, cfg), torch.from_numpy(xs),
                             torch.zeros(len(xs), dtype=torch.long), cfg)
assert torch.isfinite(loss)
pruned = prune.prune_params(model.state_dict())
assert prune.sparsity_report(pruned)["dense.0.weight"][0] == 7840
with tempfile.TemporaryDirectory() as d:
    assert len(export_mlp1(pruned, xs, d, device="cpu")) == 7
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["nn", "--mode", "train", "--device", "cpu", "--data", "synthetic",
                         "--num_epochs", "1", "--saved_model_name", d + "/m.pkl"]) == 0
    assert sorted(load_params(d + "/m.pkl")) == ["Dense_0", "Dense_1", "Dense_2"]
# the command line's spgemm and graph, and a .gz file through the native reader
import gzip, shutil
from outerspace_tpu_torch.formats import read_mtx, write_mtx
with tempfile.TemporaryDirectory() as d:
    write_mtx(d + "/t.mtx", t)
    with open(d + "/t.mtx", "rb") as src, gzip.open(d + "/t.mtx.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    back = read_mtx(d + "/t.mtx.gz")
    assert np.array_equal(back.to_dense(), t.to_dense())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["spgemm", d + "/t.mtx.gz", d + "/t.mtx", "--no-transpose",
                         "--device", "cpu"]) == 0
        assert cli.main(["graph", "triangles", d + "/t.mtx", "--device", "cpu"]) == 0
    text = buf.getvalue()
    assert f"nnz: {spgemm_scipy(t, t).nnz}" in text
    assert f"triangles: {triangle_count(t, backend='scipy')} (" in text
# the event model (its g++ build), the policies and the CLI's predict
from outerspace_tpu_torch.perf import perfsim
from outerspace_tpu_torch.sched import policies
assert perfsim.selftests() == {"fifo": 0, "arbiter": 0, "ici": 0, "rowbuffer": 0}
assert perfsim.get_config()["topology"] == "switch"
assert policies.simulate_lru(policies.task_b_stream(t.to_csc(), t.to_csr()), 4)[1] > 0
with tempfile.TemporaryDirectory() as d:
    write_mtx(d + "/t.mtx", t)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["predict", d + "/t.mtx", d + "/t.mtx", "--mesh", "4,2"]) == 0
    assert "event-model sharded:" in buf.getvalue()
leaked = [m for m in sys.modules if m in Blocker.BLOCKED or m.startswith(("jax.", "outerspace_tpu."))]
assert not leaked, leaked
print("isolated", len(names))
"""


def test_port_imports_and_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("isolated")
    assert int(out.stdout.split()[1]) >= 45


def port_sources():
    root = os.path.join(REPO, "outerspace_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_name_no_jax():
    sources = list(port_sources())
    assert len(sources) >= 56
    for path in sources:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        for banned in ("outerspace_tpu.", "import jax"):
            assert banned not in text, f"{path} contains {banned!r}"
