"""The port's command line (``spgemm``, ``graph``) against the JAX
package's ``cli.main`` on the same files, both on the CPU (JAX with its
Pallas kernels in interpret mode): the shape, nnz and FLOP lines, the
``--out`` files (structure equal, values within rtol 1e-5), the triangle
and cluster counts; ``--set`` reaching ``spgemm``; exit 2 on a dimension
mismatch, on ``bench --only`` of a workload the suite has not, on a mesh
that the cards cannot hold, and on a mesh ``predict`` cannot read;
``graph mcl --mesh --loop {host,device}`` on the CPU against the JAX
package's on its 8 virtual devices (``tests/test_torch_cli_sharded.py``
runs the other sharded options)."""

import importlib
import os
import re

import numpy as np
import pytest

from outerspace_tpu import cli as jcli
from outerspace_tpu.config import Config as JConfig
from outerspace_tpu.formats import erdos_renyi, rmat, write_mtx
from outerspace_tpu_torch import cli
from outerspace_tpu_torch.config import Config
from outerspace_tpu_torch.formats import read_mtx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RMAT10 = os.path.join(REPO, "data", "mtx", "rmat10_ef8.mtx")
_JAX_RUNS: dict = {}  # one JAX run per argument list, shared by the cases


def run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def jax_run(argv, capsys):
    key = tuple(argv)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = run(jcli.main, argv, capsys)
    return _JAX_RUNS[key]


def port_run(argv, capsys):
    return run(cli.main, [*argv, "--device", "cpu"], capsys)


def product_lines(out):
    """The lines both command lines print alike: C's shape and nnz, and
    the multiply flops."""
    return re.findall(r"^(C shape: .*|multiply flops: \d+)$", out, re.M)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    mats = {"a": erdos_renyi(40, 30, 0.1, seed=1), "b": erdos_renyi(50, 30, 0.12, seed=2),
            "c": erdos_renyi(50, 20, 0.1, seed=3), "tri": rmat(7, edge_factor=8, seed=4),
            "mcl": rmat(6, edge_factor=8, seed=7)}
    paths = {k: str(d / f"{k}.mtx") for k in mats}
    for k, m in mats.items():
        write_mtx(paths[k], m)
    paths["dir"] = str(d)
    return paths


@pytest.mark.parametrize("strategy", ["auto", "gather", "tiles", "flat"])
def test_spgemm_square_equal_jax(capsys, strategy):
    argv = ["spgemm", RMAT10, RMAT10, "--no-transpose"]
    jrc, jout, jerr = jax_run(argv, capsys)
    rc, out, err = port_run([*argv, "--strategy", strategy], capsys)
    assert rc == jrc == 0, err + jerr
    assert product_lines(out) == product_lines(jout) and len(product_lines(out)) == 2
    assert "C shape: (1024, 1024), nnz: 140283" in out
    for line in ("analytical multiply (roofline):", "analytical merge (roofline):",
                 "measured (end-to-end):", "GFlops:"):
        assert line in out and line in jout
    ran = re.search(r"^strategy: (\w+)", out, re.M).group(1)
    assert ran == strategy or (strategy == "auto" and ran in ("gather", "tiles", "flat"))


def test_spgemm_transposed_out_equal_jax(capsys, files):
    jpath, path = os.path.join(files["dir"], "jax_out.mtx"), os.path.join(files["dir"], "out.mtx")
    jrc, jout, jerr = jax_run(["spgemm", files["a"], files["b"], "--out", jpath], capsys)
    rc, out, err = port_run(["spgemm", files["a"], files["b"], "--out", path], capsys)
    assert rc == jrc == 0, err + jerr
    assert product_lines(out) == product_lines(jout)
    assert f"wrote {path}" in out and "C shape: (40, 50)" in out
    got, want = read_mtx(path).to_csr(), read_mtx(jpath).to_csr()
    assert got.shape == want.shape == (40, 50)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-5)


def test_set_reaches_spgemm(capsys, monkeypatch):
    sp = importlib.import_module("outerspace_tpu_torch.ops.spgemm")
    seen = []
    real = sp.spgemm

    def spy(*a, **kw):
        seen.append((kw["strategy"], kw["config"].waste_limit))
        return real(*a, **kw)

    monkeypatch.setattr(sp, "spgemm", spy)
    rc, out, err = port_run(["spgemm", RMAT10, RMAT10, "--no-transpose", "--strategy", "tiles",
                             "--set", "waste_limit=3.0"], capsys)
    assert rc == 0, err
    assert seen == [("tiles", 3.0)] * 2  # the warm call and the timed one
    assert "strategy: tiles (waste limit 3.0," in out
    assert Config().override(["waste_limit=3.0"]).waste_limit == \
        JConfig().override(["waste_limit=3.0"]).waste_limit == 3.0
    assert Config().override(["waste_limit=x"]).waste_limit == "x"
    for cfg in (Config(), JConfig()):
        with pytest.raises(KeyError):
            cfg.override(["bogus=1"])
    with pytest.raises(KeyError):
        port_run(["spgemm", RMAT10, RMAT10, "--set", "bogus=1"], capsys)


def test_dimension_mismatch_exits_2(capsys, files):
    argv = ["spgemm", files["a"], files["c"], "--no-transpose"]
    jrc, _, jerr = jax_run(argv, capsys)
    rc, out, err = port_run(argv, capsys)
    assert rc == jrc == 2
    assert "dimension mismatch: (40, 30) @ (50, 20)" in err and "dimension mismatch" in jerr
    assert out == ""


NO_CARD = "needs 8 cards for nccl"  # the sharded options are ported: nccl wants a card a rank


@pytest.mark.parametrize("argv,message", [
    (["spgemm", "A", "B", "--mesh", "4,2"], NO_CARD),
    (["spgemm", "A", "B", "--mesh", "8", "--chunks", "2"], NO_CARD),
    (["spgemm", "A", "B", "--mesh", "8", "--merge-parts", "2"], NO_CARD),
    (["graph", "triangles", "G", "--mesh", "2,4"], NO_CARD),
    (["graph", "mcl", "G", "--mesh", "4,2", "--loop", "device"], NO_CARD),
    # predict is ported: it runs on the host and reads its mesh first
    (["predict", "A", "B", "--mesh", "4,0"], "bad --mesh '4,0': expected KX or KX,NY"),
    # bench is ported: it names the suite's workloads before it looks for a card
    (["bench", "--only", "nosuch"], "unknown workload(s) ['nosuch']; the workloads: rmat14_ef8"),
], ids=["spgemm_mesh", "chunks", "merge_parts", "graph_mesh", "loop", "predict", "bench"])
def test_unported_options_exit_2(capsys, argv, message):
    # with no card here, the default --device cuda refuses a mesh before
    # reading any file; every subcommand of the JAX command line is ported
    rc, out, err = run(cli.main, argv, capsys)
    assert rc == 2 and out == ""
    assert message in err
    assert not hasattr(cli, "NOT_PORTED")


@pytest.mark.parametrize("loop", ["host", "device"])
def test_graph_mcl_mesh_equal_jax(capsys, files, loop):
    # the sharded MCL by either loop: the JAX package's on its 8 virtual
    # devices (4x2), the port's in a gloo world of 4 CPU ranks (2x2)
    jrc, jout, jerr = jax_run(["graph", "mcl", files["mcl"], "--iters", "3", "--mesh", "4,2",
                               "--loop", loop], capsys)
    rc, out, err = port_run(["graph", "mcl", files["mcl"], "--iters", "3", "--mesh", "2,2",
                             "--loop", loop], capsys)
    assert rc == jrc == 0, err + jerr
    line = rf"^mcl \(mesh (\dx\d), {loop} loop\): (\d+) clusters \("
    (jmesh, jn), (mesh, n) = (re.search(line, t, re.M).groups() for t in (jout, out))
    assert (jmesh, mesh) == ("4x2", "2x2") and n == jn
    rc, out, _ = port_run(["graph", "mcl", files["mcl"], "--iters", "3", "--backend", "scipy"],
                          capsys)
    assert rc == 0 and re.search(r"^mcl: (\d+) clusters", out, re.M).group(1) == n


@pytest.mark.parametrize("strategy", ["auto", "dense", "sparse"])
def test_graph_triangles_equal_jax(capsys, files, strategy):
    jrc, jout, jerr = jax_run(["graph", "triangles", files["tri"]], capsys)
    rc, out, err = port_run(["graph", "triangles", files["tri"], "--strategy", strategy], capsys)
    assert rc == jrc == 0, err + jerr
    count = re.search(r"^triangles: (\d+) \(", out, re.M).group(1)
    assert count == re.search(r"^triangles: (\d+) \(", jout, re.M).group(1)
    rc, out, _ = port_run(["graph", "triangles", files["tri"], "--backend", "scipy"], capsys)
    assert rc == 0 and re.search(r"^triangles: (\d+) \(", out, re.M).group(1) == count


@pytest.mark.parametrize("backend", ["torch", "scipy"])
def test_graph_mcl_equal_jax(capsys, files, backend, monkeypatch, tmp_path):
    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(tmp_path / "sizing.json"))
    jrc, jout, jerr = jax_run(["graph", "mcl", files["mcl"], "--iters", "4",
                               "--backend", {"torch": "tpu", "scipy": "scipy"}[backend]], capsys)
    rc, out, err = port_run(["graph", "mcl", files["mcl"], "--iters", "4", "--backend", backend],
                            capsys)
    assert rc == jrc == 0, err + jerr
    clusters = re.search(r"^mcl: (\d+) clusters", out, re.M).group(1)
    assert clusters == re.search(r"^mcl: (\d+) clusters", jout, re.M).group(1)
    if backend == "torch":  # the staged chain ran on its fast path: the model's line
        assert re.search(r"^analytical model: [\d.]+ ms$", out, re.M)
    else:
        assert "analytical model" not in out
