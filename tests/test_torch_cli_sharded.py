"""The command line's sharded options on the CPU (``--device cpu``: gloo
ranks): ``spgemm --mesh`` on meshes 2 and 2,2 (with ``--chunks`` and
``--merge-parts``) against the JAX package's ``cli.main --mesh 4,2`` on
its 8 virtual devices and against scipy, ``--out`` read back, ``graph
triangles --mesh`` against scipy's count; and the refusals (exit 2): a
bad ``--mesh``, more ranks than cards for nccl, nccl on the CPU, ``graph
mcl --mesh`` and a route override with ``--mesh``."""

import os
import re

import pytest

from outerspace_tpu import cli as jcli
from outerspace_tpu.formats import erdos_renyi, rmat, write_mtx
from outerspace_tpu_torch import cli
from outerspace_tpu_torch.formats import read_mtx
from outerspace_tpu_torch.ops.graph import triangle_count
from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_scipy


def run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def product_lines(out):
    return re.findall(r"^(C shape: .*|multiply flops: \d+)$", out, re.M)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_sharded")
    mats = {"a": erdos_renyi(40, 30, 0.1, seed=1), "b": erdos_renyi(50, 30, 0.12, seed=2),
            "tri": rmat(7, edge_factor=8, seed=4)}
    paths = {k: str(d / f"{k}.mtx") for k in mats}
    for k, m in mats.items():
        write_mtx(paths[k], m)
    paths["dir"] = str(d)
    return paths


@pytest.fixture(scope="module")
def jax_lines(files):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(["spgemm", files["a"], files["b"], "--mesh", "4,2"]) == 0
    return product_lines(buf.getvalue())


@pytest.mark.parametrize("mesh,extra", [("2", []), ("2,2", ["--chunks", "2", "--merge-parts", "2"])],
                         ids=["mesh2", "mesh2x2_chunks2_parts2"])
def test_spgemm_mesh_on_cpu(files, capsys, jax_lines, mesh, extra):
    out_path = os.path.join(files["dir"], f"c_{mesh.replace(',', 'x')}.mtx")
    rc, out, err = run(cli.main, ["spgemm", files["a"], files["b"], "--mesh", mesh, *extra,
                                  "--device", "cpu", "--out", out_path], capsys)
    assert rc == 0, err
    assert product_lines(out) == jax_lines
    kx, _, ny = mesh.partition(",")
    assert f"mesh: {kx}x{ny or 1} over" in out and "backend=gloo" in out
    if extra:
        assert "2 chunk(s), 2 merge part(s)" in out
    assert re.search(r"^measured \(sharded, warm, median of 3\): [\d.]+ ms", out, re.M)
    assert re.search(r"^analytical sharded \(roofline\): +[\d.]+ ms", out, re.M)
    a, b = read_mtx(files["a"]), read_mtx(files["b"]).transpose()
    assert_csr_allclose(read_mtx(out_path).to_csr(), spgemm_scipy(a, b), rtol=1e-5, atol=1e-6)


def test_graph_triangles_mesh_on_cpu(files, capsys):
    rc, out, err = run(cli.main, ["graph", "triangles", files["tri"], "--mesh", "2,2",
                                  "--device", "cpu"], capsys)
    assert rc == 0, err
    want = triangle_count(read_mtx(files["tri"]), backend="scipy")
    assert re.search(rf"^triangles \(mesh 2x2, gloo\): {want} \(", out, re.M)


@pytest.mark.parametrize("mesh", ["2x2", "0", "1,2,3", "a"])
def test_bad_mesh_exits_2(files, capsys, mesh):
    rc, out, err = run(cli.main, ["spgemm", files["a"], files["b"], "--mesh", mesh,
                                  "--device", "cpu"], capsys)
    assert rc == 2 and out == "" and "bad --mesh" in err


@pytest.mark.parametrize("argv,message", [
    (["spgemm", "{a}", "{b}", "--mesh", "2"], "needs 2 cards for nccl"),
    (["spgemm", "{a}", "{b}", "--mesh", "2", "--device", "cpu", "--dist-backend", "nccl"],
     "--device cpu uses gloo"),
    (["spgemm", "{a}", "{b}", "--mesh", "1", "--dist-backend", "gloo"], "needs a CUDA device"),
    (["graph", "triangles", "{tri}", "--mesh", "4,2"], "needs 8 cards for nccl"),
    (["graph", "triangles", "{tri}", "--mesh", "2", "--strategy", "dense", "--device", "cpu"],
     "cannot be combined"),
    (["graph", "mcl", "{tri}", "--mesh", "2", "--device", "cpu"], cli.NOT_PORTED),
], ids=["too_many_ranks_for_nccl", "nccl_on_cpu", "gloo_without_card", "triangles_nccl",
        "route_override", "mcl_mesh"])
def test_refusals_exit_2(files, capsys, argv, message):
    rc, out, err = run(cli.main, [x.format(**files) for x in argv], capsys)
    assert rc == 2 and out == ""
    assert message in err
    assert "--dist-backend gloo" in err or message != "needs 2 cards for nccl"
