"""The command line's event model: ``predict`` (host only, any mesh) and
the event-model lines of ``spgemm`` and ``spgemm --mesh``, on the CPU.
``predict``'s FLOP and plan-size lines equal the JAX package's
``cli.main`` on the same files and meshes (the JAX cost weights set in
the port first); a bad mesh exits 2 in both packages with the JAX
message; a failure in the model fails the command."""

import os
import re

import pytest

from outerspace_tpu import cli as jcli
from outerspace_tpu.formats import erdos_renyi, rmat, write_mtx
from outerspace_tpu.sched import autotune as jat
from outerspace_tpu_torch import cli
from outerspace_tpu_torch.perf import perfsim
from outerspace_tpu_torch.sched import autotune as tat
from outerspace_tpu_torch.sched import planner as tpl

import torch_cases  # tests/ is on sys.path under pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RMAT10 = os.path.join(REPO, "data", "mtx", "rmat10_ef8.mtx")
PREDICT_LINES = (r"multiply flops: \d+", r"mesh \d+x\d+ \((global|rebased per-bucket) keys\): "
                 r"per-device stream \d+, exchange capacity \d+ x\d+ chunk\(s\), merge \d+ "
                 r"part\(s\) x \d+",
                 r"analytical sharded \(roofline\):\s+[\d.]+ ms",
                 r"event-model sharded:\s+[\d.]+ ms \(front \d+ cyc, exchange \d+ cyc, max link "
                 r"busy \d+ cyc\)")


@pytest.fixture(autouse=True)
def jax_weights(monkeypatch):
    torch_cases.set_jax_cost_weights(monkeypatch, jat, tat, tpl.TILE_A_CLASSES)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("predict")
    mats = {"rmat": rmat(8, edge_factor=8, seed=3), "a": erdos_renyi(40, 30, 0.1, seed=1),
            "b": erdos_renyi(50, 30, 0.12, seed=2)}
    paths = {k: str(d / f"{k}.mtx") for k in mats}
    for k, m in mats.items():
        write_mtx(paths[k], m)
    return paths


def run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def plan_lines(out):
    """The lines both packages' ``predict`` print alike."""
    return re.findall(r"^(multiply flops: \d+|mesh \d+x\d+ .*)$", out, re.M)


@pytest.mark.parametrize("operands,mesh", [
    (("rmat", "rmat", "--no-transpose"), "1"), (("rmat", "rmat", "--no-transpose"), "4"),
    (("rmat", "rmat", "--no-transpose"), "2,2"), (("rmat", "rmat", "--no-transpose"), "4,2"),
    (("a", "b"), "3"), ((RMAT10, RMAT10), "8"),
], ids=["rmat8_1", "rmat8_4", "rmat8_2x2", "rmat8_4x2", "rect_3", "rmat10_8"])
def test_predict_equal_jax(capsys, files, operands, mesh):
    argv = ["predict", *(files.get(o, o) for o in operands), "--mesh", mesh]
    rc, out, err = run(cli.main, argv, capsys)
    jrc, jout, jerr = run(jcli.main, argv, capsys)
    assert rc == jrc == 0, err + jerr
    for pattern in PREDICT_LINES:
        assert re.search(pattern, out), (pattern, out)
    assert plan_lines(out) == plan_lines(jout) and len(plan_lines(out)) == 2
    assert len(out.strip().splitlines()) == len(PREDICT_LINES)


@pytest.mark.parametrize("mesh", ["0", "2,x", "1,2,3", "-1"])
def test_bad_mesh_exits_2_in_both(capsys, files, mesh):
    argv = ["predict", files["rmat"], files["rmat"], "--mesh", mesh]
    rc, out, err = run(cli.main, argv, capsys)
    jrc, jout, jerr = run(jcli.main, argv, capsys)
    assert rc == jrc == 2 and out == jout == ""
    message = f"bad --mesh {mesh!r}: expected KX or KX,NY"
    assert message in err and message in jerr


def test_spgemm_prints_the_event_model(capsys):
    rc, out, err = run(cli.main, ["spgemm", RMAT10, RMAT10, "--strategy", "tiles", "--set",
                                  "waste_limit=3.0", "--device", "cpu"], capsys)
    assert rc == 0, err
    for pattern in (r"analytical multiply \(roofline\): [\d.]+ ms",
                    r"analytical merge \(roofline\):\s+[\d.]+ ms",
                    r"event-model multiply:\s+[\d.]+ ms \(on-chip B-group hit rate \d+%\)",
                    r"event-model merge:\s+[\d.]+ ms \(parts=\d+, sort util \d+%\)",
                    r"measured \(end-to-end\): [\d.]+ ms"):
        assert re.search(pattern, out), (pattern, out)
    # the tiles at this waste limit run through the modelled class tables
    assert float(re.search(r"event-model multiply:\s+([\d.]+) ms", out).group(1)) > 0


def test_spgemm_mesh_prints_the_event_model(capsys, files):
    rc, out, err = run(cli.main, ["spgemm", files["rmat"], files["rmat"], "--no-transpose",
                                  "--mesh", "2", "--device", "cpu", "--dist-backend", "gloo"],
                       capsys)
    assert rc == 0, err
    for pattern in (r"analytical sharded \(roofline\):\s+[\d.]+ ms", PREDICT_LINES[-1],
                    r"measured \(sharded, warm, median of \d\): [\d.]+ ms"):
        assert re.search(pattern, out), (pattern, out)


def test_model_failure_fails_the_command(capsys, files, monkeypatch):
    def broken(*args, **kw):
        raise RuntimeError("model broke")

    monkeypatch.setattr(perfsim, "simulate_sharded_tiled", broken)
    with pytest.raises(RuntimeError, match="model broke"):
        cli.main(["predict", files["rmat"], files["rmat"], "--mesh", "2"])
    monkeypatch.setattr(perfsim, "simulate_merge_parts", broken)
    with pytest.raises(RuntimeError, match="model broke"):
        cli.main(["spgemm", files["a"], files["b"], "--device", "cpu"])
