"""The port's benchmark suite (``outerspace_tpu_torch.bench``) against the
JAX package's (the root ``bench.py``): the workload table's operands
bit-equal to the JAX package's generators at full size; the headline
rule equal to ``bench._print_headline`` on the same records, except that
a failed record zeroes the port's; ``bench --small --device cpu`` with
``jax`` and the JAX package blocked in the process and in the ranks it
spawns (one headline line, one exact record per workload); the deadline
shedding every workload after the first; and a workload that raises, an
inexact product and a C++ reference that does not build, each making
the run exit 1."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import bench as jbench  # the JAX package's suite: numpy only at import
from outerspace_tpu import formats as jf
from outerspace_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [name for name, _, _ in bench.WORKLOADS]
HEAD_KEYS = {"metric", "value", "unit", "vs_baseline", "records"}
A2_KEYS = {"name", "strategy", "t_plan_s", "t_plan_cpu_s", "nnz_in", "nnz_out", "flops", "p_pad",
           "t_cpu_ref_s", "t_scipy_s", "t_gpu_s", "t_e2e_s", "t_first_s", "speedup",
           "speedup_e2e", "speedup_vs_scipy", "gpu_gflops", "gpu_mnnz_per_s", "nnz_exact",
           "values_match", "elementwise_exact", "launches", "wall_s", "at_s"}
KEYS = {
    "mlp": {"weights", "batch", "t_gpu_s", "t_cpu_s", "speedup", "max_rel_err_vs_dense",
            "parity_1e6"},
    "lenet": {"weights", "batch", "t_gpu_s", "t_cpu_s", "speedup", "max_rel_err_vs_dense",
              "parity_1e6", "spgemm_path_rel_err", "spgemm_path_parity_1e6"},
    "mcl": {"t_gpu_s", "t_cpu_s", "t_plan_s", "t_first_s", "speedup", "fast_path",
            "sizing_cached", "nnz_match", "clusters_match"},
    "triangles": {"strategy", "triangles", "t_gpu_s", "t_cpu_s", "speedup", "counts_match"},
    "sharded": {"t_plan_s", "t_plan_cpu_s", "t_gpu_s", "t_first_s", "t_scipy_s",
                "speedup_vs_scipy", "rebase", "chunks", "merge_parts", "capacity", "nnz_exact"},
}

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


@pytest.mark.parametrize("name", sorted(bench.OPERANDS))
def test_operands_equal_jax(name):
    gen, kwargs, _ = bench.OPERANDS[name]
    got = bench.operand(name)
    if gen == "mtx":
        want = jf.read_mtx(str(bench.MTX_DIR / kwargs["file"]))
    else:
        want = getattr(jf, gen)(**kwargs)
    assert got.shape == want.shape
    for field in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    got_csr, want_csr = got.to_csr(), want.to_csr()
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got_csr, field), getattr(want_csr, field),
                                      err_msg=field)


def test_workloads_are_the_jax_suites():
    with open(os.path.join(REPO, "bench.py"), encoding="utf-8") as f:
        source = f.read()
    # every name in the JAX suite's order: the A² suite, then main()'s records
    positions = [source.index(f'"{name}"', source.index("def bench_spgemm_suite")
                              if name in bench.A2_SUITE else source.index("def main"))
                 for name in NAMES]
    assert positions[:5] == sorted(positions[:5]) and positions[5:] == sorted(positions[5:])
    nn = {"sparse_mlp_infer_b1024_spmm", "sparse_lenet_infer_b256"}
    assert set(bench.OPERANDS) | nn == set(NAMES)
    assert bench.DEADLINE_S == jbench._DEADLINE_S or "OUTERSPACE_BENCH_DEADLINE" in os.environ


def a2(name, speedup, exact=True):
    return dict(name=name, speedup=speedup, nnz_exact=exact, values_match=True,
                elementwise_exact=True)


HEADLINE_CASES = {
    "all_exact": [a2("rmat14_ef8", 512.25), a2("er_100k_d1e-4", 301.5), a2("rmat15_ef8", 640.0),
                  a2("rmat16_ef8", 811.125), a2("mtx_rmat10_a2", 31.0)],
    "one_inexact": [a2("rmat14_ef8", 512.25), a2("er_100k_d1e-4", 301.5, exact=False),
                    a2("rmat15_ef8", 640.0)],
    "error": [a2("rmat14_ef8", 512.25), {"name": "er_100k_d1e-4", "error": "RuntimeError: x"},
              a2("rmat15_ef8", 640.0), a2("mtx_rmat10_a2", 31.0)],
    "only_mtx": [a2("mtx_rmat10_a2", 31.0)],
}


@pytest.mark.parametrize("case", sorted(HEADLINE_CASES))
def test_headline_equal_jax(case, capsys):
    records = HEADLINE_CASES[case]
    got = bench.headline(records)
    capsys.readouterr()
    jbench._print_headline(records, threading.Event())
    want = json.loads(capsys.readouterr().out)
    assert set(got) == HEAD_KEYS == set(want)
    if case == "error":  # the JAX suite leaves the failed record out of its median
        assert want["value"] > 0 and got["value"] == 0
        assert got | {"value": want["value"], "vs_baseline": want["vs_baseline"]} == want
    else:
        assert got == want
    assert (got["value"] > 0) == (case in ("all_exact", "only_mtx"))


def test_root_bench_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", "import sys, bench; print('jax' in sys.modules)"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_bench_small_cpu_jax_blocked(tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(BLOCKER)
    env = dict(os.environ, PYTHONPATH=f"{site}{os.pathsep}{REPO}",
               OUTERSPACE_SIZING_CACHE=str(tmp_path / "sizing.json"))
    env.pop("OUTERSPACE_BENCH_DEADLINE", None)
    out = subprocess.run([sys.executable, "-m", "outerspace_tpu_torch.cli", "bench", "--small",
                          "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    head = json.loads(lines[0])
    assert set(head) == HEAD_KEYS and head["metric"] == bench.METRIC and head["unit"] == "x"
    assert head["value"] > 0 and head["vs_baseline"] == head["value"] and head["records"] == 5
    records = [json.loads(line) for line in out.stderr.splitlines() if line.startswith("{")]
    assert [r.get("name") for r in records] == NAMES
    kinds = {name: kind for name, kind, _ in bench.WORKLOADS}
    for rec in records:
        kind = kinds[rec["name"]]
        if kind == "a2":
            assert set(rec) == A2_KEYS, rec["name"]
        else:
            assert KEYS[kind] <= set(rec), (rec["name"], KEYS[kind] - set(rec))
        assert "error" not in rec
        fields = [f for f in bench.EXACT_FIELDS if f in rec]
        assert fields and all(rec[f] is True for f in fields), rec
        assert rec["launches"] == dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "prune_compact",
                                                 "K2_64", "prune_compact_64", "loop_expand",
                                                 "loop_expand_64", "loop_compact",
                                                 "loop_compact_64"),
                                                0)  # plain versions
    a2_median = np.median([r["speedup"] for r in records[:4]])
    assert head["value"] == round(float(a2_median), 3)
    assert {r["strategy"] for r in records[:5]} <= {"gather", "tiles", "flat"}
    assert records[4]["strategy"] == "flat"
    assert records[[r["name"] for r in records].index("mcl_rmat14_4iter")]["fast_path"]


def run_main(argv, capsys):
    capsys.readouterr()
    rc = bench.main(argv)
    out, err = capsys.readouterr()
    records = [json.loads(line) for line in err.splitlines() if line.startswith("{")]
    heads = [json.loads(line) for line in out.splitlines()]
    assert len(heads) == 1
    return rc, heads[0], records


@pytest.fixture
def cpu_env(monkeypatch, tmp_path):
    monkeypatch.setenv("OUTERSPACE_SIZING_CACHE", str(tmp_path / "sizing.json"))
    monkeypatch.delenv("OUTERSPACE_BENCH_DEADLINE", raising=False)


def test_deadline_sheds_after_the_first(capsys, monkeypatch, cpu_env):
    monkeypatch.setenv("OUTERSPACE_BENCH_DEADLINE", "0")
    rc, head, records = run_main(["--small", "--device", "cpu"], capsys)
    assert rc == 0
    assert records[0]["name"] == NAMES[0] and records[0]["elementwise_exact"]
    assert records[1:] == [{"skipped": name, "reason": "deadline"} for name in NAMES[1:]]
    assert head["records"] == 1 and head["value"] == round(records[0]["speedup"], 3) > 0


@pytest.mark.parametrize("which", ["rmat15_ef8", "mcl_rmat14_4iter"])
def test_workload_that_raises_fails_the_run(capsys, monkeypatch, cpu_env, which):
    real = bench.run_workload

    def raising(name, device, small=False):
        if name == which:
            raise RuntimeError("forced failure")
        return real(name, device, small)

    monkeypatch.setattr(bench, "run_workload", raising)
    rc, head, records = run_main(["--small", "--device", "cpu", "--only",
                                  f"rmat14_ef8,{which},sharded_rmat13_1x1"], capsys)
    assert rc == 1
    assert [r["name"] for r in records] == ["rmat14_ef8", which, "sharded_rmat13_1x1"]
    assert records[1]["error"] == "RuntimeError: forced failure"
    assert "error" not in records[0] and "error" not in records[2]  # the others still ran
    if which == "rmat15_ef8":  # a failed A² record zeroes the headline
        assert head == {"metric": bench.METRIC, "value": 0.0, "unit": "x", "vs_baseline": 0.0,
                        "records": 1}
    else:
        assert head["value"] == round(records[0]["speedup"], 3) > 0


def test_inexact_product_fails_the_run(capsys, monkeypatch, cpu_env):
    import importlib

    spgemm_mod = importlib.import_module("outerspace_tpu_torch.ops.spgemm")
    real = spgemm_mod.spgemm

    def off_by_one(*args, **kwargs):
        got = real(*args, **kwargs)
        got.data[0] += 1.0
        return got

    monkeypatch.setattr(spgemm_mod, "spgemm", off_by_one)
    rc, head, (rec,) = run_main(["--small", "--device", "cpu", "--only", "mtx_rmat10_a2"], capsys)
    assert rc == 1 and head["value"] == 0 and head["records"] == 1
    assert rec["nnz_exact"] and not rec["elementwise_exact"]


def test_missing_cpu_reference_fails_the_run(capsys, monkeypatch, cpu_env):
    from outerspace_tpu_torch.runtime import native

    def no_library():
        raise OSError("the C++ reference did not build")

    monkeypatch.setattr(native, "_ref_library", no_library)
    rc, head, (rec,) = run_main(["--small", "--device", "cpu", "--only", "mtx_rmat10_a2"], capsys)
    assert rc == 1 and head["value"] == 0 and head["records"] == 0
    assert rec["error"] == "OSError: the C++ reference did not build"


def test_bad_options_exit_2(capsys):
    import torch

    assert bench.main(["--only", "rmat14_ef8,nosuch"]) == 2
    assert "['nosuch']" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert bench.main(["--only", "rmat14_ef8"]) == 2
        assert "needs a CUDA device" in capsys.readouterr().err
