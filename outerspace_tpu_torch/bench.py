"""The benchmark suite on the card: the JAX package's ``bench.py``
(the repository root's), ported.

    python -m outerspace_tpu_torch.bench [--device cuda] [--only NAME[,NAME...]] [--small]
    python -m outerspace_tpu_torch.cli bench [the same options]

It runs the same fourteen workloads, on the same operands, seeds and in
the same order (:data:`WORKLOADS`, :data:`OPERANDS`):

- the A² suite: ``rmat14_ef8``, ``er_100k_d1e-4``, ``rmat15_ef8`` and
  ``rmat16_ef8`` on ``spgemm``'s "auto" (the cost model's pick), and
  ``mtx_rmat10_a2`` (``data/mtx/rmat10_ef8.mtx``) on "flat";
- then the auxiliary records: sparse-MLP and sparse-LeNet inference
  through K5 with the committed pruned weights, Markov clustering of
  rmat14 and rmat15 (4 iterations), the tiled sharded program in a world
  of one rank (rmat16 with rebased keys, rmat13), triangle counting of
  rmat13 and the structured fixtures ``band2048_p5`` and ``mesh2d_48``
  on "flat".

Timing. Every time is the least of 3 warm samples after one first call,
each sample ending in a synchronisation of the card; device times are
CUDA events (``perf.timer.time_device``), host times the host clock.
Nothing runs beside a timed sample: the CPU baselines and plans run
before or after the card's samples. An A² record holds

- ``t_cpu_ref_s``: the C++ outer-product reference
  (``runtime.native.ref_spgemm_native``), the headline's numerator;
  ``t_scipy_s``: scipy's ``s @ s``, whose product is the oracle;
- ``t_gpu_s``: the device pipeline with the operands and the plan staged
  once (the JAX record's ``t_tpu_s``); ``speedup`` = ``t_cpu_ref_s`` /
  ``t_gpu_s``, ``speedup_vs_scipy``, ``gpu_gflops``, ``gpu_mnnz_per_s``;
- ``t_e2e_s``: host CSR in to host CSR out through ``spgemm()``, the
  plan included, what a caller pays; ``speedup_e2e``;
- ``t_plan_s`` / ``t_plan_cpu_s``: the strategy pick and the host plan
  with its staging (wall, thread CPU); ``t_first_s``: the first
  ``spgemm()`` call, the kernels' builds and warm-up included;
- ``nnz_exact``, ``values_match`` (order-free placement-sensitive sums
  within rtol 3e-3, as the JAX record's) and ``elementwise_exact``
  (indptr and indices equal to scipy's, values within rtol 1e-5, atol
  1e-6), each over both the pipeline's and ``spgemm()``'s result;
- ``launches`` of each kernel over the record, ``wall_s`` and ``at_s``.

Output: one JSON record per workload on stderr, or ``{"skipped": name,
"reason": "deadline"}`` for a workload shed for the deadline
(``OUTERSPACE_BENCH_DEADLINE`` seconds, default 545); a workload that
raises gives ``{"name": ..., "error": ...}`` and the rest still run.
Right after the A² suite, stdout gets the one headline line
``{"metric": "spgemm_a2_median_speedup_vs_cpu_reference", "value",
"unit": "x", "vs_baseline", "records"}``: the median ``speedup`` over
the A² records not named ``mtx_``, or 0 if any A² record failed or is
not exact. The process exits 0 when every record is exact and none
failed, 1 otherwise, 2 on a bad option.

``--small`` runs the same generators at CPU test scale (``--device
cpu`` runs each kernel's plain version). ``--only`` runs a subset, in
the suite's order.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
MTX_DIR = ROOT / "data" / "mtx"
WEIGHTS = ROOT / "data" / "saved_weights"
DEADLINE_S = 545.0  # the JAX suite's soft deadline; OUTERSPACE_BENCH_DEADLINE overrides
METRIC = "spgemm_a2_median_speedup_vs_cpu_reference"
SAMPLES = 3  # warm samples per time, after one first call
MCL_ITERS = 4
VAL_RTOL, VAL_ATOL = 1e-5, 1e-6  # elementwise, as the JAX fixture check
SUM_RTOL, SUM_ATOL = 3e-3, 1e-2  # the JAX record's checksum tolerance
NN_PARITY = 1e-6 * 10  # the JAX record's parity_1e6 bound

# (generator, its arguments, what --small changes): the JAX suite's
# operands and seeds
OPERANDS = {
    "rmat14_ef8": ("rmat", dict(scale=14, edge_factor=8, seed=1), dict(scale=8)),
    "er_100k_d1e-4": ("erdos_renyi", dict(n_rows=100_000, n_cols=100_000, density=1e-4, seed=3),
                      dict(n_rows=70_000, n_cols=70_000, density=4e-6)),
    "rmat15_ef8": ("rmat", dict(scale=15, edge_factor=8, seed=2), dict(scale=9)),
    "rmat16_ef8": ("rmat", dict(scale=16, edge_factor=8, seed=5), dict(scale=10)),
    "mtx_rmat10_a2": ("mtx", dict(file="rmat10_ef8.mtx"), {}),
    "mcl_rmat14_4iter": ("rmat", dict(scale=14, edge_factor=8, seed=7), dict(scale=8)),
    "mcl_rmat15_4iter": ("rmat", dict(scale=15, edge_factor=8, seed=7), dict(scale=9)),
    "sharded_rmat16_1x1": ("rmat", dict(scale=16, edge_factor=8, seed=5), dict(scale=9)),
    "triangles_rmat13": ("rmat", dict(scale=13, edge_factor=8, seed=4), dict(scale=9)),
    "band2048_p5_a2": ("mtx", dict(file="band2048_p5.mtx"), {}),
    "mesh2d_48_a2": ("mtx", dict(file="mesh2d_48.mtx"), {}),
    "sharded_rmat13_1x1": ("rmat", dict(scale=13, edge_factor=8, seed=7), dict(scale=8)),
}

# (name, kind, options), in the JAX suite's order: the A² suite, then the
# auxiliary records
WORKLOADS = (
    ("rmat14_ef8", "a2", {}),
    ("er_100k_d1e-4", "a2", {}),
    ("rmat15_ef8", "a2", {}),
    ("rmat16_ef8", "a2", {}),
    ("mtx_rmat10_a2", "a2", {"strategy": "flat"}),
    ("sparse_mlp_infer_b1024_spmm", "mlp", {}),
    ("mcl_rmat14_4iter", "mcl", {}),
    ("mcl_rmat15_4iter", "mcl", {}),
    ("sharded_rmat16_1x1", "sharded", {"k_ops": 3}),
    ("triangles_rmat13", "triangles", {}),
    ("band2048_p5_a2", "a2", {"strategy": "flat"}),
    ("mesh2d_48_a2", "a2", {"strategy": "flat"}),
    ("sparse_lenet_infer_b256", "lenet", {}),
    ("sharded_rmat13_1x1", "sharded", {"k_ops": 10}),
)
A2_SUITE = ("rmat14_ef8", "er_100k_d1e-4", "rmat15_ef8", "rmat16_ef8", "mtx_rmat10_a2")
HEADLINERS = ("rmat14_ef8", "rmat15_ef8", "rmat16_ef8")
# the fields that must be true in every record
EXACT_FIELDS = ("nnz_exact", "values_match", "elementwise_exact", "parity_1e6",
                "spgemm_path_parity_1e6", "counts_match", "nnz_match", "clusters_match")
# each workload's wall seconds at full size, for shedding at the deadline:
# its "wall_s" in a whole run on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit, the kernels built cold (PERF.md §6), rounded up
EST_S = {
    "rmat14_ef8": 15.0, "er_100k_d1e-4": 16.0, "rmat15_ef8": 22.0, "rmat16_ef8": 66.0,
    "mtx_rmat10_a2": 1.0, "sparse_mlp_infer_b1024_spmm": 4.0, "mcl_rmat14_4iter": 6.0,
    "mcl_rmat15_4iter": 15.0, "sharded_rmat16_1x1": 33.0, "triangles_rmat13": 3.0,
    "band2048_p5_a2": 1.0, "mesh2d_48_a2": 1.0, "sparse_lenet_infer_b256": 1.0,
    "sharded_rmat13_1x1": 11.0,
}


# --------------------------------------------------------------------------
# Operands and timing
# --------------------------------------------------------------------------


def operand(name: str, small: bool = False):
    """The workload's operand (a COO), at CPU test scale with ``small``."""
    from outerspace_tpu_torch.formats import erdos_renyi, read_mtx, rmat

    gen, kwargs, small_kwargs = OPERANDS[name]
    if small:
        kwargs = kwargs | small_kwargs
    if gen == "mtx":
        return read_mtx(str(MTX_DIR / kwargs["file"]))
    return {"rmat": rmat, "erdos_renyi": erdos_renyi}[gen](**kwargs)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _first_call(fn, device):
    """(seconds, result) of one call of ``fn``, the card synchronised."""
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def _host_least(fn, device="cpu"):
    """(the first call's result, the least of :data:`SAMPLES` warm
    calls' seconds), host clock, each call ending in a synchronisation."""
    _, out = _first_call(fn, device)
    return out, min(_first_call(fn, device)[0] for _ in range(SAMPLES))


def _device_least(fn) -> float:
    """The least of :data:`SAMPLES` calls of ``fn`` after one first call:
    CUDA events where ``fn`` returns a tensor on the card, else the host
    clock (``perf.timer.time_device``)."""
    from outerspace_tpu_torch.perf.timer import time_device

    return time_device(fn, reps=SAMPLES, warmup=1)


def _launches() -> dict:
    from outerspace_tpu_torch.ops.kernels import counters

    return {n: k.launches for n, k in counters().items()}


@contextlib.contextmanager
def _no_tf32():
    """Full float32 on the card for the NN records (cuBLAS and cuDNN
    default to TF32 for float32 on Hopper)."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# --------------------------------------------------------------------------
# A² records
# --------------------------------------------------------------------------


def strategy_fns(strategy: str, a_csc, b_csr, device):
    """(host plan with its staging, device pipeline) of one strategy of
    ``spgemm``: ``run(plan())`` returns the padded ``MergedCOO``."""
    from outerspace_tpu_torch.ops.gather_pipeline import plan_spgemm_gather, spgemm_gather_padded
    from outerspace_tpu_torch.ops.spgemm import (
        plan_tiled_parts,
        plan_to_device,
        spgemm_padded,
        spgemm_padded_tiled_parts,
    )
    from outerspace_tpu_torch.ops.symbolic import expansion_plan

    if strategy == "gather":
        return lambda: plan_spgemm_gather(a_csc, b_csr, device=device), spgemm_gather_padded
    if strategy == "tiles":
        return (lambda: plan_tiled_parts(a_csc, b_csr, device=device),
                spgemm_padded_tiled_parts)

    def plan_flat():
        fp = expansion_plan(a_csc, b_csr)
        return fp, plan_to_device(fp, device)
    return plan_flat, lambda planned: spgemm_padded(planned[0], device_args=planned[1])


def _padded_slots(strategy: str, plan) -> int:
    return plan[0].padded_size() if strategy == "flat" else plan.padded_total


def cpu_baselines(g) -> dict:
    """scipy's ``s @ s`` (the oracle ``c_ref``: duplicates summed,
    indices sorted) and the C++ reference, each timed; a reference that
    does not build or run raises."""
    from outerspace_tpu_torch.runtime.native import ref_spgemm_native

    s = g.to_scipy().tocsr()
    s.sort_indices()
    c_ref, t_scipy = _host_least(lambda: s @ s)
    c_ref.sum_duplicates()
    c_ref.sort_indices()
    a_csc, b_csr = g.to_csc(), g.to_csr()
    _, t_cpu = _host_least(lambda: ref_spgemm_native(a_csc, b_csr))
    return {"c_ref": c_ref, "t_scipy": t_scipy, "t_cpu": t_cpu}


def compare(got, c_ref) -> tuple[bool, bool, bool]:
    """(nnz equal, the four order-free checksums within rtol 3e-3 atol
    1e-2, indptr and indices equal and values within rtol 1e-5 atol 1e-6)
    of a host CSR against scipy's product."""
    if got.nnz != c_ref.nnz:
        return False, False, False

    def sums(indptr, indices, data):
        rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        d = np.asarray(data, np.float64)
        return np.array([d.sum(), np.abs(d).sum(), (rows * d).sum(), (indices * d).sum()])

    sums_ok = bool(np.allclose(sums(got.indptr, got.indices, got.data),
                               sums(c_ref.indptr, c_ref.indices, c_ref.data),
                               rtol=SUM_RTOL, atol=SUM_ATOL))
    exact = bool(np.array_equal(got.indptr, c_ref.indptr)
                 and np.array_equal(got.indices, c_ref.indices)
                 and np.allclose(got.data, c_ref.data, rtol=VAL_RTOL, atol=VAL_ATOL))
    return True, sums_ok, exact


def spgemm_record(name: str, g, device, strategy: str = "auto") -> dict:
    """One A² workload: the CPU baselines, the first ``spgemm()`` call,
    the host plan, the staged device pipeline, ``spgemm()`` end to end;
    both products checked against scipy's."""
    from outerspace_tpu_torch.ops.reference import spgemm_flops
    from outerspace_tpu_torch.ops.spgemm import spgemm
    from outerspace_tpu_torch.sched.planner import choose_strategy

    cpu = cpu_baselines(g)
    c_ref = cpu["c_ref"]
    a_csc, b_csr = g.to_csc(), g.to_csr()

    def call():  # host CSR in, host CSR out
        return spgemm(b_csr, b_csr, strategy=strategy, device=device)

    t_first, _ = _first_call(call, device)
    t0, c0 = time.perf_counter(), time.thread_time()
    ran = choose_strategy(a_csc, b_csr) if strategy == "auto" else strategy
    plan_fn, run_fn = strategy_fns(ran, a_csc, b_csr, device)
    plan = plan_fn()
    _sync(device)
    t_plan, t_plan_cpu = time.perf_counter() - t0, time.thread_time() - c0
    t_gpu = _device_least(lambda: run_fn(plan).nnz)
    checks = [compare(run_fn(plan).to_csr(), c_ref)]
    p_pad = _padded_slots(ran, plan)
    del plan
    got, t_e2e = _host_least(call, device)
    checks.append(compare(got, c_ref))
    flops = spgemm_flops(a_csc, b_csr)
    return dict(
        name=name, strategy=ran, t_plan_s=t_plan, t_plan_cpu_s=t_plan_cpu, nnz_in=g.nnz,
        nnz_out=int(c_ref.nnz), flops=int(flops), p_pad=int(p_pad),
        t_cpu_ref_s=cpu["t_cpu"], t_scipy_s=cpu["t_scipy"], t_gpu_s=t_gpu, t_e2e_s=t_e2e,
        t_first_s=t_first, speedup=cpu["t_cpu"] / t_gpu, speedup_e2e=cpu["t_cpu"] / t_e2e,
        speedup_vs_scipy=cpu["t_scipy"] / t_gpu, gpu_gflops=flops / t_gpu / 1e9,
        gpu_mnnz_per_s=c_ref.nnz / t_gpu / 1e6,
        nnz_exact=all(c[0] for c in checks), values_match=all(c[1] for c in checks),
        elementwise_exact=all(c[2] for c in checks),
    )


# --------------------------------------------------------------------------
# Auxiliary records
# --------------------------------------------------------------------------


def _test_images(n_images: int, synthetic_n: int) -> np.ndarray:
    """The first ``n_images`` test images of MNIST, or of
    ``synthetic_mnist(synthetic_n)`` where the tree has no idx files (its
    test split holds a tenth of them)."""
    from outerspace_tpu_torch.nn.data import find_mnist_dir, load_mnist, synthetic_mnist

    data = load_mnist() if find_mnist_dir() else synthetic_mnist(synthetic_n)
    return data["test"][0][:n_images].astype(np.float32)


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-9))


def mlp_record(name: str, device, small: bool = False) -> dict:
    """MLP1w pruned to 1% (the committed finetuned weights) through K5,
    one forward of the staged batch, against the scipy SpGEMM chain on
    the host; parity against the dense forward. Without idx files the
    batch is the JAX suite's: the 206 test images of
    ``synthetic_mnist(2048)`` (LeNet's: 52 of ``synthetic_mnist(512)``)."""
    import torch

    from outerspace_tpu_torch.convert import load_params
    from outerspace_tpu_torch.nn.sparse_infer import (
        SparseMLP,
        mlp_forward_dense,
        mlp_forward_spgemm,
    )

    params = load_params(str(WEIGHTS / "MLP1w" / "prune0p01_finetuned.pkl"))
    x = _test_images(32 if small else 1024, 2048).reshape(-1, 784)
    with _no_tf32():
        model = SparseMLP(params, device=device)
        xd = torch.from_numpy(x).to(device)
        t_first, _ = _first_call(lambda: model(xd), device)
        t_gpu = _device_least(lambda: model(xd))
        got = model(xd).cpu().numpy()
    _, t_cpu = _host_least(lambda: mlp_forward_spgemm(params, x, "scipy"))
    err = _rel_err(got, mlp_forward_dense(params, x))
    return dict(name=name, weights="MLP1w_prune0p01_finetuned", batch=int(x.shape[0]),
                t_gpu_s=t_gpu, t_first_s=t_first, t_cpu_s=t_cpu, speedup=t_cpu / t_gpu,
                max_rel_err_vs_dense=err, parity_1e6=bool(err < NN_PARITY))


def lenet_record(name: str, device, small: bool = False) -> dict:
    """The pruned, finetuned LeNet through K5 (im2col-lowered convs), one
    forward of the staged batch, against the scipy SpGEMM chain on the
    host; parity against the dense model on the card, and 8 images
    through the SpGEMM pipeline as a second witness."""
    import torch

    from outerspace_tpu_torch.convert import load_params, state_dict_from_params
    from outerspace_tpu_torch.nn.models import make_model
    from outerspace_tpu_torch.nn.sparse_infer import SparseLeNet, lenet_forward_spgemm

    params = load_params(str(WEIGHTS / "LeNet" / "pruned_finetuned"))
    x = _test_images(16 if small else 256, 512).reshape(-1, 28, 28, 1)
    with _no_tf32():
        model = SparseLeNet(params, device=device)
        xd = torch.from_numpy(x).to(device)
        t_first, _ = _first_call(lambda: model(xd), device)
        t_gpu = _device_least(lambda: model(xd))
        got = model(xd).cpu().numpy()
        dense = make_model("LeNet").to(device).eval()
        dense.load_state_dict(state_dict_from_params(params))
        with torch.no_grad():
            want = dense(xd)[0].cpu().numpy()
        sp8 = lenet_forward_spgemm(params, x[:8], backend="torch", device=device)
    _, t_cpu = _host_least(lambda: lenet_forward_spgemm(params, x, backend="scipy"))
    err, err8 = _rel_err(got, want), _rel_err(sp8, want[:8])
    return dict(name=name, weights="LeNet_pruned_finetuned", batch=int(x.shape[0]),
                t_gpu_s=t_gpu, t_first_s=t_first, t_cpu_s=t_cpu, speedup=t_cpu / t_gpu,
                max_rel_err_vs_dense=err, parity_1e6=bool(err < NN_PARITY),
                spgemm_path_rel_err=err8, spgemm_path_parity_1e6=bool(err8 < NN_PARITY))


def _cluster_sets(flow) -> set:
    from outerspace_tpu_torch.ops.graph import mcl_clusters

    return {tuple(sorted(c.tolist())) for c in mcl_clusters(flow)}


def mcl_record(name: str, g, device) -> dict:
    """Markov clustering, 4 iterations, of the self-looped |A| (columns
    normalised): ``mcl_prepare``, a first ``mcl_run`` (sized by the host
    sweep unless the sizing cache holds the budgets), then warm runs;
    against scipy's MCL, nnz and the cluster sets."""
    from outerspace_tpu_torch.ops import graph

    t0 = time.perf_counter()
    prep = graph.mcl_prepare(graph._mcl_setup(g), iters=MCL_ITERS, device=device)
    _sync(device)
    t_plan = time.perf_counter() - t0
    t_first, _ = _first_call(lambda: graph.mcl_run(prep), device)
    sizing_cached = bool(prep.get("sizing_cached", False))
    fast = []

    def warm():
        out = graph.mcl_run(prep)
        # a run that failed its budgets' ok ran the exact fallback and
        # doubled prep's budgets
        fast.append(prep["ran_with"]["p_pad"] == prep["p_pad"])
        return out.nnz

    t_gpu = _device_least(warm)
    got = graph.mcl_run(prep).to_csr()
    want, t_cpu = _host_least(lambda: graph.markov_cluster(g, iters=MCL_ITERS, backend="scipy"))
    clusters = _cluster_sets(want)
    return dict(name=name, t_gpu_s=t_gpu, t_first_s=t_first, t_cpu_s=t_cpu, t_plan_s=t_plan,
                speedup=t_cpu / t_gpu, fast_path=all(fast), sizing_cached=sizing_cached,
                nnz_out=int(got.nnz), clusters=len(clusters),
                nnz_match=bool(got.nnz == want.nnz),
                clusters_match=_cluster_sets(got) == clusters)


def triangles_record(name: str, g, device) -> dict:
    """Triangles of the symmetrised simple graph by the route the
    selector picks (dense int8 products, or the tiled A² and the edge
    bitmap), timed from the staged inputs, against scipy's count."""
    import torch

    from outerspace_tpu_torch.ops import graph

    sym = graph._symmetrize_simple(g)
    strategy = graph._triangle_strategy(sym)
    if strategy == "dense":
        rows, cols = (torch.from_numpy(v.astype(np.int64)).to(device) for v in (sym.row, sym.col))
        n_pad = graph._n_pad(sym)

        def total():
            return graph._tri_dense_total(rows, cols, n_pad)
    else:
        prep = graph.triangle_prepare(sym, device=device)

        def total():
            return graph._tri_sparse_total(prep)
    count = int(round(float(total()) / 6.0))
    t_gpu = _device_least(total)
    want, t_cpu = _host_least(lambda: graph.triangle_count(g, backend="scipy"))
    return dict(name=name, strategy=strategy, triangles=count, t_gpu_s=t_gpu, t_cpu_s=t_cpu,
                speedup=t_cpu / t_gpu, counts_match=count == want)


def sharded_rank(plan, k_ops: int) -> dict:
    """A rank's part of a sharded record: the tiled program on a (1,)
    mesh, its first run, then :data:`SAMPLES` samples of ``k_ops`` runs
    each after a barrier (CUDA events on a card). Returns the rank's
    nnz, the first run's seconds, each sample's seconds per run and the
    kernels' launches in the rank."""
    from outerspace_tpu_torch.shard.mesh import make_mesh
    from outerspace_tpu_torch.shard.tiled import build_sharded_tiled
    from outerspace_tpu_torch.shard.world import _timed

    mesh = make_mesh((1,), ("x",))
    prog = build_sharded_tiled(plan, mesh, "x")
    t_first, out = _first_call(prog.run, mesh.device)
    nnz = int(out.nnz)
    del out
    samples = [_timed(lambda: [prog.run() for _ in range(k_ops)], mesh.device) / k_ops
               for _ in range(SAMPLES)]
    return {"nnz": nnz, "t_first_s": t_first, "samples": samples, "launches": _launches()}


def sharded_record(name: str, g, device, k_ops: int) -> dict:
    """The tiled sharded program (``shard_plan_tiled(kx=1, ny=1)``,
    ``build_sharded_tiled``) in a world of one rank (nccl on a card, gloo
    on the CPU), spawned before any timing; nnz against scipy's."""
    import torch

    from outerspace_tpu_torch.ops.reference import spgemm_scipy
    from outerspace_tpu_torch.shard.mesh import run_world
    from outerspace_tpu_torch.shard.tiled import shard_plan_tiled

    dev = torch.device(device)
    t0, c0 = time.perf_counter(), time.thread_time()
    plan = shard_plan_tiled(g.to_csc(), g.to_csr(), kx=1, ny=1)
    t_plan, t_plan_cpu = time.perf_counter() - t0, time.thread_time() - c0
    t0 = time.perf_counter()
    (rank,) = run_world(sharded_rank, 1, backend="nccl" if dev.type == "cuda" else "gloo",
                        device=dev.type, args=(plan, k_ops), timeout=900.0)
    t_world = time.perf_counter() - t0
    c_ref, t_scipy = _host_least(lambda: spgemm_scipy(g, g))
    t_gpu = min(rank["samples"])
    return dict(name=name, t_plan_s=t_plan, t_plan_cpu_s=t_plan_cpu, t_gpu_s=t_gpu,
                t_first_s=rank["t_first_s"], t_world_s=t_world, k_ops=k_ops, t_scipy_s=t_scipy,
                speedup_vs_scipy=t_scipy / t_gpu, rebase=bool(plan.rebase), chunks=plan.chunks,
                merge_parts=plan.merge_parts, capacity=plan.capacity,
                nnz_exact=rank["nnz"] == c_ref.nnz, launches=rank["launches"])


def run_workload(name: str, device, small: bool = False) -> dict:
    """One workload's record (its ``launches`` and ``wall_s`` added)."""
    kind, opts = next((k, o) for n, k, o in WORKLOADS if n == name)
    t0 = time.perf_counter()
    before = _launches()
    if kind == "mlp":
        rec = mlp_record(name, device, small)
    elif kind == "lenet":
        rec = lenet_record(name, device, small)
    else:
        g = operand(name, small)
        if kind == "a2":
            rec = spgemm_record(name, g, device, opts.get("strategy", "auto"))
        elif kind == "mcl":
            rec = mcl_record(name, g, device)
        elif kind == "triangles":
            rec = triangles_record(name, g, device)
        else:
            rec = sharded_record(name, g, device, opts["k_ops"])
    _sync(device)
    after = _launches()
    rec.setdefault("launches", {n: after[n] - before[n] for n in after})
    rec["wall_s"] = time.perf_counter() - t0
    return rec


# --------------------------------------------------------------------------
# The suite, its headline and its verdict
# --------------------------------------------------------------------------


def headline(records: list[dict]) -> dict:
    """The contract line over the A² suite's records: the median
    ``speedup`` of the exact records not named ``mtx_`` (all of them if
    only those ran); 0 when any record failed or is not exact."""
    good = [r for r in records if "error" not in r]
    ok = bool(good) and len(good) == len(records) and all(
        r["nnz_exact"] and r["values_match"] and r.get("elementwise_exact", True) for r in good)
    speedups = ([r["speedup"] for r in good if not r["name"].startswith("mtx_")]
                or [r["speedup"] for r in good])
    value = round(float(np.median(speedups)) if ok and speedups else 0.0, 3)
    return {"metric": METRIC, "value": value, "unit": "x", "vs_baseline": value,
            "records": len(good)}


def passed(records: list[dict]) -> bool:
    """True when no workload failed and every exactness field is true
    (a workload shed for the deadline is neither)."""
    return all("error" not in r and all(r[f] for f in EXACT_FIELDS if f in r)
               for r in records)


def run_suite(names=None, device="cuda", small: bool = False, out=None,
              err=None) -> tuple[dict, list[dict]]:
    """Run the workloads ``names`` (default all) in the suite's order:
    each record on ``err`` as it lands, the headline on ``out`` right
    after the A² suite. A workload is shed when a record has landed and
    the time left is less than its estimate plus the headliners' still
    ahead; one that raises gives an error record. Returns the headline
    and every record (skips included)."""
    out, err = out or sys.stdout, err or sys.stderr
    deadline = float(os.environ.get("OUTERSPACE_BENCH_DEADLINE", DEADLINE_S))
    order = [n for n, _, _ in WORKLOADS if names is None or n in names]
    t0 = time.perf_counter()
    records: list[dict] = []
    head = None

    def emit(stream, rec):
        print(json.dumps(rec), file=stream, flush=True)
        return rec

    def emit_headline():
        return emit(out, headline([r for r in records if r.get("name") in A2_SUITE]))

    for i, name in enumerate(order):
        if head is None and name not in A2_SUITE:
            head = emit_headline()
        ahead = sum(EST_S[h] for h in HEADLINERS if h in order[i + 1:])
        left = deadline - (time.perf_counter() - t0)
        if records and left < EST_S[name] + ahead:
            rec = {"skipped": name, "reason": "deadline"}
        else:
            try:
                rec = run_workload(name, device, small)
            except Exception as e:  # recorded; the suite goes on
                rec = {"name": name, "error": f"{type(e).__name__}: {e}"[:500],
                       "traceback": traceback.format_exc()[-2000:]}
            rec["at_s"] = time.perf_counter() - t0
        records.append(rec)
        emit(err, rec)
    return head or emit_headline(), records


def add_arguments(p: argparse.ArgumentParser) -> None:
    names = ", ".join(n for n, _, _ in WORKLOADS)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs there)")
    p.add_argument("--only", default=None, metavar="NAME[,NAME...]",
                   help=f"run these workloads only, in the suite's order: {names}")
    p.add_argument("--small", action="store_true",
                   help="the same generators at CPU test scale (quick; rates not meaningful)")


def run_args(args) -> int:
    """The suite from parsed options: exit 0 if every record is exact and
    none failed, 1 if not, 2 on a bad option."""
    import torch

    known = [n for n, _, _ in WORKLOADS]
    names = None
    if args.only:
        names = [n.strip() for n in args.only.split(",") if n.strip()]
        unknown = [n for n in names if n not in known]
        if unknown or not names:
            print(f"unknown workload(s) {unknown or args.only!r}; the workloads: "
                  + ", ".join(known), file=sys.stderr)
            return 2
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device} needs a CUDA device (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 2
    stdout = sys.stdout
    # the headline is the one line on the standard output
    with contextlib.redirect_stdout(sys.stderr):
        _, records = run_suite(names, args.device, args.small, out=stdout, err=sys.stderr)
    return 0 if passed(records) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="outerspace_tpu_torch.bench",
                                description="the benchmark suite (one JSON headline line)")
    add_arguments(p)
    return run_args(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
