"""What a rank of a launched world runs: a list of sharded jobs.

``run_world(run_jobs, n, backend=..., device=..., args=(jobs,))``
(``shard.mesh.run_world``) starts ``n`` ranks and runs :func:`run_jobs`
on each; every rank returns one result per job. A job is a dict:

- ``program``: "sharded" (``spgemm_sharded``, 1-D), "sharded_2d"
  (``spgemm_sharded_2d``), "tiled" (``spgemm_sharded_tiled``) with
  ``plan``; "triangles" (``triangle_count_sharded``) with ``adj``;
  "mcl" (Markov clustering) with ``adj``, ``loop`` ("host":
  ``ops.graph.markov_cluster_sharded``; "device":
  ``shard.mcl.markov_cluster_sharded_device``) and ``iters``; "serve"
  (``SparseMLP.sharded``) with ``params`` (a flax parameter dict) and
  ``x``; "train" (``shard.train.tp_train_step``, ``steps`` times) with
  ``state_dict``, ``x``, ``y``, ``cfg`` and ``steps``;
- ``mesh``: the mesh shape, (kx,) or (kx, ny); ``axes`` (optional): its
  axis names, default "x" / ("x", "y") ("serve" takes ("dp",), "train"
  ("dp", "tp"));
- ``csr`` (optional, default False): gather the product to rank 0 as a
  host CSR;
- ``reps`` (optional, default 0): warm runs to time after the first;
- ``entries`` (optional, default True): return the rank's entries.

A result holds the rank's ``nnz`` and merged entries (``rows``,
``cols``, ``vals`` where valid, in the rank's order), the kernels' launches
during the first run, the seconds of each timed run (CUDA events on a
card, the host clock on the CPU, every rank started together), and on
rank 0 the CSR as (shape, indptr, indices, data); a "triangles" job
holds its ``count``, launches and the seconds of the call (host clock,
the plan included). An "mcl" job holds the final flow as a CSR tuple
(every rank), its ``report``, launches and the call's seconds, and for
the device loop with ``reps`` the seconds of each warm run of the loop
alone (``loop_seconds``, its ``iters`` bodies) and, on a card, the
device synchronisations of one call counted by
``torch.cuda.set_sync_debug_mode`` (``syncs``). A "serve" job holds
the whole batch's ``logits`` and its launches (and timed requests with
``reps``); a "train" job the ``losses``, the seconds of each step and, on
rank 0, the whole final ``state_dict``.
"""

from __future__ import annotations

import statistics
import time


def _timed(fn, device) -> float:
    """Seconds of one ``fn()`` with every rank started together."""
    import torch
    import torch.distributed as dist

    if device.type == "cuda" and dist.get_backend() == "nccl":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _program(job, mesh):
    """The job's run function on this rank (its inputs staged)."""
    from outerspace_tpu_torch.shard.spgemm_sharded import spgemm_sharded, spgemm_sharded_2d
    from outerspace_tpu_torch.shard.tiled import build_sharded_tiled

    plan, axes = job["plan"], mesh.axis_names
    if job["program"] == "sharded":
        return lambda: spgemm_sharded(plan, mesh, axes[0])
    if job["program"] == "sharded_2d":
        return lambda: spgemm_sharded_2d(plan, mesh, axes)
    if job["program"] == "tiled":
        return build_sharded_tiled(plan, mesh, axes if plan.ny > 1 else axes[0]).run
    raise ValueError(f"unknown program {job['program']!r}")


def _syncs(fn, device) -> tuple[object, int | None]:
    """``fn()`` and the device synchronisations it made (CUDA only, else
    None): ``torch.cuda.set_sync_debug_mode("warn")``'s warnings."""
    import warnings

    import torch

    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message) for w in caught)


def _counted(kernels):
    return {n: k.launches for n, k in kernels.items()}


def _triangles_job(job, mesh, res, kernels) -> None:
    from outerspace_tpu_torch.ops.graph import triangle_count_sharded

    shape = mesh.shape
    t0 = time.perf_counter()
    res["count"] = triangle_count_sharded(job["adj"], mesh, axes=mesh.axis_names, kx=shape[0],
                                          ny=shape[1] if len(shape) > 1 else 1)
    res.update(seconds=[time.perf_counter() - t0], launches=_counted(kernels))


def _mcl_job(job, mesh, res, kernels) -> None:
    from outerspace_tpu_torch.formats.coo import COO
    from outerspace_tpu_torch.ops.graph import _mcl_setup, markov_cluster_sharded
    from outerspace_tpu_torch.shard import mcl

    shape, axes = mesh.shape, mesh.axis_names
    kx, ny = shape[0], (shape[1] if len(shape) > 1 else 1)
    report: dict = {}
    t0 = time.perf_counter()
    if job["loop"] == "device":
        coo = job["adj"] if isinstance(job["adj"], COO) else job["adj"].to_coo()
        plan = mcl.plan_mcl_sharded_device(_mcl_setup(coo), kx=kx, ny=ny, iters=job["iters"],
                                           mesh=mesh)
        prog = mcl.build_mcl_sharded_device(plan, mesh, axes)
        flow, res["syncs"] = _syncs(lambda: mcl.run_to_csr(prog, report), mesh.device)
    else:
        flow = markov_cluster_sharded(job["adj"], mesh, axes=axes, kx=kx, ny=ny,
                                      iters=job["iters"], report=report)
    res["seconds"] = [time.perf_counter() - t0]
    res.update(csr=(flow.shape, flow.indptr, flow.indices, flow.data), report=report,
               launches=_counted(kernels))
    if job["loop"] == "device" and job.get("reps"):
        res["loop_seconds"] = [_timed(prog.run, mesh.device) for _ in range(job["reps"])]


def _serve_job(job, mesh, res, kernels) -> None:
    import torch

    from outerspace_tpu_torch.nn.sparse_infer import SparseMLP

    run = SparseMLP(job["params"], device=mesh.device).sharded(mesh, mesh.axis_names[0])
    for k in kernels.values():  # the staging launches nothing; count the request alone
        k.launches = 0
    res["logits"] = run(job["x"])
    res["launches"] = _counted(kernels)
    if job.get("reps"):
        x = torch.as_tensor(job["x"]).to(mesh.device)
        res["seconds"] = [_timed(lambda: run(x), mesh.device) for _ in range(job["reps"])]


def _train_job(job, mesh, res, kernels) -> None:
    from outerspace_tpu_torch.shard import train

    model, opt, x, y = train.stage_tp(job["state_dict"], job["x"], job["y"], job["cfg"], mesh)
    losses = []
    res["seconds"] = [_timed(lambda: losses.append(train.tp_train_step(model, opt, x, y,
                                                                       job["cfg"])),
                             mesh.device) for _ in range(job["steps"])]
    full = train.unshard_params(model.local_state_dict(), mesh)
    res.update(losses=[float(v) for v in losses], launches=_counted(kernels))
    if mesh.rank == 0:
        res["state_dict"] = {k: v.cpu() for k, v in full.items()}


# the jobs that are not a SpGEMM program, by kind: each fills in ``res``
_JOBS = {"triangles": _triangles_job, "mcl": _mcl_job, "serve": _serve_job, "train": _train_job}


def run_jobs(jobs: list[dict]) -> list[dict]:
    """Run ``jobs`` on this rank of the default process group, in order
    (every rank runs the same list); returns one result per job."""
    import torch

    from outerspace_tpu_torch.ops.kernels import counters
    from outerspace_tpu_torch.shard.mesh import make_mesh
    from outerspace_tpu_torch.shard.spgemm_sharded import gather_to_csr

    kernels = counters()
    meshes, results = {}, []
    default_axes = {"serve": ("dp",), "train": ("dp", "tp")}
    for job in jobs:
        shape = tuple(job["mesh"])
        names = tuple(job.get("axes") or default_axes.get(job["program"], ("x", "y")))
        names = names[:len(shape)]
        if (shape, names) not in meshes:
            meshes[shape, names] = make_mesh(shape, names)
        mesh = meshes[shape, names]
        for k in kernels.values():
            k.launches = 0
        res = {"mesh": repr(mesh)}
        results.append(res)
        if job["program"] in _JOBS:
            _JOBS[job["program"]](job, mesh, res, kernels)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            continue
        run = _program(job, mesh)
        out = run()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        res["launches"] = _counted(kernels)
        res.update(nnz=int(out.nnz), length=int(out.rows.shape[0]))
        if job.get("entries", True):
            sel = out.valid
            res.update(rows=out.rows[sel], cols=out.cols[sel], vals=out.vals[sel])
        if job.get("csr"):
            csr = gather_to_csr(out.shape, out)
            res["csr"] = None if csr is None else (csr.shape, csr.indptr, csr.indices, csr.data)
        del out
        times = [_timed(run, mesh.device) for _ in range(job.get("reps", 0))]
        if times:
            res["seconds"] = times
            res["median_s"] = statistics.median(times)
    return results
