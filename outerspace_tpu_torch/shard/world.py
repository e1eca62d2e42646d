"""What a rank of a launched world runs: a list of sharded jobs.

``run_world(run_jobs, n, backend=..., device=..., args=(jobs,))``
(``shard.mesh.run_world``) starts ``n`` ranks and runs :func:`run_jobs`
on each; every rank returns one result per job. A job is a dict:

- ``program``: "sharded" (``spgemm_sharded``, 1-D), "sharded_2d"
  (``spgemm_sharded_2d``), "tiled" (``spgemm_sharded_tiled``) with
  ``plan``, or "triangles" (``triangle_count_sharded``) with ``adj``;
- ``mesh``: the mesh shape, (kx,) with axis "x" or (kx, ny) with axes
  ("x", "y");
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
the plan included).
"""

from __future__ import annotations

import statistics
import time


def _kernels():
    from outerspace_tpu_torch.ops.kernels import expand, gexpand, scan

    return {"K1": gexpand.KERNEL, "K2": scan.KERNEL, "K3": expand.KERNEL_PACKED,
            "K4": expand.KERNEL_COORDS}


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


def run_jobs(jobs: list[dict]) -> list[dict]:
    """Run ``jobs`` on this rank of the default process group, in order
    (every rank runs the same list); returns one result per job."""
    import torch

    from outerspace_tpu_torch.ops.graph import triangle_count_sharded
    from outerspace_tpu_torch.shard.mesh import make_mesh
    from outerspace_tpu_torch.shard.spgemm_sharded import gather_to_csr

    kernels = _kernels()
    meshes, results = {}, []
    for job in jobs:
        shape = tuple(job["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("x", "y")[:len(shape)])
        mesh = meshes[shape]
        for k in kernels.values():
            k.launches = 0
        res = {"mesh": repr(mesh)}
        if job["program"] == "triangles":
            kx, ny = shape[0], (shape[1] if len(shape) > 1 else 1)
            t0 = time.perf_counter()
            res["count"] = triangle_count_sharded(job["adj"], mesh, axes=mesh.axis_names,
                                                  kx=kx, ny=ny)
            res["seconds"] = [time.perf_counter() - t0]
            res["launches"] = {n: k.launches for n, k in kernels.items()}
            results.append(res)
            continue
        run = _program(job, mesh)
        out = run()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        res["launches"] = {n: k.launches for n, k in kernels.items()}
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
        results.append(res)
    return results
