"""The device mesh of the sharded mode, on ``torch.distributed``, and the
launcher that starts its ranks.

The JAX package runs one ``shard_map`` program over a ``jax.sharding.Mesh``
(``make_mesh``). Here every rank of a process group runs the same
function (SPMD): a :class:`Mesh` gives the rank its coordinates on a
(kx × ny) grid, the process group of each axis, and its
``torch.device``; ``lax.all_to_all`` over an axis becomes
:meth:`Mesh.all_to_all`, one ``dist.all_to_all_single``. Rank r sits at
(r // ny, r % ny), as ``np.array(devices).reshape(shape)`` orders the
JAX mesh's devices.

The backend is the caller's to name:

- ``nccl``: one rank per card, CUDA tensors throughout;
- ``gloo``: CPU tensors, or ranks that share a card (NCCL refuses two
  ranks on one GPU). On a card the kernels still run there; only the
  exchange is staged through host memory, and the mesh says so.

:func:`run_world` spawns the ranks, meets them at a ``file://``
rendezvous in a temporary directory, runs one function on each, and
raises in the caller any exception a rank raised.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback

import numpy as np

BACKENDS = ("nccl", "gloo")


def balanced_contiguous_partition(weights: np.ndarray, parts: int) -> np.ndarray:
    """Boundaries of a contiguous partition of ``weights`` into ``parts``
    with about equal weight each.

    Returns int64[parts + 1] boundaries over ``len(weights)`` items,
    monotone even where weights are zero."""
    n = len(weights)
    total = float(weights.sum())
    cum = np.concatenate([[0.0], np.cumsum(weights, dtype=np.float64)])
    targets = np.linspace(0, total, parts + 1)
    bounds = np.searchsorted(cum, targets[1:-1], side="left")
    bounds = np.concatenate([[0], bounds, [n]]).astype(np.int64)
    return np.maximum.accumulate(bounds)


class Mesh:
    """This rank's view of a (kx × ny) grid of ranks, every rank of the
    default process group on it.

    ``shape``: (kx,) or (kx, ny); ``axis_names``: one name per axis.
    ``coords``: this rank's index along each axis; ``groups``: the
    process group of each axis (the ranks that share every other
    coordinate). Every rank must make the same meshes in the same order
    (``dist.new_group`` is collective)."""

    def __init__(self, shape, axis_names=("x",), device=None):
        import torch
        import torch.distributed as dist

        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names) or not 1 <= len(shape) <= 2:
            raise ValueError(f"mesh shape {shape} needs one name per axis, got {axis_names}")
        world = dist.get_world_size()
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {shape} != world size {world}")
        self.shape = shape
        self.axis_names = tuple(axis_names)
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device = torch.device(device) if device is not None else _rank_device()
        grid = np.arange(world).reshape(shape)
        self.coords = tuple(int(c) for c in np.argwhere(grid == self.rank)[0])
        self.groups = {}
        for ax, name in enumerate(self.axis_names):
            # the lines of the grid along this axis, every one made by every rank
            lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[name] = group

    @property
    def staged(self) -> bool:
        """The exchange goes through host memory (gloo with a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} (axes: {self.axis_names})")
        return self.axis_names.index(axis)

    def size(self, axis: str) -> int:
        return self.shape[self._axis(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self._axis(axis)]

    def __repr__(self) -> str:
        note = "; exchange staged through host memory" if self.staged else ""
        return (f"Mesh(shape={self.shape}, axes={self.axis_names}, rank={self.rank} at "
                f"{self.coords}, backend={self.backend}, device={self.device}{note})")

    def all_to_all(self, send, axis: str):
        """``send[ndst, cap]`` row d to the rank at index d along ``axis``;
        returns ``recv[nsrc, cap]``, row s from the rank at index s (the
        JAX package's ``lax.all_to_all(send, axis, 0, 0, tiled=False)``)."""
        import torch
        import torch.distributed as dist

        if send.shape[0] != self.size(axis):
            raise ValueError(f"send has {send.shape[0]} rows, axis {axis!r} {self.size(axis)} ranks")
        group = self.groups[axis]
        src = send.contiguous()
        if self.staged:
            src = src.cpu()
        recv = torch.empty_like(src)
        dist.all_to_all_single(recv, src, group=group)
        return recv.to(send.device) if self.staged else recv


def make_mesh(shape=None, axis_names=("x",), device=None) -> Mesh:
    """A :class:`Mesh` over the default process group on this rank's
    device (``device``, or see :func:`_rank_device`); ``shape=None`` is
    1-D over every rank."""
    import torch.distributed as dist

    if shape is None:
        shape = (dist.get_world_size(),)
    return Mesh(shape, axis_names, device=device)


# the device that run_world gave this rank (None outside a launched rank)
_RANK_DEVICE = None


def _rank_device():
    """This rank's device when the caller names none: the one
    :func:`run_world` gave it, else card ``rank % cards`` whatever the
    backend (the CPU only when asked for)."""
    import torch
    import torch.distributed as dist

    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    cards = torch.cuda.device_count()
    if not cards:
        raise ValueError("no CUDA device for this rank: pass device='cpu' to run on the CPU")
    return torch.device("cuda", dist.get_rank() % cards)


def _to_host(x):
    """Tensors in ``x`` (nested tuples, lists, dicts) as numpy arrays."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, world, tmp, backend, device, timeout, results):
    global _RANK_DEVICE
    try:
        import torch
        import torch.distributed as dist

        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        _RANK_DEVICE = dev
        with open(os.path.join(tmp, "job.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout),
            device_id=dev if backend == "nccl" else None,
        )
        try:
            out = _to_host(fn(*args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the caller, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_world(fn, world_size: int, *, backend: str, device: str = "cuda", args=(),
              timeout: float = 300.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` new ranks and return each
    rank's result (tensors as numpy arrays), in rank order.

    ``fn`` must be importable by name (a module's top-level function):
    the ranks are spawned and import it anew. ``backend`` is "nccl" (one
    rank per card, ``device`` "cuda") or "gloo" (``device`` "cuda": the
    ranks share the cards, ``rank % cards`` each; or "cpu"). A mesh
    made in a rank without a device of its own takes the rank's. The
    ranks meet at a ``file://`` rendezvous in a temporary directory. If
    a rank raises, or the world has not ended within ``timeout``
    seconds, every rank is stopped and the first failure is raised here."""
    import torch
    import torch.multiprocessing as mp

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev_type = torch.device(device).type
    if backend == "nccl":
        cards = torch.cuda.device_count() if dev_type == "cuda" else 0
        if world_size > cards:
            raise ValueError(
                f"nccl runs one rank per card: {world_size} ranks, {cards} cards "
                "(ranks that share a card need backend='gloo')")
    elif dev_type == "cuda" and not torch.cuda.is_available():
        raise ValueError("device 'cuda' needs a CUDA device")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="outerspace_world_") as tmp:
        # the function and its arguments go by file: a spawned rank that
        # unpickled them from its start pipe would import their modules
        # while the launcher waits on that pipe, one rank after another
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, tmp, backend, device, timeout, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out, failure = {}, None
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size and failure is None:
                try:
                    rank, ok, value = results.get(timeout=0.2)
                except Exception:  # queue.Empty: check the clock and the ranks
                    if time.monotonic() > deadline:
                        failure = f"the world of {world_size} ranks did not end within {timeout} s"
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead and failure is None:
                        failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                    continue
                if ok:
                    out[rank] = value
                else:
                    failure = f"rank {rank} raised:\n{value}"
        finally:
            for p in procs:
                if failure is None:
                    p.join(timeout=max(1.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.terminate()
                    p.join(5)
                    if p.is_alive():
                        p.kill()
                        p.join()
        if failure is None:
            codes = [p.exitcode for p in procs]
            if any(codes):
                failure = f"ranks exited with codes {codes}"
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world_size)]
