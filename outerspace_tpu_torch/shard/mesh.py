"""The device mesh of the sharded mode, on ``torch.distributed``, and the
launcher that starts its ranks.

The JAX package runs one ``shard_map`` program over a ``jax.sharding.Mesh``
(``make_mesh``). Here every rank of a process group runs the same
function (SPMD): a :class:`Mesh` gives the rank its coordinates on a
(kx × ny) grid, the process group of each axis, and its
``torch.device``; ``lax.all_to_all`` over an axis becomes
:meth:`Mesh.all_to_all`, one ``dist.all_to_all_single``; ``lax.psum``
and ``lax.all_gather`` become :meth:`Mesh.psum` (``dist.all_reduce``) and
:meth:`Mesh.all_gather` (``dist.all_gather_into_tensor``), over one axis
or the whole mesh, and :meth:`Mesh.reduce_sum` is the psum autograd
differentiates (tensor parallelism). Rank r sits at
(r // ny, r % ny), as ``np.array(devices).reshape(shape)`` orders the
JAX mesh's devices.

The backend is the caller's to name:

- ``nccl``: one rank per card, CUDA tensors throughout;
- ``gloo``: CPU tensors, or ranks that share a card (NCCL refuses two
  ranks on one GPU). On a card the kernels still run there; only the
  collectives are staged through host memory, and the mesh says so.

:func:`run_world` spawns the ranks, meets them at a ``file://``
rendezvous in a temporary directory, runs one function on each, and
raises in the caller any exception a rank raised. A :class:`LiveWorld`
keeps its ranks alive across calls instead (a world costs seconds to
start): the calling process is rank 0, and ranks 1 to n − 1 run one
step each time it calls.
"""

from __future__ import annotations

import datetime
import functools
import os
import pickle
import sys
import tempfile
import threading
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

    def _group(self, axes):
        """The process group of ``axes``: one axis name (or a 1-tuple),
        or every axis of the mesh (the default group)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            self._axis(a)
        if len(set(axes)) == len(self.axis_names):
            return None
        if len(axes) != 1:
            raise ValueError(f"axes {axes}: one axis or all of {self.axis_names}")
        return self.groups[axes[0]]

    def psum(self, t, axes):
        """The sum of ``t`` over the ranks along ``axes`` (one axis, or
        every axis of the mesh), on every one of them (the JAX package's
        ``lax.psum``); ``t`` is not changed."""
        import torch.distributed as dist

        out = t.detach().clone() if not self.staged else t.detach().cpu()
        dist.all_reduce(out, group=self._group(axes))
        return out.to(t.device) if self.staged else out

    def all_gather(self, t, axes):
        """``t`` of every rank along ``axes`` stacked in their index order,
        ``[size, *t.shape]``, on every one of them (``lax.all_gather``)."""
        import torch
        import torch.distributed as dist

        group = self._group(axes)
        size = dist.get_world_size(group)
        src = t.contiguous().reshape(-1)
        if self.staged:
            src = src.cpu()
        out = torch.empty(size * src.numel(), dtype=src.dtype, device=src.device)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, src, group=group)
        out = out.view(size, *t.shape)
        return out.to(t.device) if self.staged else out

    def reduce_sum(self, t, axes):
        """Differentiable :meth:`psum` for tensor parallelism (Megatron's
        "g"): the sum over ``axes`` in the forward; in the backward the
        gradient passes through unchanged, since every rank's loss counts
        the sum once."""
        return _reduce_sum_fn().apply(t, self, axes)


@functools.cache
def _reduce_sum_fn():
    import torch

    class ReduceSum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, mesh, axes):
            return mesh.psum(t, axes)

        @staticmethod
        def backward(ctx, grad):
            return grad, None, None

    return ReduceSum


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


def _join_world(rank, world, tmp, backend, device, timeout, threads):
    """A spawned rank's start: its device and threads, the job's function
    and arguments (from ``tmp/job.pkl``), the process group. Returns
    ``(fn, args)``."""
    global _RANK_DEVICE
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    torch.set_num_threads(max(1, threads // world))
    _RANK_DEVICE = dev
    with open(os.path.join(tmp, "job.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=timeout),
        device_id=dev if backend == "nccl" else None,
    )
    return fn, args


def _rank_main(rank, world, tmp, backend, device, timeout, threads, results):
    try:
        import torch.distributed as dist

        fn, args = _join_world(rank, world, tmp, backend, device, timeout, threads)
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
    ranks meet at a ``file://`` rendezvous in a temporary directory and
    split threads between them, one at least each: on the CPU the
    caller's intra-op threads (``torch.get_num_threads()``), with cards
    the host's cores. If a rank raises, or the world has
    not ended within ``timeout`` seconds, every rank is stopped and the
    first failure is raised here."""
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
    threads = torch.get_num_threads() if dev_type == "cpu" else (os.cpu_count() or 1)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="outerspace_world_") as tmp:
        # the function and its arguments go by file: a spawned rank that
        # unpickled them from its start pipe would import their modules
        # while the launcher waits on that pipe, one rank after another
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, tmp, backend, device, timeout,
                                   threads, results))
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


def _live_main(rank, world, tmp, backend, device, timeout, threads, commands, results):
    """A rank of a :class:`LiveWorld`: join the world, make its step
    function, then run one step per command until told to stop, or
    until the process that started it is gone."""
    parent = os.getppid()
    try:
        import torch.distributed as dist

        fn, args = _join_world(rank, world, tmp, backend, device, timeout, threads)
        step = fn(*args)
        results.put((rank, "ready", None))
        while True:
            try:
                cmd = commands.get(timeout=1.0)
            except Exception:  # queue.Empty: the starting process may have gone
                if os.getppid() != parent:
                    os._exit(1)
                continue
            if cmd is None:
                break
            results.put((rank, "done", _to_host(step())))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


class LiveWorld:
    """A world of ``world_size`` ranks kept alive across calls; the
    calling process is rank 0 (on card 0, or the CPU), ranks 1 to
    n − 1 are spawned as :func:`run_world`'s are (card ``rank % cards``,
    a ``file://`` rendezvous in a temporary directory).

    On each spawned rank ``fn(*args)`` runs once, after the process
    group is up, and returns that rank's step function; ``fn`` must be
    importable by name. The caller then makes rank 0's own part
    (the same meshes, in the same order) and calls :meth:`call` with
    rank 0's step: every spawned rank runs its step, rank 0 runs its
    own, and the call returns rank 0's result and the others' (tensors
    as numpy arrays, in rank order).

    A rank that raises, or dies, while rank 0 may be waiting on it in a
    collective (at start-up, or during a call) ends this process: its
    error goes to stderr, every spawned rank is killed, and the process
    exits with code 1, since a collective that rank 0 waits in cannot be
    given up from Python. Outside a call it closes the world, and the
    next call raises. An exception of rank 0's own step closes the world
    and is raised. :meth:`close` stops and joins every spawned rank."""

    def __init__(self, world_size: int, fn, args=(), *, backend: str, device: str = "cuda",
                 timeout: float = 600.0):
        import torch
        import torch.distributed as dist
        import torch.multiprocessing as mp

        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        dev = torch.device(device)
        if backend == "nccl" and (dev.type != "cuda" or world_size > torch.cuda.device_count()):
            raise ValueError(f"nccl runs one rank per card: {world_size} ranks, "
                             f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} cards")
        if dist.is_initialized():
            raise RuntimeError("this process is already in a process group")
        self.world_size, self.timeout = world_size, timeout
        self.device = torch.device("cuda", 0) if dev.type == "cuda" else dev
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self._tmp = tempfile.TemporaryDirectory(prefix="outerspace_live_")
        tmp = self._tmp.name
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f, protocol=pickle.HIGHEST_PROTOCOL)
        ctx = mp.get_context("spawn")
        threads = torch.get_num_threads() if dev.type == "cpu" else (os.cpu_count() or 1)
        self._results = ctx.Queue()
        self._commands = [ctx.Queue() for _ in range(1, world_size)]
        self._procs = [ctx.Process(target=_live_main, daemon=True,
                                   args=(r, world_size, tmp, backend, device, timeout, threads,
                                         self._commands[r - 1], self._results))
                       for r in range(1, world_size)]
        self._lock = threading.Lock()
        self._waiting = True  # rank 0 may wait in a collective on the others
        self._failure = None
        self._closed = False
        for p in self._procs:
            p.start()
        self._stop = threading.Event()
        self._inbox: dict = {}
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            world_size=world_size, rank=0, timeout=datetime.timedelta(seconds=timeout),
            device_id=self.device if backend == "nccl" else None,
        )
        with self._lock:
            self._waiting = False

    def _fail(self, message: str) -> None:
        """A spawned rank failed: end the process if rank 0 may be
        waiting on it, else close the world."""
        with self._lock:
            self._failure = self._failure or message
            waiting = self._waiting
        if waiting:
            print(f"LiveWorld: {message}", file=sys.stderr, flush=True)
            self._kill()
            os._exit(1)

    def _watchdog(self) -> None:
        while not self._stop.is_set():
            try:
                rank, kind, value = self._results.get(timeout=0.2)
            except Exception:  # queue.Empty: look at the ranks
                dead = [r for r, p in enumerate(self._procs, 1) if p.exitcode is not None]
                if dead and not self._closed:
                    self._fail(f"rank {dead[0]} exited with code "
                               f"{self._procs[dead[0] - 1].exitcode}")
                continue
            if kind == "error":
                self._fail(f"rank {rank} raised:\n{value}")
            else:
                with self._lock:
                    self._inbox.setdefault(kind, {})[rank] = value

    def _await(self, kind: str) -> list:
        """Every spawned rank's message of ``kind``, in rank order."""
        deadline = time.monotonic() + self.timeout
        while True:
            with self._lock:
                got = self._inbox.get(kind, {})
                if len(got) == self.world_size - 1:
                    self._inbox[kind] = {}
                    return [got[r] for r in range(1, self.world_size)]
                failure = self._failure
            if failure is not None:
                raise RuntimeError(f"the world is closed: {failure}")
            if time.monotonic() > deadline:
                self._fail(f"the ranks did not answer within {self.timeout} s")
            time.sleep(0.001)

    def ready(self) -> None:
        """Wait until every spawned rank has made its step function."""
        with self._lock:
            self._waiting = True
        self._await("ready")
        with self._lock:
            self._waiting = False

    def call(self, step0):
        """Every spawned rank runs its step and rank 0 runs ``step0()``;
        returns (rank 0's result, [the other ranks' results])."""
        if self._closed or self._failure is not None:
            raise RuntimeError(f"the world is closed: {self._failure or 'closed'}")
        with self._lock:
            self._waiting = True
        for q in self._commands:
            q.put(True)
        try:
            out = step0()
        except BaseException:
            self._failure = self._failure or "rank 0 raised"
            self.close()
            raise
        others = self._await("done")
        with self._lock:
            self._waiting = False
        return out, others

    def _kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(5)

    def close(self) -> None:
        """Stop every spawned rank and join it (killed if it has not
        ended within seconds), then leave the process group."""
        import torch.distributed as dist

        if self._closed:
            return
        self._closed = True
        healthy = self._failure is None
        if healthy:
            for q in self._commands:
                q.put(None)
            deadline = time.monotonic() + 10.0
            for p in self._procs:
                p.join(max(0.1, deadline - time.monotonic()))
        self._stop.set()
        self._kill()
        if dist.is_initialized():
            if healthy:
                dist.destroy_process_group()
            else:  # a collective may be pending on the dead ranks: do not wait on it
                abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
                try:
                    abort() if abort is not None else dist.destroy_process_group()
                except Exception:
                    pass
        self._tmp.cleanup()
