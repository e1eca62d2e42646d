"""K3 and K4, the dense-tile expand: host staging, the CUDA kernels'
wrappers, and their plain PyTorch versions.

Replaces the JAX package's Pallas kernels ``_expand_kernel_packed``
(K3, ``ops/pallas/expand.py:45``, wrapper ``expand_tiles_packed``) and
``_expand_kernel_coords`` (K4, ``:87``, wrapper ``expand_tiles_coords``).
Task t of a class table (``sched.planner``) holds (a_len, b_block, b_lo,
b_hi); it forms the tile_a × 128 outer product of its A slice
(``a_rows_t[t]``, ``a_vals_t[t]``) with B block ``b_block``, masked to
``sub < a_len`` and ``b_lo ≤ lane < b_hi``. K3 writes the biased key
row·n + col − 2³¹ (int32 wrap) and a·b, or INT32_MAX / 0 where masked;
K4 writes (row, col, a·b), or (sentinel_row, 0, 0). Streams are
task-major, then sub, then lane. The kernel source is ``csrc/expand.cu``.

The JAX package launches a class in fixed-size slab calls only to reuse
compiled executables; the port launches the class's whole padded table
(``OuterProductSchedule.ntasks_padded``) once, which gives the same
stream in the same order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from outerspace_tpu_torch.runtime.build import CudaKernel, device_args, tensor_ptr
from outerspace_tpu_torch.sched.planner import TILE_B, OuterProductSchedule

_A_GROUP = 8  # table rows pad to multiples of 8, as the JAX package's do
_I32_MAX = 2**31 - 1

KERNEL_PACKED = CudaKernel(
    "expand",
    "expand_packed_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_int, ctypes.c_void_p],
)
KERNEL_COORDS = CudaKernel(
    "expand",
    "expand_coords_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_int, ctypes.c_void_p],
)


def b_blocks_host(
    b_csr_cols: np.ndarray,
    b_csr_vals: np.ndarray,
    nblocks_pad: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Flat B arrays zero-padded into (nblocks_pad, 128) block form.

    ``nblocks_pad=None`` buckets the block count (``round_up_bucket``) as
    the JAX package does; an explicit value (a multiple of 8 ≥ the
    natural count) pins it."""
    from outerspace_tpu_torch.ops.symbolic import round_up_bucket

    nnz_b = b_csr_cols.shape[0]
    nblocks = -(-max(nnz_b, 1) // TILE_B)
    if nblocks_pad is None:
        nblocks_pad = round_up_bucket(
            -(-nblocks // _A_GROUP) * _A_GROUP, min_size=_A_GROUP
        )
        nblocks_pad = -(-nblocks_pad // _A_GROUP) * _A_GROUP
    elif nblocks_pad < nblocks or nblocks_pad % _A_GROUP:
        raise ValueError(
            f"nblocks_pad={nblocks_pad} must be a multiple of {_A_GROUP} "
            f">= the natural block count {nblocks}"
        )
    pad_b = nblocks_pad * TILE_B - nnz_b
    cols_p = np.pad(b_csr_cols, (0, pad_b)).reshape(nblocks_pad, TILE_B)
    vals_p = np.pad(b_csr_vals, (0, pad_b)).reshape(nblocks_pad, TILE_B)
    return cols_p.astype(np.int32), vals_p.astype(np.float32)


def schedule_to_host(
    sched: OuterProductSchedule,
    ntasks_pad: int | None = None,
) -> dict[str, np.ndarray]:
    """One class's padded task table as host arrays (no B staging).

    ``ntasks_pad=None`` pads to the schedule's ``ntasks_padded``; an
    explicit value (a multiple of 8 ≥ ntasks) pins it. Padding tasks
    (a_len = 0) emit pure sentinel output."""
    ntasks = sched.ntasks
    if ntasks_pad is None:
        ntasks_pad = sched.ntasks_padded
    elif ntasks_pad < ntasks or ntasks_pad % _A_GROUP:
        raise ValueError(
            f"ntasks_pad={ntasks_pad} must be a multiple of {_A_GROUP} "
            f">= ntasks {ntasks}"
        )
    tile_a = sched.tile_a
    pad_t = ntasks_pad - ntasks
    tasks = np.zeros((ntasks_pad, 4), np.int32)
    if ntasks:
        tasks[:ntasks] = np.stack(
            [sched.a_len, sched.b_block, sched.b_lo, sched.b_hi], axis=1
        ).astype(np.int32)
    a_rows_t = np.pad(sched.a_rows_t, ((0, pad_t), (0, 0)))
    a_vals_t = np.pad(sched.a_vals_t, ((0, pad_t), (0, 0)))
    if a_rows_t.shape[0] == 0:
        a_rows_t = np.zeros((max(ntasks_pad, _A_GROUP), tile_a), np.int32)
        a_vals_t = np.zeros((max(ntasks_pad, _A_GROUP), tile_a), np.float32)
    return dict(
        tasks=tasks.reshape(-1),
        a_rows_t=a_rows_t.astype(np.int32),
        a_vals_t=a_vals_t.astype(np.float32),
    )


def _check(tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, tile_a):
    if not 1 <= tile_a <= TILE_B:
        raise ValueError(f"tile_a {tile_a} outside [1, {TILE_B}]")
    if tasks.dim() != 1 or tasks.shape[0] % 4:
        raise ValueError(f"tasks must be flat (a_len, b_block, b_lo, b_hi) rows, got {tuple(tasks.shape)}")
    ntasks = tasks.shape[0] // 4
    want = {
        "tasks": (tasks, torch.int32, (4 * ntasks,)),
        "a_rows_t": (a_rows_t, torch.int32, (ntasks, tile_a)),
        "a_vals_t": (a_vals_t, torch.float32, (ntasks, tile_a)),
        "b_cols_blk": (b_cols_blk, torch.int32, (b_cols_blk.shape[0], TILE_B)),
        "b_vals_blk": (b_vals_blk, torch.float32, (b_cols_blk.shape[0], TILE_B)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != tasks.device:
            raise ValueError(f"{name} is on {t.device}, tasks on {tasks.device}")
    if b_cols_blk.shape[0] < 1:
        raise ValueError("B must hold at least one block")
    return ntasks


def _launch(kernel, args, outs, ntasks, tile_a, last, dev):
    kernel.launch(
        *(tensor_ptr(t) for t in args), *(tensor_ptr(t) for t in outs),
        ntasks, tile_a, last, *device_args(dev),
    )


def expand_tiles_packed(
    tasks: torch.Tensor,  # int32[4·T]: (a_len, b_block, b_lo, b_hi) per task
    a_rows_t: torch.Tensor,  # int32[T, tile_a]
    a_vals_t: torch.Tensor,  # float32[T, tile_a]
    b_cols_blk: torch.Tensor,  # int32[NB, 128]
    b_vals_blk: torch.Tensor,  # float32[NB, 128]
    *,
    tile_a: int,
    n_cols: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: flat (keys int32, vals float32) of length T·tile_a·128.

    CUDA tensors launch ``csrc/expand.cu``; CPU tensors run
    :func:`expand_tiles_packed_plain`; any other device raises."""
    ntasks = _check(tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, tile_a)
    if not 0 < n_cols < 2**31:
        raise ValueError(f"n_cols {n_cols} out of int32 range")
    dev = tasks.device
    if dev.type == "cpu":
        return expand_tiles_packed_plain(
            tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk,
            tile_a=tile_a, n_cols=n_cols,
        )
    if dev.type != "cuda":
        raise ValueError(f"expand_tiles_packed runs on cuda or cpu, not {dev}")
    n = ntasks * tile_a * TILE_B
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    vals = torch.empty(n, dtype=torch.float32, device=dev)
    _launch(
        KERNEL_PACKED,
        (tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk), (keys, vals),
        ntasks, tile_a, n_cols, dev,
    )
    return keys, vals


def expand_tiles_coords(
    tasks: torch.Tensor,
    a_rows_t: torch.Tensor,
    a_vals_t: torch.Tensor,
    b_cols_blk: torch.Tensor,
    b_vals_blk: torch.Tensor,
    *,
    tile_a: int,
    sentinel_row: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: flat (rows int32, cols int32, vals float32) of length
    T·tile_a·128, the general form when m·n does not fit one key.

    CUDA tensors launch ``csrc/expand.cu``; CPU tensors run
    :func:`expand_tiles_coords_plain`; any other device raises."""
    ntasks = _check(tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, tile_a)
    if not 0 <= sentinel_row < 2**31:
        raise ValueError(f"sentinel_row {sentinel_row} out of int32 range")
    dev = tasks.device
    if dev.type == "cpu":
        return expand_tiles_coords_plain(
            tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk,
            tile_a=tile_a, sentinel_row=sentinel_row,
        )
    if dev.type != "cuda":
        raise ValueError(f"expand_tiles_coords runs on cuda or cpu, not {dev}")
    n = ntasks * tile_a * TILE_B
    rows = torch.empty(n, dtype=torch.int32, device=dev)
    cols = torch.empty(n, dtype=torch.int32, device=dev)
    vals = torch.empty(n, dtype=torch.float32, device=dev)
    _launch(
        KERNEL_COORDS,
        (tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk), (rows, cols, vals),
        ntasks, tile_a, sentinel_row, dev,
    )
    return rows, cols, vals


def _outer(tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, tile_a):
    """Mask, rows, cols and products over [T, tile_a, 128] (broadcast)."""
    task = tasks.view(-1, 4).long()
    a_len, b_block = task[:, 0, None, None], task[:, 1]
    b_lo, b_hi = task[:, 2, None, None], task[:, 3, None, None]
    sub = torch.arange(tile_a, device=tasks.device).view(1, -1, 1)
    lane = torch.arange(TILE_B, device=tasks.device).view(1, 1, -1)
    mask = (sub < a_len) & (lane >= b_lo) & (lane < b_hi)
    rows = a_rows_t.unsqueeze(2)
    cols = b_cols_blk[b_block].unsqueeze(1)
    vals = a_vals_t.unsqueeze(2) * b_vals_blk[b_block].unsqueeze(1)
    return mask, rows, cols, vals


def expand_tiles_packed_plain(
    tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, *, tile_a: int, n_cols: int
):
    """K3's function in plain PyTorch (int64 key arithmetic)."""
    from outerspace_tpu_torch.ops.spgemm import pack_key_biased

    mask, rows, cols, vals = _outer(tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, tile_a)
    keys = torch.where(mask, pack_key_biased(rows, cols, n_cols), _I32_MAX)
    return keys.reshape(-1), torch.where(mask, vals, 0.0).reshape(-1)


def expand_tiles_coords_plain(
    tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, *, tile_a: int, sentinel_row: int
):
    """K4's function in plain PyTorch."""
    mask, rows, cols, vals = _outer(tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, tile_a)
    return (
        torch.where(mask, rows, sentinel_row).reshape(-1),
        torch.where(mask, cols, 0).reshape(-1),
        torch.where(mask, vals, 0.0).reshape(-1),
    )
