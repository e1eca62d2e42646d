"""K2, the merge epilogue: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the JAX package's Pallas kernel ``_scan_kernel``
(``ops/pallas/scan.py:57``, wrapper ``merge_epilogue_scan``), with the
same contract minus its power-of-two chunk constraint: over a stream
SORTED by biased key, each run's last slot holds the run's sum and its
unpacked (row, col); other slots hold (sentinel_row, 0, 0); ``valid``
marks the kept slots and ``nnz`` counts them. Sentinel (INT32_MAX) slots
are summed into the terminal slot, which is real iff their count exceeds
``pad_count`` — exact at m·n = 2³², where the corner (m−1, n−1) packs to
the sentinel's bit pattern. The kernel source is ``csrc/scan.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from outerspace_tpu_torch.runtime.build import CudaKernel, device_args, tensor_ptr

_I32_MAX = 2**31 - 1

KERNEL = CudaKernel(
    "scan",
    "scan_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)

# csrc/scan.cu's tiles: slots per tile, and the int32 fields of each
# tile's record in the scratch the wrapper allocates (one array per
# field, the tile count rounded up to 4)
TILE = 1024
_REC_FIELDS = 6


def _check(key, vals, n_cols, sentinel_row):
    if key.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"want int32 keys and float32 vals, got {key.dtype}, {vals.dtype}")
    if key.dim() != 1 or key.shape != vals.shape:
        raise ValueError(f"want equal 1-D streams, got {tuple(key.shape)}, {tuple(vals.shape)}")
    if not (key.is_contiguous() and vals.is_contiguous()):
        raise ValueError("streams must be contiguous")
    if key.device != vals.device:
        raise ValueError(f"keys on {key.device}, vals on {vals.device}")
    if not 0 < n_cols < 2**31 or not 0 <= sentinel_row < 2**31:
        raise ValueError(f"n_cols {n_cols} / sentinel_row {sentinel_row} out of int32 range")


def merge_epilogue_scan(
    key: torch.Tensor,  # int32[N] SORTED biased keys (sentinel-padded)
    vals: torch.Tensor,  # float32[N]
    pad_count: int,  # known padding slots among the sentinels
    *,
    n_cols: int,
    sentinel_row: int,
):
    """Returns (rows int32, cols int32, vals float32, valid bool,
    nnz int32 scalar), each stream of length N.

    CUDA tensors launch ``csrc/scan.cu`` (a pass over tiles of
    :data:`TILE` slots, then a carry pass over the tiles' records); CPU
    tensors run :func:`merge_epilogue_plain`; any other device raises."""
    _check(key, vals, n_cols, sentinel_row)
    dev = key.device
    if dev.type == "cpu":
        return merge_epilogue_plain(
            key, vals, pad_count, n_cols=n_cols, sentinel_row=sentinel_row
        )
    if dev.type != "cuda":
        raise ValueError(f"merge_epilogue_scan runs on cuda or cpu, not {dev}")
    n = key.shape[0]
    rows = torch.empty(n, dtype=torch.int32, device=dev)
    cols = torch.empty(n, dtype=torch.int32, device=dev)
    out_vals = torch.empty(n, dtype=torch.float32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    nnz = torch.empty((), dtype=torch.int32, device=dev)
    stride = -(-n // (4 * TILE)) * 4
    scratch = torch.empty(max(1, stride * _REC_FIELDS), dtype=torch.int32, device=dev)
    KERNEL.launch(
        tensor_ptr(key), tensor_ptr(vals), tensor_ptr(rows), tensor_ptr(cols),
        tensor_ptr(out_vals), tensor_ptr(valid), tensor_ptr(nnz),
        tensor_ptr(scratch), scratch.numel(), n, n_cols, sentinel_row, int(pad_count),
        *device_args(dev),
    )
    return rows, cols, out_vals, valid, nnz


def merge_epilogue_plain(key, vals, pad_count: int, *, n_cols: int, sentinel_row: int):
    """The same function as the kernel in plain PyTorch: run ids from a
    cumsum of run starts, run sums by ``index_add_``."""
    from outerspace_tpu_torch.ops.spgemm import unpack_key_biased

    n = key.shape[0]
    change = key[1:] != key[:-1]
    is_last = torch.ones(n, dtype=torch.bool, device=key.device)
    is_last[:-1] = change
    first = torch.ones(n, dtype=torch.bool, device=key.device)
    first[1:] = change
    run = torch.cumsum(first, 0) - 1
    nruns = int(run[-1]) + 1 if n else 0
    sums = torch.zeros(nruns, dtype=torch.float32, device=key.device)
    sums.index_add_(0, run, vals)
    is_sent = key == _I32_MAX
    corner_sum = torch.where(is_sent, vals, 0.0).sum()
    corner_real = is_sent.sum() > pad_count
    summed = torch.where(is_sent, corner_sum, sums[run])
    valid = is_last & (~is_sent | corner_real)
    row, col = unpack_key_biased(key, n_cols)
    return (
        torch.where(valid, row, sentinel_row),
        torch.where(valid, col, 0),
        torch.where(valid, summed, 0.0),
        valid,
        valid.sum(dtype=torch.int32),
    )
