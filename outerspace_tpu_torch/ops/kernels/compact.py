"""The prune and compaction after the MCL chain's first squaring: the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces no Pallas kernel: the JAX package prunes and compacts the first
squaring's merged stream with XLA ops in its ``mcl_whole_traced`` (the
prune, then a compaction and a sort). A slot survives iff it is valid
and max(v, 0) > ``thr_root``; each survivor becomes the biased CSC key
``col·m + row − 2³¹`` with the value max(v, 0), in the first of
``elem_pad`` slots, the rest (INT32_MAX, 0). The survivors come in no
set order: the caller sorts the ``elem_pad`` slots, and since K2 merged
the stream their keys are unique, so the sorted result does not depend
on it. ``ok``: the survivors fit ``elem_pad``, so that every one of
them is kept. The kernel source is ``csrc/prune_compact.cu``: it reads
5 bytes a slot (value and valid) and the survivors' rows and columns.

From m² ≥ 2³² on (:func:`key_dtype`) the keys pass 32 bits: they are
the plain int64 ``col·m + row``, the fill INT64_MAX, and CUDA tensors
take the kernel's 64-bit instantiation (:data:`KERNEL_64`). The chain's
key format lives here, for the chain and the loop expand alike:
:func:`key_dtype`, :func:`_sentinel`, :func:`_pack`, :func:`_unpack`.
"""

from __future__ import annotations

import ctypes

import torch

from outerspace_tpu_torch.ops.spgemm import KEY_BIAS, pack_key_biased
from outerspace_tpu_torch.runtime.build import CudaKernel, device_args, tensor_ptr

_I32_MAX = 2**31 - 1
_I64_MAX = 2**63 - 1

_ARGS = ([ctypes.c_void_p] * 4
         + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int]
         + [ctypes.c_void_p] * 4
         + [ctypes.c_int, ctypes.c_void_p])
KERNEL = CudaKernel("prune_compact", "prune_compact_launch", _ARGS)
KERNEL_64 = CudaKernel("prune_compact", "prune_compact64_launch", _ARGS)


def key_dtype(m: int, n: int | None = None) -> torch.dtype:
    """The dtype of the MCL chain's keys over an m×n index space (n = m
    by default): biased int32 while m·n < 2³², else int64."""
    return torch.int64 if m * (m if n is None else n) >= 2**32 else torch.int32


def _sentinel(dtype: torch.dtype) -> int:
    """The empty slot's key in a key stream of ``dtype``."""
    return _I64_MAX if dtype == torch.int64 else _I32_MAX


def _pack(major: torch.Tensor, minor: torch.Tensor, n_minor: int, dtype: torch.dtype):
    """The key ``major·n_minor + minor`` in ``dtype``: biased int32
    (:func:`~outerspace_tpu_torch.ops.spgemm.pack_key_biased`) or plain
    int64."""
    if dtype == torch.int64:
        return major.long() * n_minor + minor.long()
    return pack_key_biased(major, minor, n_minor)


def _ukey(key: torch.Tensor) -> torch.Tensor:
    """The unsigned value (int64) of the chain's keys: biased int32 keys
    shifted by 2³¹, int64 keys as they are."""
    return key if key.dtype == torch.int64 else key.long() - KEY_BIAS


def _unpack(key: torch.Tensor, n_minor: int):
    """Inverse of :func:`_pack`: (major, minor) as int32."""
    ku = _ukey(key)
    return (ku // n_minor).to(torch.int32), (ku % n_minor).to(torch.int32)


def _check(rows, cols, vals, valid, m: int, elem_pad: int):
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError(f"want int32 rows and cols, got {rows.dtype}, {cols.dtype}")
    if vals.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"want float32 vals and bool valid, got {vals.dtype}, {valid.dtype}")
    streams = (rows, cols, vals, valid)
    if any(s.dim() != 1 or s.shape != rows.shape for s in streams):
        raise ValueError(f"want equal 1-D streams, got {[tuple(s.shape) for s in streams]}")
    if not all(s.is_contiguous() for s in streams):
        raise ValueError("streams must be contiguous")
    if any(s.device != rows.device for s in streams):
        raise ValueError(f"streams on {[str(s.device) for s in streams]}")
    if rows.shape[0] >= 2**31:
        raise ValueError(f"a stream of {rows.shape[0]} slots exceeds the int32 index space")
    if not 0 < m < 2**31 or not 0 <= elem_pad < 2**31:
        raise ValueError(f"m {m} / elem_pad {elem_pad} out of int32 range")


def prune_compact(rows, cols, vals, valid, *, thr_root: float, m: int, elem_pad: int):
    """The first squaring's merged stream (int32 rows and cols, float32
    vals, bool valid; K2's output) pruned and compacted into ``elem_pad``
    slots. Returns (kp [elem_pad] of :func:`key_dtype` of m, vp
    float32[elem_pad], ok 0-d bool): the survivors first, unsorted, then
    (the dtype's maximum, 0). Where
    ``ok`` is false the caller falls back and ``kp``, ``vp`` are not
    used.

    CPU tensors run :func:`prune_compact_plain`; CUDA tensors launch
    ``csrc/prune_compact.cu`` once (:data:`KERNEL` or, for int64 keys,
    :data:`KERNEL_64`), and need ``vals`` 16-byte and ``valid`` 4-byte
    aligned (the kernel's vector loads)."""
    _check(rows, cols, vals, valid, m, elem_pad)
    dev = rows.device
    if dev.type == "cpu":
        return prune_compact_plain(rows, cols, vals, valid, thr_root=thr_root, m=m,
                                   elem_pad=elem_pad)
    if dev.type != "cuda":
        raise ValueError(f"the prune_compact kernel runs on cuda, not {dev}")
    if vals.data_ptr() % 16 or valid.data_ptr() % 4:
        raise ValueError("vals must start 16-byte and valid 4-byte aligned (the kernel's "
                         "vector loads)")
    wide = key_dtype(m) == torch.int64
    kp = torch.empty(elem_pad, dtype=torch.int64 if wide else torch.int32, device=dev)
    vp = torch.empty(elem_pad, dtype=torch.float32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    counts = torch.empty(1, dtype=torch.int32, device=dev)
    (KERNEL_64 if wide else KERNEL).launch(
        tensor_ptr(rows), tensor_ptr(cols), tensor_ptr(vals), tensor_ptr(valid),
        rows.shape[0], float(thr_root), m, elem_pad,
        tensor_ptr(kp), tensor_ptr(vp), tensor_ptr(ok), tensor_ptr(counts),
        *device_args(dev),
    )
    return kp, vp, ok


def prune_compact_plain(rows, cols, vals, valid, *, thr_root: float, m: int, elem_pad: int):
    """The same function in plain PyTorch, on any device: the survivors
    in stream order (the first ``elem_pad`` of them), keys computed in
    int64."""
    v = torch.clamp(vals, min=0.0)
    idx = torch.nonzero(valid & (v > thr_root)).squeeze(1)
    ok = torch.tensor(idx.shape[0] <= elem_pad, device=rows.device)
    take = idx[:elem_pad]
    n = take.shape[0]
    dtype = key_dtype(m)
    kp = torch.full((elem_pad,), _sentinel(dtype), dtype=dtype, device=rows.device)
    vp = torch.zeros(elem_pad, dtype=torch.float32, device=rows.device)
    kp[:n] = _pack(cols[take], rows[take], m, dtype)
    vp[:n] = v[take]
    return kp, vp, ok
