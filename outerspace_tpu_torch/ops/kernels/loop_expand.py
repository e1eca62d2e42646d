"""The expand of each MCL loop squaring: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces no Pallas kernel: the JAX package runs the loop's flat expand
(segment broadcasts, gathers, key packing) as XLA ops in its
``_mcl_iteration``. The loop's state is a CSC stream (``kcsc``: sorted
keys ``col·m + row`` of :func:`~.compact.key_dtype`, a sentinel tail;
``vals``; the column starts ``starts_ext``). Element f = (k, c) pairs
with CSC column k and owns the product slots ``[offsets[f],
offsets[f+1])``; slot p reads stream position ``starts_ext[k] + p −
offsets[f]`` and gets the key of (c, that position's row) in ``kcsc``'s
dtype and the value ``vals[f]·vals[j]``. Slots at or past ``p_clamped``
(a 0-d int64 on the stream's device, ≤ ``p_pad``) hold the sentinel and
0. The kernel source is ``csrc/loop_expand.cu``: it writes each slot's
key and value once and reads each product's B-side key and value.
"""

from __future__ import annotations

import ctypes

import torch

from outerspace_tpu_torch.ops.kernels.compact import _pack, _sentinel, _unpack
from outerspace_tpu_torch.ops.spgemm import expand_partial_products
from outerspace_tpu_torch.runtime.build import CudaKernel, device_args, tensor_ptr

_ARGS = ([ctypes.c_void_p] * 5
         + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int]
         + [ctypes.c_void_p] * 2
         + [ctypes.c_int, ctypes.c_void_p])
KERNEL = CudaKernel("loop_expand", "loop_expand_launch", _ARGS)
KERNEL_64 = CudaKernel("loop_expand", "loop_expand64_launch", _ARGS)


def divider(m: int) -> tuple[int, int]:
    """(magic, shift) with ``u // m == (u·magic) >> shift`` for every
    0 ≤ u < 2⁶³: shift = 63 + ⌈log2 m⌉, magic = ⌈2^shift / m⌉ < 2⁶⁴."""
    shift = 63 + (m - 1).bit_length()
    return -(-(1 << shift) // m), shift


def _check(kcsc, vals, starts_ext, offsets, p_clamped, p_pad: int, m: int):
    if kcsc.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"want int32 or int64 keys, got {kcsc.dtype}")
    if vals.dtype != torch.float32 or starts_ext.dtype != torch.int32:
        raise TypeError(f"want float32 vals and int32 starts_ext, got {vals.dtype}, "
                        f"{starts_ext.dtype}")
    if offsets.dtype != torch.int64 or p_clamped.dtype != torch.int64:
        raise TypeError(f"want int64 offsets and p_clamped, got {offsets.dtype}, "
                        f"{p_clamped.dtype}")
    if not 0 < m < 2**31 or not 0 <= p_pad < 2**31:
        raise ValueError(f"m {m} / p_pad {p_pad} out of int32 range")
    elem_pad = kcsc.shape[0] if kcsc.dim() == 1 else -1
    shapes = ((kcsc, elem_pad), (vals, elem_pad), (starts_ext, m + 1), (offsets, elem_pad + 1))
    if elem_pad < 0 or any(t.dim() != 1 or t.shape[0] != n for t, n in shapes):
        raise ValueError(f"want 1-D kcsc, vals [elem_pad], starts_ext [m+1] and offsets "
                         f"[elem_pad+1], got {[tuple(t.shape) for t, _ in shapes]} at m {m}")
    if p_clamped.dim() != 0:
        raise ValueError(f"want a 0-d p_clamped, got shape {tuple(p_clamped.shape)}")
    tensors = (kcsc, vals, starts_ext, offsets, p_clamped)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if any(t.device != kcsc.device for t in tensors):
        raise ValueError(f"inputs on {[str(t.device) for t in tensors]}")


def loop_expand(kcsc, vals, starts_ext, offsets, p_clamped, *, p_pad: int, m: int):
    """The product slots of one loop squaring: (key [p_pad] in
    ``kcsc``'s dtype, value float32[p_pad]), unsorted, in slot order.

    CPU tensors run :func:`loop_expand_plain`; CUDA tensors launch
    ``csrc/loop_expand.cu`` once (:data:`KERNEL`, or for int64 keys
    :data:`KERNEL_64`) and read ``p_clamped`` there, not on the host."""
    _check(kcsc, vals, starts_ext, offsets, p_clamped, p_pad, m)
    dev = kcsc.device
    if dev.type == "cpu":
        return loop_expand_plain(kcsc, vals, starts_ext, offsets, p_clamped, p_pad=p_pad, m=m)
    if dev.type != "cuda":
        raise ValueError(f"the loop_expand kernel runs on cuda, not {dev}")
    key = torch.empty(p_pad, dtype=kcsc.dtype, device=dev)
    val = torch.empty(p_pad, dtype=torch.float32, device=dev)
    (KERNEL_64 if kcsc.dtype == torch.int64 else KERNEL).launch(
        tensor_ptr(kcsc), tensor_ptr(vals), tensor_ptr(starts_ext), tensor_ptr(offsets),
        tensor_ptr(p_clamped), kcsc.shape[0], p_pad, m, *divider(m),
        tensor_ptr(key), tensor_ptr(val), *device_args(dev),
    )
    return key, val


def loop_expand_plain(kcsc, vals, starts_ext, offsets, p_clamped, *, p_pad: int, m: int):
    """The same function in plain PyTorch, on any device: the flat expand
    (:func:`~outerspace_tpu_torch.ops.spgemm.expand_partial_products`)
    over the stream's elements, then the keys packed."""
    col_f, row_f = _unpack(kcsc, m)
    sent = _sentinel(kcsc.dtype)
    valid_f = kcsc != sent
    c, r, v = expand_partial_products(
        torch.where(valid_f, col_f, m), torch.where(valid_f, vals, 0.0),
        torch.where(valid_f, row_f, 0), starts_ext, row_f, vals, offsets, p_clamped, p_pad, m,
    )
    key = torch.where(torch.arange(p_pad, device=kcsc.device) < p_clamped,
                      _pack(c, r, m, kcsc.dtype), sent)
    return key, v
