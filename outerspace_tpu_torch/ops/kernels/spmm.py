"""K5, the block-ELL SpMM: host staging, the CUDA kernel's wrapper, its
plain PyTorch version, and the padded entry point.

Replaces the JAX package's Pallas kernel ``_spmm_kernel``
(``ops/pallas/spmm_kernel.py:30``, wrapper ``spmm_blockell_device``):
Y = W·X with W in block-ELL (``formats.compact.BlockELL``) and X dense.
For each row block, every slot whose mask is set adds
``W[ib, eff_slot] @ X[eff_col·bn : eff_col·bn + bn, :]`` to the row
block's output; a row block with no valid slot is zero. Full float32
arithmetic, as the TPU kernel's ``Precision.HIGHEST``. The kernel source
is ``csrc/spmm.cu``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from outerspace_tpu_torch.formats.compact import BlockELL
from outerspace_tpu_torch.runtime.build import CudaKernel, device_args, tensor_ptr

KERNEL = CudaKernel(
    "spmm",
    "spmm_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
)

# what csrc/spmm.cu takes: N_pad a multiple of tn, tn whole warps (the
# kernel tiles columns by its own 256 and masks the edge), row blocks and
# 8-row groups of bm on the grid's y and z axes
_MAX_TN = 256
_MAX_GRID_YZ = 65535


def blockell_to_device(w: BlockELL, device="cuda") -> dict[str, torch.Tensor]:
    """Stage a BlockELL weight matrix for K5: ``meta`` int32
    [nrb·max_blocks, 3] = (effective block col, mask, effective w-slot)
    and ``blocks`` f32 [nrb, max_blocks, bm, bn], on ``device``.

    Masked (padding) slots take the nearest previous valid slot's block
    col and w-slot (leading pads take the first valid's), as in the JAX
    package: the TPU pipeline then issues no copy for them. K5 skips them
    outright; the meta stays the same array for array."""
    bc = np.asarray(w.block_cols, dtype=np.int32)
    mask = np.asarray(w.block_mask, dtype=bool)
    nrb, mb = bc.shape
    slot = np.tile(np.arange(mb, dtype=np.int64), (nrb, 1))
    idx = np.where(mask, slot, -1)
    last = np.maximum.accumulate(idx, axis=1)  # -1 before any valid
    any_valid = mask.any(axis=1)
    first = np.where(any_valid, mask.argmax(axis=1), 0).astype(np.int64)
    src = np.where(last >= 0, last, first[:, None])  # [nrb, mb]
    bc_eff = np.take_along_axis(bc, src, axis=1)
    meta = np.stack(
        [
            bc_eff.reshape(-1).astype(np.int32),
            mask.reshape(-1).astype(np.int32),
            src.reshape(-1).astype(np.int32),
        ],
        axis=1,
    )
    return dict(
        meta=torch.from_numpy(meta).to(device),
        blocks=torch.from_numpy(np.ascontiguousarray(w.blocks)).to(device),
    )


def _check(meta, blocks, x, tn):
    if meta.dtype != torch.int32 or blocks.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(
            f"want int32 meta, float32 blocks and x, got {meta.dtype}, {blocks.dtype}, {x.dtype}"
        )
    if blocks.dim() != 4 or x.dim() != 2:
        raise ValueError(f"want 4-D blocks and 2-D x, got {tuple(blocks.shape)}, {tuple(x.shape)}")
    nrb, mb, _, bn = blocks.shape
    if tuple(meta.shape) != (nrb * mb, 3):
        raise ValueError(f"meta {tuple(meta.shape)} does not match blocks {tuple(blocks.shape)}")
    k_pad, n_pad = x.shape
    if bn == 0 or k_pad % bn or tn <= 0 or n_pad % tn:
        raise ValueError(f"want bn | K_pad and tn | N_pad, got bn {bn}, tn {tn}, x {tuple(x.shape)}")
    if not (meta.is_contiguous() and blocks.is_contiguous() and x.is_contiguous()):
        raise ValueError("meta, blocks and x must be contiguous")
    if not meta.device == blocks.device == x.device:
        raise ValueError(f"meta on {meta.device}, blocks on {blocks.device}, x on {x.device}")


def spmm_blockell_device(
    meta: torch.Tensor,  # int32[nrb·max_blocks, 3] from blockell_to_device
    blocks: torch.Tensor,  # f32[nrb, max_blocks, bm, bn]
    x: torch.Tensor,  # f32[K_pad, N_pad] (bn | K_pad, tn | N_pad)
    tn: int = 128,
) -> torch.Tensor:
    """Y = W @ X with W in block-ELL; returns f32[nrb·bm, N_pad].

    CUDA tensors launch ``csrc/spmm.cu`` (one block per (row block,
    256 columns, 8-row group of ``bm``), which reads only the X rows a
    nonzero weight needs, so a NaN in another row does not reach Y;
    ``tn`` a multiple of 32 up to 256, else it raises); CPU tensors run
    :func:`spmm_blockell_plain`; any other device raises. Every block
    column in ``meta`` must index a ``bn``-row block of X."""
    _check(meta, blocks, x, tn)
    dev = x.device
    if dev.type == "cpu":
        return spmm_blockell_plain(meta, blocks, x)
    if dev.type != "cuda":
        raise ValueError(f"spmm_blockell_device runs on cuda or cpu, not {dev}")
    nrb, mb, bm, bn = blocks.shape
    n_pad = x.shape[1]
    if tn % 32 or tn > _MAX_TN:
        raise ValueError(f"K5 takes tn a multiple of 32 up to {_MAX_TN}, got {tn}")
    if nrb > _MAX_GRID_YZ or -(-bm // 8) > _MAX_GRID_YZ:
        raise ValueError(f"K5 takes at most {_MAX_GRID_YZ} row blocks and bm ≤ {8 * _MAX_GRID_YZ}")
    y = torch.empty((nrb * bm, n_pad), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    KERNEL.launch(
        tensor_ptr(meta), tensor_ptr(blocks), tensor_ptr(x), tensor_ptr(y),
        nrb, mb, bm, bn, n_pad, tn, *device_args(dev),
    )
    return y


def spmm_blockell_plain(meta, blocks, x) -> torch.Tensor:
    """The same function as the kernel in plain PyTorch: a loop over
    slots, each a batched product of every row block's slot block with
    the X rows its block column names, added where the mask is set."""
    nrb, mb, bm, bn = blocks.shape
    k_pad, n_pad = x.shape
    meta3 = meta.view(nrb, mb, 3).long()
    xb = x.view(k_pad // bn, bn, n_pad)
    rb = torch.arange(nrb, device=x.device)
    out = torch.zeros((nrb, bm, n_pad), dtype=torch.float32, device=x.device)
    for s in range(mb):
        col, valid, slot = meta3[:, s, 0], meta3[:, s, 1] != 0, meta3[:, s, 2]
        prod = torch.bmm(blocks[rb, slot], xb[col])
        out += torch.where(valid[:, None, None], prod, 0.0)
    return out.reshape(nrb * bm, n_pad)


def spmm(w: BlockELL, x, tn: int = 128, device="cuda") -> torch.Tensor:
    """Y = W @ X for a block-ELL W and a dense X (f32[K, N], numpy or
    torch) on ``device``: stages W, pads X to K5's alignment, launches,
    and crops the result to (M, N)."""
    m, k = w.shape
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.ndim != 2 or x.shape[0] != k:
        raise ValueError(f"X shape {tuple(x.shape)} incompatible with W {w.shape}")
    bm, bn = w.block_shape
    n = x.shape[1]
    k_pad = w.blocks.shape[0] and -(-k // bn) * bn
    k_pad = max(k_pad, bn)
    n_pad = -(-n // tn) * tn
    x_p = torch.zeros((k_pad, n_pad), dtype=torch.float32, device=device)
    x_p[:k, :n] = x
    dev = blockell_to_device(w, device)
    y = spmm_blockell_device(dev["meta"], dev["blocks"], x_p, tn=tn)
    return y[:m, :n]
