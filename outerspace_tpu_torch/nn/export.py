"""Lowering pruned layers to GEMMs: kernels to 2-D (out, in) matrices and
images to im2col patch rows, so that ``patches @ W_2dᵀ`` is the
convolution (the lowering the reference exported for its simulator,
``NN_models/get_mtx_files.py:117-133``). The numpy helpers are the JAX
package's ``nn/export.py`` ones; :func:`im2col` is its torch counterpart.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def im2col(x: torch.Tensor, kernel: int, padding: int) -> torch.Tensor:
    """Unfold NHWC images into (N·out_h·out_w, C·k·k) patch rows, rows in
    (n, oh, ow) order and features in (C, kh, kw) order — the order of
    :func:`im2col_np`, of the JAX package's ``conv_general_dilated_patches``
    and of :func:`conv_kernel_to_2d`. A pure copy (every value is one of
    the input's or a padding zero): a strided window view of the padded
    images, then one copy. ``F.unfold`` computes the same rows but
    launches one kernel per image on the card."""
    n, _, _, c = x.shape
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    win = xp.unfold(1, kernel, 1).unfold(2, kernel, 1)  # (n, oh, ow, C, kh, kw)
    return win.reshape(n * win.shape[1] * win.shape[2], c * kernel * kernel)


def im2col_np(x: np.ndarray, kernel: int, padding: int) -> np.ndarray:
    """Pure-numpy :func:`im2col` with the identical (C, kh, kw) feature
    order."""
    x = np.asarray(x)
    n, _, _, c = x.shape
    xp = np.pad(x, ((0, 0), (padding, padding), (padding, padding), (0, 0)))
    win = np.lib.stride_tricks.sliding_window_view(
        xp, (kernel, kernel), axis=(1, 2)
    )  # (n, out_h, out_w, C, kh, kw) — already (C, kh, kw) order
    oh, ow = win.shape[1], win.shape[2]
    return np.ascontiguousarray(
        win.reshape(n * oh * ow, c * kernel * kernel)
    )


def conv_kernel_to_2d(w: np.ndarray) -> np.ndarray:
    """Flax-layout conv kernel (kh, kw, in, out) → (out, in·kh·kw) rows
    matching im2col's (C, kh, kw) feature order."""
    kh, kw, cin, cout = w.shape
    return np.transpose(np.asarray(w), (3, 2, 0, 1)).reshape(cout, cin * kh * kw)


def dense_kernel_to_2d(w: np.ndarray) -> np.ndarray:
    """Flax-layout dense kernel (in, out) → (out, in), the torch Linear
    layout, so ``act @ Wᵀ`` is the layer."""
    return np.asarray(w).T
