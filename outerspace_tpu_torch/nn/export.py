"""Lowering pruned layers to GEMMs and exporting them as ``.mtx``
SpGEMM operands (the JAX package's ``nn/export.py``).

Kernels become 2-D (out, in) matrices and images im2col patch rows, so
that ``patches @ W_2dᵀ`` is the convolution (the lowering the reference
exported for its simulator, ``NN_models/get_mtx_files.py:117-133``).
:func:`export_mlp1` / :func:`export_lenet` zero the weights under 1e-2,
run one batch through the model and write every weight and every layer's
input as ``.mtx``, with the JAX package's file names and layer contract:
``act_i.mtx × layer_weight.mtx`` computes ``act @ Wᵀ``. Weight files are
the JAX package's byte for byte.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from outerspace_tpu_torch.formats import COO, write_mtx
from outerspace_tpu_torch.nn.models import MLP1, make_model
from outerspace_tpu_torch.nn.prune import zero_small_weights


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


def _save(path: str, arr: torch.Tensor) -> None:
    write_mtx(path, COO.from_dense(arr.detach().cpu().numpy().astype(np.float32)))


def _dense_weights(params) -> list[str]:
    return [k for k in params if k.startswith("dense.") and k.endswith(".weight")]


def _forward(model_type, params, x_batch, weight_zero_tol, device):
    """(the weights with |w| < ``weight_zero_tol`` zeroed, the input on
    ``device``, the model's (logits, activations) on it)."""
    from outerspace_tpu_torch.nn.sparse_infer import _device  # imports this module

    params = zero_small_weights(params, weight_zero_tol)
    if model_type == "MLP1":
        # hidden widths from the weights: MLP1w exports through this path
        model = MLP1(hidden=[params[k].shape[0] for k in _dense_weights(params)[:-1]])
    else:
        model = make_model(model_type)
    model.load_state_dict(params)
    dev = _device(device)
    model.to(dev)
    x = torch.as_tensor(np.asarray(x_batch, np.float32), device=dev)
    with torch.no_grad():
        out = model(x)
    return params, x, out


def export_mlp1(
    params, x_batch: np.ndarray, save_dir: str, weight_zero_tol: float = 1e-2, device="cuda"
) -> dict[str, str]:
    """Export an MLP1 (any hidden widths; ``params`` a ``state_dict``) and
    one batch of its activations, computed on ``device``, as .mtx files:
    fc{1,2,3}_weight, act_0 (input), act_1, act_2, logits. Returns
    {name: path}."""
    os.makedirs(save_dir, exist_ok=True)
    params, x, (logits, (a1, a2)) = _forward("MLP1", params, x_batch, weight_zero_tol, device)
    files = {}
    for i, k in enumerate(_dense_weights(params)):
        p = os.path.join(save_dir, f"fc{i + 1}_weight.mtx")
        _save(p, params[k])
        files[f"fc{i + 1}_weight"] = p
    for name, arr in [("act_0", x.reshape(x.shape[0], -1)), ("act_1", a1), ("act_2", a2),
                      ("logits", logits)]:
        p = os.path.join(save_dir, f"{name}.mtx")
        _save(p, arr)
        files[name] = p
    return files


def export_lenet(
    params, x_batch: np.ndarray, save_dir: str, weight_zero_tol: float = 1e-2, device="cuda"
) -> dict[str, str]:
    """Export LeNet's layers (``params`` a ``state_dict``) as .mtx GEMM
    pairs with one batch's inputs, computed on ``device``: conv{1,2}_input
    (im2col of the image with k5/p2 and of pool1 with k5/p0) and
    conv{1,2}_weight (out, in·k·k); fc{1,2,3}_input and fc{1,2,3}_weight;
    logits. Returns {name: path}."""
    os.makedirs(save_dir, exist_ok=True)
    params, x, (logits, acts) = _forward("LeNet", params, x_batch, weight_zero_tol, device)
    _, pool1, _, _, flat, fc1_out, fc2_out = acts
    x = x.reshape(-1, 28, 28, 1)
    files = {}
    layers = [(f"conv{i + 1}", params[f"conv.{i}.weight"], inp)
              for i, inp in enumerate((im2col(x, 5, 2), im2col(pool1, 5, 0)))]
    layers += [(f"fc{i + 1}", params[f"dense.{i}.weight"], inp)
               for i, inp in enumerate((flat, fc1_out, fc2_out))]
    for name, w, inp in layers:
        wp = os.path.join(save_dir, f"{name}_weight.mtx")
        ap = os.path.join(save_dir, f"{name}_input.mtx")
        _save(wp, w.reshape(w.shape[0], -1))
        _save(ap, inp)
        files[f"{name}_weight"] = wp
        files[f"{name}_input"] = ap
    p = os.path.join(save_dir, "logits.mtx")
    _save(p, logits)
    files["logits"] = p
    return files
