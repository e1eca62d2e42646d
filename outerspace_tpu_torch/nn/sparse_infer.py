"""Sparse inference: the pruned-NN forward pass through the port's
kernels (the JAX package's ``nn/sparse_infer.py``).

- ``spgemm`` path: activation and weight both sparse, ``act @ Wᵀ`` per
  layer through the port's SpGEMM (K1, sort, K2 on the card), what the
  reference's ``./simulator act_i.mtx fcN_weight.mtx`` simulated;
- ``spmm`` path: block-ELL weights × dense activations through K5
  (``ops/kernels/spmm.py``), the serving path: :class:`SparseMLP` and
  :class:`SparseLeNet` stage the weights on the card once and run each
  layer as one K5 launch; ``SparseMLP.sharded`` serves a batch split over
  the ranks of a mesh.

Both must match the dense forward within 1e-6 relative to the output's
largest magnitude (the reference's eps, ``SimSpGEMM.cpp:283``), so all
arithmetic is full float32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from outerspace_tpu_torch.formats import COO, BlockELL
from outerspace_tpu_torch.nn.export import (
    conv_kernel_to_2d,
    dense_kernel_to_2d,
    im2col,
    im2col_np,
)
from outerspace_tpu_torch.ops.kernels.spmm import (
    blockell_to_device,
    spmm,
    spmm_blockell_device,
)
from outerspace_tpu_torch.ops.reference import spgemm_scipy
from outerspace_tpu_torch.ops.spgemm import spgemm

BLOCK_SHAPE = (8, 128)  # (bm, bn) of the staged weights
TN = 128  # K5's column tile: activations pad to a multiple of it


def _relu(x: np.ndarray) -> np.ndarray:
    return np.maximum(x, 0.0)


def _layers(params, prefix: str) -> list[str]:
    return sorted(k for k in params.keys() if k.startswith(prefix))


def _sparse_mult(backend: str, device):
    """``act @ Wᵀ`` for COO operands: the port's SpGEMM on ``device``
    ("torch") or the scipy oracle ("scipy"), as a dense numpy array."""
    if backend == "torch":
        return lambda a, b: spgemm(a, b, device=device).to_dense()
    if backend == "scipy":
        return lambda a, b: spgemm_scipy(a, b).to_dense()
    raise ValueError(f"unknown backend {backend!r}: want 'torch' or 'scipy'")


def mlp_forward_dense(params, x: np.ndarray) -> np.ndarray:
    """Plain dense forward in numpy (oracle)."""
    h = x.reshape(x.shape[0], -1)
    layers = _layers(params, "Dense")
    for i, layer in enumerate(layers):
        w = np.asarray(params[layer]["kernel"])
        b = np.asarray(params[layer]["bias"])
        h = h @ w + b
        if i < len(layers) - 1:
            h = _relu(h)
    return h


def mlp_forward_spgemm(
    params, x: np.ndarray, backend: str = "torch", device="cuda"
) -> np.ndarray:
    """Forward pass where every ``act @ Wᵀ`` runs as sparse × sparse
    SpGEMM (activations are post-ReLU sparse, weights pruned).

    ``backend``: "torch" = the port's SpGEMM on ``device``; "scipy" =
    the CPU oracle."""
    mult = _sparse_mult(backend, device)
    h = np.asarray(x, dtype=np.float32).reshape(x.shape[0], -1)
    layers = _layers(params, "Dense")
    for i, layer in enumerate(layers):
        w2d = dense_kernel_to_2d(params[layer]["kernel"])  # (out, in)
        b = np.asarray(params[layer]["bias"])
        h = mult(COO.from_dense(h), COO.from_dense(w2d).T) + b
        if i < len(layers) - 1:
            h = _relu(h)
    return h


def mlp_forward_spmm(params, x: np.ndarray, device="cuda") -> np.ndarray:
    """Forward pass with block-ELL sparse weights × dense activations
    through K5, weights staged per call: ``h' = (W_blockell @ hᵀ)ᵀ + b``."""
    h = torch.as_tensor(np.asarray(x, np.float32), device=device).reshape(x.shape[0], -1)
    layers = _layers(params, "Dense")
    for i, layer in enumerate(layers):
        w2d = dense_kernel_to_2d(params[layer]["kernel"])  # (out, in)
        b = torch.as_tensor(np.asarray(params[layer]["bias"], np.float32), device=device)
        w_ell = BlockELL.from_coo(COO.from_dense(w2d), block_shape=BLOCK_SHAPE)
        h = spmm(w_ell, h.T, device=device).T + b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h.cpu().numpy()


def _maxpool2_np(h: np.ndarray) -> np.ndarray:
    return h.reshape(h.shape[0], h.shape[1] // 2, 2, h.shape[2] // 2, 2, -1).max(axis=(2, 4))


def lenet_forward_spgemm(
    params, x: np.ndarray, backend: str = "torch", device="cuda"
) -> np.ndarray:
    """LeNet forward with every layer lowered to sparse GEMM: conv layers
    as im2col(input) @ Wᵀ (the reference's lowering for its simulator,
    ``get_mtx_files.py:117-133``), fc layers as act @ Wᵀ, each through
    SpGEMM. im2col and pooling run in numpy on the host."""
    mult = _sparse_mult(backend, device)

    def sp_mm(dense_act: np.ndarray, w2d: np.ndarray) -> np.ndarray:
        return mult(COO.from_dense(np.asarray(dense_act, np.float32)), COO.from_dense(w2d).T)

    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 2:
        x = x.reshape(-1, 28, 28, 1)
    elif x.ndim == 3:
        x = x[..., None]
    n = x.shape[0]
    convs = _layers(params, "Conv")
    fcs = _layers(params, "Dense")

    h = x
    for name, pad, side, ch in ((convs[0], 2, 28, 6), (convs[1], 0, 10, 16)):
        w2d = conv_kernel_to_2d(params[name]["kernel"])
        b = np.asarray(params[name]["bias"])
        h = np.maximum(sp_mm(im2col_np(h, 5, pad), w2d) + b, 0.0)
        h = _maxpool2_np(h.reshape(n, side, side, ch))
    h = h.reshape(n, -1)  # 400, (h, w, c) order
    for i, layer in enumerate(fcs):
        h = sp_mm(h, dense_kernel_to_2d(params[layer]["kernel"])) + np.asarray(
            params[layer]["bias"]
        )
        if i < len(fcs) - 1:
            h = _relu(h)
    return h


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for, but no CUDA device is available")
    return dev


class SparseLayer(nn.Module):
    """One pruned layer staged for K5: block-ELL meta and blocks of the
    (out, in) weight matrix and the bias, as buffers on ``device``."""

    def __init__(self, w2d: np.ndarray, bias, device):
        super().__init__()
        w2d = np.asarray(w2d, np.float32)
        self.out_dim, self.in_dim = w2d.shape
        self.k_pad = -(-self.in_dim // BLOCK_SHAPE[1]) * BLOCK_SHAPE[1]
        w_ell = BlockELL.from_coo(COO.from_dense(w2d), block_shape=BLOCK_SHAPE)
        staged = blockell_to_device(w_ell, device)
        self.register_buffer("meta", staged["meta"])
        self.register_buffer("blocks", staged["blocks"])
        self.register_buffer("bias", torch.as_tensor(np.asarray(bias, np.float32), device=device))

    def forward(self, h_t: torch.Tensor) -> torch.Tensor:
        """(features ≤ in_dim, n) → (out_dim, n): one K5 launch on the
        zero-padded (k_pad, n rounded up to TN) activations."""
        n = h_t.shape[1]
        hp = h_t.new_zeros((self.k_pad, -(-n // TN) * TN))
        hp[: h_t.shape[0], :n] = h_t
        y = spmm_blockell_device(self.meta, self.blocks, hp, tn=TN)
        return y[: self.out_dim, :n] + self.bias[:, None]


class SparseMLP(nn.Module):
    """Serving-shaped sparse MLP: block-ELL weights staged on ``device``
    once (default "cuda"; "cpu" runs K5's plain version), each layer one
    K5 launch on the features-major activations."""

    def __init__(self, params, device="cuda"):
        super().__init__()
        self.device = _device(device)
        self.layers = nn.ModuleList(
            SparseLayer(dense_kernel_to_2d(params[name]["kernel"]), params[name]["bias"], self.device)
            for name in _layers(params, "Dense")
        )

    @torch.inference_mode()
    def forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        h = x.reshape(x.shape[0], -1).T  # (features, batch)
        for li, layer in enumerate(self.layers):
            h = layer(h)
            if li < len(self.layers) - 1:
                h = torch.relu(h)
        return h.T

    def sharded(self, mesh, axis: str = "dp"):
        """Data-parallel serving over ``axis`` of ``mesh`` (every rank of
        the mesh holds this model, staged on ``mesh.device``, and calls
        the returned function with the same whole batch): each rank runs
        the forward, three K5 launches, on its contiguous shard of the
        batch, and the logits are all-gathered along ``axis``, so every
        rank returns the whole batch's. The batch must divide the axis
        size."""
        held = self.layers[0].blocks.device  # where the weights were staged
        want = mesh.device
        if want.type == "cuda" and want.index is None:
            want = torch.device("cuda", torch.cuda.current_device())
        if held != want:
            raise ValueError(f"the model's weights are on {held}, the mesh's rank on {want}")
        n_dev, d = mesh.size(axis), mesh.index(axis)

        @torch.inference_mode()
        def run(x) -> torch.Tensor:
            x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            batch = x.shape[0]
            if batch % n_dev:
                raise ValueError(f"batch {batch} does not divide the {n_dev} ranks of {axis!r}")
            per = batch // n_dev
            y = self(x[d * per:(d + 1) * per])
            return mesh.all_gather(y, axis).reshape(batch, -1)

        return run


def _maxpool2(h: torch.Tensor) -> torch.Tensor:
    n, hh, ww, c = h.shape
    return h.reshape(n, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))


class SparseLeNet(nn.Module):
    """Device-resident sparse LeNet: every layer im2col-lowered to a GEMM
    with the pruned weights staged once as block-ELL operands of K5 on
    ``device``; im2col, bias, ReLU and the pools are torch operations on
    the same device. Five K5 launches per forward."""

    def __init__(self, params, device="cuda"):
        super().__init__()
        self.device = _device(device)
        convs = _layers(params, "Conv")
        self.convs = nn.ModuleList(
            SparseLayer(conv_kernel_to_2d(params[n]["kernel"]), params[n]["bias"], self.device)
            for n in convs
        )
        self.fcs = nn.ModuleList(
            SparseLayer(dense_kernel_to_2d(params[n]["kernel"]), params[n]["bias"], self.device)
            for n in _layers(params, "Dense")
        )

    @torch.inference_mode()
    def forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        n = x.shape[0]
        h = x.reshape(n, 28, 28, 1)
        for layer, pad in zip(self.convs, (2, 0)):
            side = h.shape[1] + 2 * pad - 4
            h = torch.relu(layer(im2col(h, 5, pad).T).T)  # (rows, out_dim)
            h = _maxpool2(h.reshape(n, side, side, layer.out_dim))
        h = h.reshape(n, -1)  # (n, 400), (h, w, c) order
        for li, layer in enumerate(self.fcs):
            h = layer(h.T).T
            if li < len(self.fcs) - 1:
                h = torch.relu(h)
        return h
