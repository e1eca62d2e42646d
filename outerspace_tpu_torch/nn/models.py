"""MLP1 and LeNet as torch modules: the models the training pipeline
trains and the dense oracles of the sparse-NN path, with the JAX
package's flax models' shapes and interface (``nn/models.py``).

- ``MLP1``: 784 → 100 → 100 → 10 (``hidden`` sets the widths), ReLU.
- ``LeNet``: conv(1→6, k5, pad 2) + maxpool2, conv(6→16, k5, valid) +
  maxpool2, fc 400 → 120 → 84 → 10.

Both return ``(logits, activations)``, activations in the flax models'
NHWC layout. LeNet computes in NCHW but flattens its pool2 output in
NHWC order (h, w, c), as flax does, so the carried fc1 weights apply.
Weights come from the flax parameter dicts via
``outerspace_tpu_torch.convert.state_dict_from_params``, or fresh from
:func:`init_lecun_normal_`, flax's default initialisation.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class MLP1(nn.Module):
    """784-100-100-10 ReLU MLP returning (logits, hidden activations)."""

    def __init__(self, hidden: Sequence[int] = (100, 100), n_classes: int = 10):
        super().__init__()
        widths = [784, *hidden, n_classes]
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
        )

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        acts = []
        for layer in self.dense[:-1]:
            x = F.relu(layer(x))
            acts.append(x)
        return self.dense[-1](x), tuple(acts)


def _nhwc(h):
    return h.permute(0, 2, 3, 1)


class LeNet(nn.Module):
    """LeNet-5 variant returning (logits, 7 intermediate activations):
    conv1-out, pool1-out, conv2-out, pool2-out, flat, fc1-out, fc2-out."""

    def __init__(self, n_classes: int = 10):
        super().__init__()
        self.conv = nn.ModuleList([nn.Conv2d(1, 6, 5, padding=2), nn.Conv2d(6, 16, 5)])
        self.dense = nn.ModuleList(
            [nn.Linear(400, 120), nn.Linear(120, 84), nn.Linear(84, n_classes)]
        )

    def forward(self, x):
        if x.ndim == 2:  # flat 784 input
            x = x.reshape(x.shape[0], 28, 28, 1)
        elif x.ndim == 3:
            x = x[..., None]
        h = x.permute(0, 3, 1, 2)  # NHWC → NCHW
        acts = []
        for conv in self.conv:
            h = F.relu(conv(h))
            acts.append(_nhwc(h))
            h = F.max_pool2d(h, 2)
            acts.append(_nhwc(h))
        h = _nhwc(h).reshape(h.shape[0], -1)  # 5*5*16 = 400, (h, w, c) order
        acts.append(h)
        for layer in self.dense[:-1]:
            h = F.relu(layer(h))
            acts.append(h)
        return self.dense[-1](h), tuple(acts)


def make_model(model_type: str) -> nn.Module:
    if model_type == "MLP1":
        return MLP1()
    if model_type == "MLP1w":
        # the reference's 784-1000-1000-10 variant, behind its 1%-dense
        # pruned artifact
        return MLP1(hidden=(1000, 1000))
    if model_type == "LeNet":
        return LeNet()
    raise ValueError(f"unknown model type {model_type!r}")


# flax's ``variance_scaling(..., "truncated_normal")`` divides the
# stddev by the std of a unit normal truncated to [-2, 2], so the draws'
# variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_lecun_normal_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Flax's default initialisation, in place: every Linear and Conv2d
    weight from ``lecun_normal`` (a normal truncated at ±2 of its
    stddev, variance 1 / fan_in, fan_in = in · kh · kw for a conv), every
    bias zero. Draws come from a ``torch.Generator`` seeded with ``seed``,
    on the CPU, layer by layer in module order, so the values do not
    depend on the model's device (they are not the JAX PRNG's values)."""
    gen = torch.Generator().manual_seed(seed)
    for layer in model.modules():
        if isinstance(layer, (nn.Linear, nn.Conv2d)):
            w = layer.weight
            std = math.sqrt(1.0 / (w[0].numel())) / _TRUNC_STD
            draw = torch.empty(w.shape, dtype=w.dtype)
            nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std, generator=gen)
            w.copy_(draw)
            layer.bias.zero_()
    return model


def activation_sparsity(acts) -> list[float]:
    """Fraction of nonzero entries per activation."""
    return [float((a != 0).float().mean()) for a in acts]
