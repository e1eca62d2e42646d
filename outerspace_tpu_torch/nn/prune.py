"""Magnitude pruning and sparsity reporting on a torch model's
``state_dict`` (the JAX package's ``nn/prune.py``).

Per-layer magnitude pruning: threshold = quantile(|W|, 1 - level),
weights at or below it zeroed, fc weights to ``sparsity_level`` (0.1) and
conv weights (4-D) to ``conv_sparsity_level`` (0.25); only ``weight``
tensors are pruned, never biases. The threshold is ``np.quantile`` of the
host copy of |W|, and every threshold is compared in the weights' dtype,
as in the JAX package (its ``jnp.abs(w) > thr`` casts the Python float to
the array's dtype), so the masks are the JAX package's element for
element.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _is_weight(name: str) -> bool:
    return name.rsplit(".", 1)[-1] == "weight"


def _in_dtype(x: float, w: torch.Tensor) -> float:
    """``x`` rounded to ``w``'s dtype (a Python float that the dtype holds
    exactly, so comparing ``w`` with it is a comparison in that dtype)."""
    return float(torch.tensor(x, dtype=w.dtype))


def get_sparsity(w) -> tuple[int, int, float]:
    """(nnz, numel, nnz/numel) of a tensor or array."""
    w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    nnz = int(np.count_nonzero(w))
    return nnz, w.size, nnz / max(w.size, 1)


def prune_threshold(w, sparsity_level: float) -> float:
    """|W| quantile such that ~``sparsity_level`` of the entries survive."""
    w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    return float(np.quantile(np.abs(w), 1.0 - sparsity_level))


def prune_params(
    params: dict[str, torch.Tensor],
    sparsity_level: float = 0.1,
    conv_sparsity_level: float | None = 0.25,
) -> dict[str, torch.Tensor]:
    """A new ``state_dict`` with every weight magnitude-pruned to its
    target nonzero fraction: fc weights to ``sparsity_level``, conv
    weights to ``conv_sparsity_level`` (``sparsity_level`` when None)."""
    out = {}
    for name, w in params.items():
        if _is_weight(name):
            level = (
                conv_sparsity_level
                if (w.ndim == 4 and conv_sparsity_level is not None)
                else sparsity_level
            )
            w = w * (w.abs() > _in_dtype(prune_threshold(w, level), w))
        out[name] = w
    return out


def nonzero_masks(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Boolean masks of the surviving weights, by parameter name: the
    finetune gradient mask. Biases are never masked, so they have none."""
    return {name: w != 0 for name, w in params.items() if _is_weight(name)}


@torch.no_grad()
def apply_grad_mask(model: nn.Module, masks: dict[str, torch.Tensor]) -> None:
    """Zero the gradients of pruned weights in place."""
    for name, p in model.named_parameters():
        if name in masks and p.grad is not None:
            p.grad.mul_(masks[name])


def sparsity_report(params: dict[str, torch.Tensor]) -> dict[str, tuple[int, int, float]]:
    """Per-tensor (nnz, numel, fraction), by ``state_dict`` name."""
    return {name: get_sparsity(w) for name, w in params.items()}


def zero_small_weights(
    params: dict[str, torch.Tensor], threshold: float = 1e-2
) -> dict[str, torch.Tensor]:
    """A new ``state_dict`` with |w| < ``threshold`` zeroed in the weights
    (the exporter's cleanup pass); biases pass through."""
    return {
        name: (w * (w.abs() >= _in_dtype(threshold, w)) if _is_weight(name) else w)
        for name, w in params.items()
    }
