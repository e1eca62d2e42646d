"""The MLP1 training step over a (dp × tp) mesh of ranks: data parallel
over "dp", Megatron-style tensor parallel over "tp". The counterpart of
the train step in the JAX package's multi-device dryrun
(``__graft_entry__.py``), where XLA partitions ``nn/train.py``'s step by
its parameter shardings; here every rank runs the step on its shards:

- ``dense.0`` (flax ``Dense_0``) is column-parallel: its weight's rows
  (out features) and its bias are split over "tp";
- ``dense.1`` (``Dense_1``) is row-parallel: its weight's columns (in
  features) are split, its partial outputs are summed over "tp"
  (:meth:`Mesh.reduce_sum`, whose backward passes the gradient through),
  then its replicated bias is added;
- the logits layer is replicated;
- the batch is split over "dp"; ``nn.train.loss_fn``'s cross-entropy and
  L2 terms are computed per rank, the L2 of a split weight or activation
  as the tp-sum of its shards' squares (so nothing counts twice);
- the gradients are averaged over "dp" and ``torch.optim.Adam`` (the
  port's settings, ``nn.train.make_optimizer``) steps each rank's shards.

:func:`shard_params` / :func:`unshard_params` carry a model's
``state_dict`` to a rank's shards and back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from outerspace_tpu_torch.nn.train import TrainConfig, make_optimizer

# (parameter, the dimension split over "tp", or None for replicated)
_SPLIT = {"dense.0.weight": 0, "dense.0.bias": 0, "dense.1.weight": 1}


def tp_shape(n: int) -> tuple[int, int]:
    """The (dp, tp) mesh shape of the dry run over ``n`` ranks: tp = 2
    where n is even, else 1."""
    tp = 2 if n % 2 == 0 else 1
    return n // tp, tp


def _check_mlp(state_dict) -> None:
    names = sorted(k for k in state_dict)
    want = [f"dense.{i}.{p}" for i in range(3) for p in ("bias", "weight")]
    if names != want:
        raise ValueError(f"the tp step takes an MLP1 state_dict ({want}), got {names}")


def shard_params(state_dict: dict, mesh) -> dict:
    """This rank's shards of an MLP1 ``state_dict`` (a contiguous copy of
    each split parameter's part, each replicated one whole), on
    ``mesh.device``."""
    _check_mlp(state_dict)
    tp, t = mesh.size("tp"), mesh.index("tp")
    out = {}
    for k, v in state_dict.items():
        dim = _SPLIT.get(k)
        if dim is not None:
            if v.shape[dim] % tp:
                raise ValueError(f"{k}: dimension {dim} ({v.shape[dim]}) does not divide tp={tp}")
            v = v.chunk(tp, dim=dim)[t]
        out[k] = v.detach().to(mesh.device).contiguous().clone()
    return out


def unshard_params(local: dict, mesh) -> dict:
    """The whole ``state_dict`` from every rank's shards (the split
    parameters all-gathered over "tp"), on every rank, on its device."""
    out = {}
    for k, v in local.items():
        dim = _SPLIT.get(k)
        v = v.detach()
        out[k] = v.clone() if dim is None else torch.cat(list(mesh.all_gather(v, "tp")), dim=dim)
    return out


class TPMLP(nn.Module):
    """MLP1 on one rank of a (dp, tp) mesh, from :func:`shard_params`'s
    shards. ``forward`` returns (logits, (the rank's features of the
    first hidden activation, the whole second)); logits are whole on
    every rank."""

    def __init__(self, local: dict, mesh):
        super().__init__()
        _check_mlp(local)
        self.mesh = mesh
        self.w = nn.ParameterDict({k.replace(".", "_"): nn.Parameter(v.clone())
                                   for k, v in sorted(local.items())})

    def param(self, name: str) -> nn.Parameter:
        return self.w[name.replace(".", "_")]

    def local_state_dict(self) -> dict:
        return {k.replace("_", ".", 2): v.detach() for k, v in self.w.items()}

    def forward(self, x):
        p = self.param
        x = x.reshape(x.shape[0], -1)
        h1 = F.relu(F.linear(x, p("dense.0.weight"), p("dense.0.bias")))  # this rank's features
        partial = F.linear(h1, p("dense.1.weight"))
        h2 = F.relu(self.mesh.reduce_sum(partial, "tp") + p("dense.1.bias"))
        logits = F.linear(h2, p("dense.2.weight"), p("dense.2.bias"))
        return logits, (h1, h2)


def tp_loss_fn(model: TPMLP, x, y, cfg: TrainConfig):
    """``nn.train.loss_fn`` on a rank's shards and its batch shard:
    (cross-entropy + L2, (cross-entropy, accuracy)), each for the rank's
    batch; the L2 of split weights and activations summed over "tp"."""
    logits, (h1, h2) = model(x)
    ce = F.cross_entropy(logits, y)
    reg = 0.0
    if cfg.l2reg:
        mesh = model.mesh
        # the weights in flax's order (Dense_0, Dense_1, Dense_2) and the
        # two hidden activations, zip stopping at the shorter list
        weights = [(model.param(f"dense.{i}.weight"), f"dense.{i}.weight" in _SPLIT)
                   for i in range(3)]
        for lam, (w, split) in zip(cfg.weight_lambdas, weights):
            sq = torch.sum(w * w)
            reg = reg + lam * (mesh.reduce_sum(sq, "tp") if split else sq)
        for lam, (a, split) in zip(cfg.act_lambdas, ((h1, True), (h2, False))):
            sq = torch.sum(a * a)
            reg = reg + lam * (mesh.reduce_sum(sq, "tp") if split else sq) / a.shape[0]
    acc = (logits.argmax(-1) == y).to(logits.dtype).mean()
    return ce + reg, (ce, acc)


def _dp_shard(t: torch.Tensor, mesh) -> torch.Tensor:
    dp, d = mesh.size("dp"), mesh.index("dp")
    if t.shape[0] % dp:
        raise ValueError(f"batch {t.shape[0]} does not divide dp={dp}")
    per = t.shape[0] // dp
    return t[d * per:(d + 1) * per]


def tp_train_step(model: TPMLP, opt, x, y, cfg: TrainConfig):
    """One step on the whole batch ``(x, y)`` (every rank passes the
    same; each takes its dp shard): forward, loss, backward, gradients
    averaged over "dp", Adam. Returns the whole batch's loss, a 0-d
    tensor on the rank's device (the dp mean of the shards' losses)."""
    mesh = model.mesh
    dp = mesh.size("dp")
    xs, ys = _dp_shard(x, mesh), _dp_shard(y, mesh)
    opt.zero_grad(set_to_none=True)
    loss, _ = tp_loss_fn(model, xs, ys, cfg)
    loss.backward()
    params = list(model.parameters())
    # every gradient in one all-reduce over dp
    flat = mesh.psum(torch.cat([p.grad.reshape(-1) for p in params]), "dp") / dp
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)
    opt.step()
    return mesh.psum(loss.detach(), "dp") / dp


def stage_tp(state_dict: dict, x, y, cfg: TrainConfig, mesh):
    """(model, optimizer, x, y): this rank's :class:`TPMLP` from
    ``state_dict``, its Adam (``nn.train.make_optimizer``), and the whole batch on ``mesh.device`` (x
    in the parameters' dtype, labels int64)."""
    dtype = next(iter(state_dict.values())).dtype
    model = TPMLP(shard_params(state_dict, mesh), mesh)
    xd = torch.as_tensor(np.asarray(x), dtype=dtype).to(mesh.device)
    yd = torch.as_tensor(np.asarray(y)).long().to(mesh.device)
    return model, make_optimizer(model, cfg), xd, yd
