"""Training, evaluation and finetuning of MLP1 / LeNet on the card (the
JAX package's ``nn/train.py``).

- Adam (lr 1e-3, β (0.9, 0.999), eps 1e-8) and cross-entropy, optionally
  a warmup + cosine learning-rate schedule (optax's
  ``warmup_cosine_decay_schedule``, value for value) and ±2 px shift
  augmentation;
- optional L2 regularisation of the weights and of the activations, with
  per-layer lambdas paired in flax's parameter order (sorted layer
  names: ``Conv_*`` before ``Dense_*``);
- finetune mode masks the gradients of pruned weights before the step
  and the weights after it, so pruned zeros stay zero;
- best-validation snapshots and loss / accuracy history.

Parameters are a model's ``state_dict``; :func:`save_params` writes them
as the JAX package's pickle of the flax parameter dict, which
``convert.load_params``, ``SparseMLP`` / ``SparseLeNet`` and the JAX
package read. Each split is staged on the device once and every batch is
gathered there; the loss and accuracy are summed on the device and read
once per epoch.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from outerspace_tpu_torch.convert import params_from_state_dict, state_dict_from_params
from outerspace_tpu_torch.convert import load_params as _load_flax_params
from outerspace_tpu_torch.nn.data import batch_index_sets
from outerspace_tpu_torch.nn.models import init_lecun_normal_, make_model
from outerspace_tpu_torch.nn.prune import apply_grad_mask, nonzero_masks
from outerspace_tpu_torch.nn.sparse_infer import _device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model_type: str = "MLP1"
    num_epochs: int = 5
    batch_size: int = 1024
    lr: float = 1e-3
    # "const": plain Adam; "cosine": warmup + cosine decay
    lr_schedule: str = "const"
    # random ±2 px shift augmentation (zero fill), on the host
    augment: bool = False
    l2reg: bool = False
    weight_lambdas: tuple = (1e-4, 1e-4, 1e-4)
    act_lambdas: tuple = (1e-5, 1e-5)
    finetune: bool = False
    seed: int = 0


def _flax_name(param_name: str) -> str:
    prefix, i, _ = param_name.split(".")
    return f"{prefix.capitalize()}_{i}"


def kernels(model: nn.Module) -> list[torch.Tensor]:
    """The weight tensors in flax's parameter order (layer names sorted
    as strings, ``Conv_0`` … before ``Dense_0`` …), the order in which
    the weight lambdas pair with them."""
    named = {_flax_name(n): p for n, p in model.named_parameters() if n.endswith(".weight")}
    return [named[k] for k in sorted(named)]


def loss_fn(model: nn.Module, x, y, cfg: TrainConfig):
    """(cross-entropy + L2 terms, (cross-entropy, accuracy)). The L2 is
    Σ λ·ΣW² over the first ``len(weight_lambdas)`` weights in flax's
    order plus Σ λ·Σa²/batch over the first ``len(act_lambdas)``
    activations (``zip`` stops at the shorter list)."""
    logits, acts = model(x)
    ce = F.cross_entropy(logits, y)
    reg = 0.0
    if cfg.l2reg:
        for lam, w in zip(cfg.weight_lambdas, kernels(model)):
            reg = reg + lam * torch.sum(w * w)
        for lam, a in zip(cfg.act_lambdas, acts):
            reg = reg + lam * torch.sum(a * a) / a.shape[0]
    acc = (logits.argmax(-1) == y).float().mean()
    return ce + reg, (ce, acc)


@functools.cache
def _cosf():
    # XLA's float32 cosine on the CPU is the C library's cosf; with it the
    # schedule below is optax's value bit for bit
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    libm.cosf.argtypes = [ctypes.c_float]
    libm.cosf.restype = ctypes.c_float
    return libm.cosf


def warmup_cosine(
    count: int,
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float,
) -> float:
    """optax's ``warmup_cosine_decay_schedule`` at step ``count``, in its
    float32 arithmetic: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps`` (warmup included) and constant after."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, "
                         f"got {decay_steps} and {warmup_steps}")
    f32 = np.float32
    if count < warmup_steps:
        frac = f32(1) - f32(max(count, 0)) / f32(warmup_steps)
        return float(f32(init_value - peak_value) * frac + f32(peak_value))
    span = decay_steps - warmup_steps
    t = f32(min(count - warmup_steps, span))
    alpha = end_value / peak_value if peak_value else 0.0
    cos = f32(_cosf()(float(f32(math.pi) * t / f32(span))))
    decayed = f32(0.5) * (f32(1) + cos)
    return float(f32(peak_value) * (f32(1 - alpha) * decayed + f32(alpha)))


def lr_schedule(cfg: TrainConfig, n_train: int):
    """The learning rate by step (a function of the number of steps taken
    before it) for ``lr_schedule="cosine"``, else None (constant
    ``cfg.lr``): warmup from 0.1·lr over a twentieth of the run, cosine
    decay to 0.01·lr at its last step."""
    if cfg.lr_schedule != "cosine":
        return None
    steps_per_epoch = max(1, -(-n_train // cfg.batch_size))
    total = cfg.num_epochs * steps_per_epoch
    return functools.partial(
        warmup_cosine,
        init_value=cfg.lr * 0.1,
        peak_value=cfg.lr,
        warmup_steps=max(1, total // 20),
        decay_steps=total,
        end_value=cfg.lr * 0.01,
    )


def make_optimizer(model: nn.Module, cfg: TrainConfig) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def _steps_taken(opt: torch.optim.Optimizer) -> int:
    state = opt.state.get(opt.param_groups[0]["params"][0])
    return int(state["step"]) if state else 0


def train_step(model, opt, x, y, cfg: TrainConfig, masks=None, schedule=None):
    """One optimizer step on the batch (x, y); returns the loss (with its
    L2 terms) and the accuracy as 0-d tensors on the model's device, not
    read. ``schedule`` (from :func:`lr_schedule`) sets the learning rate
    from the steps the optimizer has taken before this one, as optax
    does. In finetune (``cfg.finetune``), ``masks`` (from
    ``prune.nonzero_masks``) zero the pruned weights' gradients before
    the step and the weights after it."""
    if schedule is not None:
        lr = schedule(_steps_taken(opt))
        for group in opt.param_groups:
            group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss, (_, acc) = loss_fn(model, x, y, cfg)
    loss.backward()
    if cfg.finetune:
        apply_grad_mask(model, masks)
    opt.step()
    if cfg.finetune:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name in masks:
                    p.mul_(masks[name])
    return loss.detach(), acc.detach()


def shift_augment(xb: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random per-sample ±2 px translations with zero fill (images are
    0-1 normalised, so zero is background). Accepts (B, 784) or
    (B, 28, 28[, 1]); returns the same shape."""
    shape = xb.shape
    b = shape[0]
    img = np.asarray(xb, dtype=np.float32).reshape(b, 28, 28)
    pad = np.zeros((b, 32, 32), dtype=np.float32)
    pad[:, 2:30, 2:30] = img
    oy = rng.integers(0, 5, b)
    ox = rng.integers(0, 5, b)
    rows = oy[:, None, None] + np.arange(28)[None, :, None]
    cols = ox[:, None, None] + np.arange(28)[None, None, :]
    out = pad[np.arange(b)[:, None, None], rows, cols]
    return out.reshape(shape)


def _stage(split, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(images, labels int64) on ``dev``: numpy images as float32,
    tensors in their dtype."""
    x, y = split
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    if not isinstance(y, torch.Tensor):
        y = torch.from_numpy(np.asarray(y))
    return x.to(dev), y.to(dev).long()


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def evaluate(model: nn.Module, x, y, batch_size: int = 1024) -> tuple[float, float]:
    """(mean cross-entropy, accuracy) over the whole split, the ragged
    tail included, on the model's device; read once."""
    x, y = _stage((x, y), _model_device(model))
    sums = torch.zeros(2, dtype=torch.float64, device=x.device)
    n = x.shape[0]
    for i in range(0, n, batch_size):
        xb, yb = x[i : i + batch_size], y[i : i + batch_size]
        logits, _ = model(xb)
        ce = F.cross_entropy(logits, yb)
        acc = (logits.argmax(-1) == yb).float().mean()
        sums += torch.stack([ce, acc]).double() * xb.shape[0]
    loss, acc = (sums / max(n, 1)).tolist()
    return loss, acc


def load_model(model_type: str, params: dict[str, torch.Tensor], device="cuda") -> nn.Module:
    """A ``make_model(model_type)`` model holding ``params``, in their
    dtype, on ``device``."""
    model = make_model(model_type).to(next(iter(params.values())).dtype)
    model.load_state_dict(params)
    return model.to(_device(device))


def _snapshot(model: nn.Module) -> dict[str, torch.Tensor]:
    # the optimizer updates the parameters in place: keep a copy
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@dataclasses.dataclass
class TrainResult:
    params: dict  # the final state_dict
    best_params: dict  # the state_dict that scored best_val_acc
    best_val_acc: float
    history: dict  # train / val losses and accuracies per epoch


def train(
    data: dict,
    cfg: TrainConfig,
    init_params: dict | None = None,
    verbose: bool = True,
    device="cuda",
) -> TrainResult:
    """Train (or finetune) a model on ``device``; returns the final and
    the best-validation parameters.

    ``data`` = {"train": (x, y), "val": (x, y), ...} numpy arrays.
    ``init_params`` is a ``state_dict``; without it the model starts from
    :func:`~outerspace_tpu_torch.nn.models.init_lecun_normal_` at
    ``cfg.seed``. Each epoch evaluates on "val" first, keeping a snapshot
    of the parameters that scored best, then takes one step per full
    batch in the order of ``batch_index_sets(seed=cfg.seed + epoch)``.
    """
    dev = _device(device)
    model = make_model(cfg.model_type)
    if init_params is None:
        init_lecun_normal_(model, cfg.seed)
    else:
        model.load_state_dict(init_params)
    model.to(dev)
    x_host = data["train"][0]
    x_tr, y_tr = _stage(data["train"], dev)
    x_va, y_va = _stage(data["val"], dev)
    opt = make_optimizer(model, cfg)
    schedule = lr_schedule(cfg, x_tr.shape[0])
    masks = nonzero_masks(model.state_dict())
    aug_rng = np.random.default_rng(cfg.seed + 1)

    history = {"train_loss": [], "train_acc": [], "val_loss": [], "val_acc": []}
    best_val_acc, best_params = -1.0, None
    for epoch in range(cfg.num_epochs):
        # validate before the epoch's steps, so the snapshot holds the
        # weights that scored val_acc
        val_loss, val_acc = evaluate(model, x_va, y_va, cfg.batch_size)
        if val_acc > best_val_acc:
            best_val_acc, best_params = val_acc, _snapshot(model)
        sets = batch_index_sets(x_tr.shape[0], cfg.batch_size, seed=cfg.seed + epoch)
        sets_dev = torch.from_numpy(sets).to(dev)
        sums = torch.zeros(2, dtype=torch.float64, device=dev)
        for idx, idx_dev in zip(sets, sets_dev):
            if cfg.augment:
                xb = torch.from_numpy(shift_augment(x_host[idx], aug_rng)).to(dev)
            else:
                xb = x_tr[idx_dev]
            loss, acc = train_step(model, opt, xb, y_tr[idx_dev], cfg, masks, schedule)
            sums += torch.stack([loss, acc]).double()
        ep_loss, ep_acc = (sums / max(len(sets), 1)).tolist()
        history["train_loss"].append(ep_loss)
        history["train_acc"].append(ep_acc)
        history["val_loss"].append(val_loss)
        history["val_acc"].append(val_acc)
        if verbose:
            print(
                f"epoch {epoch}: train_loss={ep_loss:.4f} "
                f"train_acc={ep_acc:.4f} val_acc={val_acc:.4f}"
            )
    val_loss, val_acc = evaluate(model, x_va, y_va, cfg.batch_size)
    if val_acc > best_val_acc:
        best_val_acc, best_params = val_acc, _snapshot(model)
    return TrainResult(model.state_dict(), best_params, best_val_acc, history)


def finetune(
    data: dict, cfg: TrainConfig, pruned_params: dict, verbose: bool = True, device="cuda"
) -> TrainResult:
    """Masked-gradient finetune from ``pruned_params``: its zero weights
    stay zero."""
    cfg = dataclasses.replace(cfg, finetune=True)
    return train(data, cfg, init_params=pruned_params, verbose=verbose, device=device)


def save_params(path: str, params: dict[str, torch.Tensor]) -> None:
    """Pickle ``params`` (a ``state_dict``) as the flax parameter dict of
    numpy arrays, the JAX package's ``save_params`` format."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(params_from_state_dict(params), f)


def load_params(path: str) -> dict[str, torch.Tensor]:
    """A ``save_params`` pickle (or the JAX package's) as a ``state_dict``
    of CPU tensors."""
    return state_dict_from_params(_load_flax_params(path))


def save_checkpoint(path: str, model: nn.Module, opt: torch.optim.Optimizer) -> None:
    """``torch.save`` of the model's and the optimizer's ``state_dict``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": model.state_dict(), "optimizer": opt.state_dict()}, path)


def load_checkpoint(path: str, model: nn.Module, opt: torch.optim.Optimizer | None = None) -> None:
    """Restore a :func:`save_checkpoint` into ``model`` (and ``opt``), on
    the model's device; training then resumes at the next step."""
    ckpt = torch.load(path, map_location=_model_device(model))
    model.load_state_dict(ckpt["model"])
    if opt is not None:
        opt.load_state_dict(ckpt["optimizer"])


def save_training_stats(path: str, history: dict) -> None:
    """Pickle (train_losses, train_accs, val_losses, val_accs)."""
    with open(path, "wb") as f:
        pickle.dump(
            (
                history["train_loss"],
                history["train_acc"],
                history["val_loss"],
                history["val_acc"],
            ),
            f,
        )


def plot_training_stats(path_prefix: str, history: dict) -> list[str]:
    """Loss and accuracy curves, train against validation, as
    ``{path_prefix}_loss.png`` and ``{path_prefix}_acc.png``; returns the
    paths. Needs matplotlib, imported here."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = range(len(history["train_loss"]))
    paths = []
    for kind in ("loss", "acc"):
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(epochs, history[f"train_{kind}"], label=f"train {kind}")
        ax.plot(epochs, history[f"val_{kind}"], label=f"val {kind}")
        ax.set_xlabel("epoch")
        ax.set_ylabel(kind)
        ax.legend()
        ax.set_title(f"training {kind}")
        out = f"{path_prefix}_{kind}.png"
        fig.savefig(out, dpi=100, bbox_inches="tight")
        plt.close(fig)
        paths.append(out)
    return paths
