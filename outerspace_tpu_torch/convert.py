"""State carried across from the JAX package.

SpGEMM has no weights: its state is the operands and the plan. These
take an operand's compressed arrays as numpy arrays (for example the
``indptr``/``indices``/``data`` of one of the JAX package's
containers), or a tiled plan's host and staged arrays, and return the
port's objects, so both packages can be fed the same operand or plan.
The sparse-NN path's state is the trained weights: the flax parameter
dicts of numpy arrays that the JAX package pickles
(``data/saved_weights/``), loaded here without JAX and turned into the
torch models' ``state_dict``, and a trained ``state_dict`` turned back
into that dict. Nothing here imports the other package:
arrays are read through numpy.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from outerspace_tpu_torch.formats.csr import CSC, CSR


def csr_from_arrays(shape, indptr, indices, data) -> CSR:
    """The port's CSR from compressed-row arrays (copied)."""
    return CSR(tuple(shape), np.array(indptr), np.array(indices), np.array(data))


def csc_from_arrays(shape, indptr, indices, data) -> CSC:
    """The port's CSC from compressed-column arrays (copied)."""
    return CSC(tuple(shape), np.array(indptr), np.array(indices), np.array(data))


def _tensors(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in arrays.items()}


def _copy(x):
    return np.array(x) if isinstance(x, np.ndarray) else x


def tiled_plan_from_arrays(plan, device="cuda"):
    """The port's ``TiledPlan`` or ``TiledPartsPlan`` from another
    package's tiled plan of the same layout (for example the JAX
    package's), staged on ``device``: the host schedules and the staged
    arrays are copied field by field, array by array, so both packages
    can run one plan and their streams can be compared. The class
    tables are joined into the group that K3 / K4 launch once per part,
    as ``plan_tiled`` joins its own."""
    from outerspace_tpu_torch.ops.kernels.gexpand import group_search_bits
    from outerspace_tpu_torch.ops.spgemm import TiledPartsPlan, TiledPlan, group_classes
    from outerspace_tpu_torch.ops.symbolic import ExpansionPlan
    from outerspace_tpu_torch.sched.planner import ClassPlan, OuterProductSchedule

    if hasattr(plan, "parts"):
        return TiledPartsPlan(
            plan.m, plan.n,
            [(lo, hi, tiled_plan_from_arrays(tp, device)) for lo, hi, tp in plan.parts],
            merge_pad=plan.merge_pad, rebased=plan.rebased,
        )
    cp = plan.class_plan
    sched_fields = [f.name for f in dataclasses.fields(OuterProductSchedule)]
    classes = [
        OuterProductSchedule(**{f: _copy(getattr(c, f)) for f in sched_fields})
        for c in cp.classes
    ]
    class_plan = ClassPlan(
        classes, np.array(cp.light_k), int(cp.light_p),
        np.array(cp.edge_k), np.array(cp.edge_jb), np.array(cp.edge_len),
    )
    src = plan.device_args
    tables = [None if d is None else {k: np.array(v) for k, v in d.items()}
              for d in src["classes"]]
    b = next((t for t in tables if t is not None), {"b_cols_blk": None, "b_vals_blk": None})
    group, staged = group_classes(classes, tables, b["b_cols_blk"], b["b_vals_blk"], device)
    dev = {"classes": staged}
    if "gather" in src:
        dev["gather"] = _tensors(src["gather"], device)
        dev["gather"]["group_bits"] = torch.from_numpy(
            group_search_bits(plan.gather_call_bits, plan.gather_ngroups)
        ).to(device)
    light_plan = None
    if plan.light_plan is not None:
        lp = plan.light_plan
        light_plan = ExpansionPlan(
            **{f.name: _copy(getattr(lp, f.name)) for f in dataclasses.fields(ExpansionPlan)}
        )
        dev["light"] = _tensors(
            {k: v for k, v in src["light"].items() if k != "p_total"}, device
        )
        dev["light"]["p_total"] = int(np.array(src["light"]["p_total"]))
    return TiledPlan(
        plan.m, plan.n, class_plan, light_plan, int(plan.light_pad), dev,
        torch.device(device),
        gather_ngroups=plan.gather_ngroups,
        gather_p_out=plan.gather_p_out,
        gather_p_real=plan.gather_p_real,
        gather_b_win=plan.gather_b_win,
        gather_call_bits=plan.gather_call_bits,
        group=group,
    )


def load_params(path: str):
    """A pickled flax parameter dict: ``{"Dense_i" | "Conv_i": {"kernel",
    "bias"}}`` of numpy float32 arrays (the JAX package's
    ``nn/train.py:save_params`` format; the pickles name ``numpy._core``,
    so they need numpy ≥ 2)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def state_dict_from_params(params) -> dict[str, torch.Tensor]:
    """The flax parameter dict as the ``state_dict`` of the matching
    ``nn.models.make_model`` model: ``Conv_i`` → ``conv.i``,
    ``Dense_i`` → ``dense.i`` (in sorted order), Dense kernels (in, out)
    → Linear weights (out, in), Conv kernels (kh, kw, in, out) → Conv2d
    weights (out, in, kh, kw). ``load_state_dict`` (strict by default)
    raises on a missing layer or a wrong shape."""
    sd = {}
    for prefix, perm in (("Conv", (3, 2, 0, 1)), ("Dense", (1, 0))):
        names = sorted(k for k in params if k.startswith(prefix))
        for i, name in enumerate(names):
            kernel = np.transpose(np.asarray(params[name]["kernel"], np.float32), perm)
            sd[f"{prefix.lower()}.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel))
            sd[f"{prefix.lower()}.{i}.bias"] = torch.from_numpy(
                np.array(params[name]["bias"], np.float32)
            )
    return sd


def params_from_state_dict(sd) -> dict:
    """The inverse of :func:`state_dict_from_params`: a ``state_dict`` of
    a ``nn.models`` model (tensors on any device) as the flax parameter
    dict of numpy float32 arrays, ``conv.i`` → ``Conv_i``, ``dense.i`` →
    ``Dense_i``, Linear weights (out, in) → kernels (in, out), Conv2d
    weights (out, in, kh, kw) → kernels (kh, kw, in, out). What
    :func:`load_params` reads, the JAX package's ``load_params`` too, and
    what ``SparseMLP`` / ``SparseLeNet`` serve."""
    params = {}
    for key, t in sd.items():
        prefix, i, kind = key.split(".")
        arr = t.detach().cpu().numpy().astype(np.float32)
        if kind == "weight":
            arr = np.transpose(arr, (2, 3, 1, 0) if arr.ndim == 4 else (1, 0))
        layer = params.setdefault(f"{prefix.capitalize()}_{i}", {})
        layer["kernel" if kind == "weight" else "bias"] = np.ascontiguousarray(arr)
    return params
