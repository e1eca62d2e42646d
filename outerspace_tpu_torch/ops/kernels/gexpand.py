"""K1, the windowed-gather expand: host staging, the CUDA kernel's
wrapper, and its plain PyTorch version.

Replaces the JAX package's Pallas kernel ``_expand_gather_kernel``
(``ops/pallas/gexpand.py:60``, wrapper ``expand_gather_packed``). Each
group of the plan (``sched.gplanner``) holds 8 subtiles × 1024 product
slots. For slot p = p0 + slot of a subtile, the owner is the largest
A-window element e with cum[e] ≤ p (a binary search of ``group_bits``
steps); the slot emits the biased key row·n + col − 2³¹ (int32 wrap) and
the value a_val·b_val, or INT32_MAX / 0 at slots ≥ plen. The kernel
source is ``csrc/gexpand.cu``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from outerspace_tpu_torch.runtime.build import CudaKernel, device_args, tensor_ptr
from outerspace_tpu_torch.sched.gplanner import (
    GROUP_SUBS,
    SUB_P,
    GatherPlan,
    group_slab_layout,
)

_BLK = 128
_I32_MAX = 2**31 - 1

KERNEL = CudaKernel(
    "gexpand",
    "gexpand_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)


def gather_plan_to_host(
    plan: GatherPlan,
    ngroups_pad: int | None = None,
    nab8_pad: int | None = None,
    nbb8_pad: int | None = None,
) -> dict[str, np.ndarray]:
    """A GatherPlan's kernel arrays as fresh host arrays (packs reshaped
    to 8-block refs). Explicit pad targets (≥ the natural sizes) let
    several plans share one shape: padding groups are all-zero table rows
    (plen = 0 ⇒ pure sentinel output), padding pack blocks are zeros
    (reads are clamped in-bounds)."""
    nab8 = plan.a_pack.shape[0] // 8
    nbb8 = plan.b_pack.shape[0] // 8
    g = plan.ngroups
    if ngroups_pad is None:
        ngroups_pad = g
    if nab8_pad is None:
        nab8_pad = nab8
    if nbb8_pad is None:
        nbb8_pad = nbb8
    if ngroups_pad < g or nab8_pad < nab8 or nbb8_pad < nbb8:
        raise ValueError("pad targets must cover the natural sizes")
    table = np.zeros((ngroups_pad, GROUP_SUBS, _BLK), np.int32)
    table[:g] = plan.table
    table[:, :, 5] = plan.n  # n_cols broadcast into the table
    bases = np.zeros((ngroups_pad, 2), np.int32)
    bases[:g] = plan.bases
    a_pack = np.zeros((nab8_pad, 8, 4, _BLK), np.int32)
    a_pack[:nab8] = plan.a_pack.reshape(nab8, 8, 4, _BLK)
    b_pack = np.zeros((nbb8_pad, 8, 2, _BLK), np.int32)
    b_pack[:nbb8] = plan.b_pack.reshape(nbb8, 8, 2, _BLK)
    return dict(
        bases=bases.reshape(-1),
        table=table,
        a_pack=a_pack,
        b_pack=b_pack,
    )


def group_search_bits(call_bits: tuple[int, ...], ngroups: int) -> np.ndarray:
    """Per-group owner-search depth: each slab call's depth
    (``gplanner.call_search_bits``) repeated over the call's groups."""
    sizes = [size for _, size in group_slab_layout(ngroups)]
    if len(sizes) != len(call_bits):
        raise ValueError(f"{len(call_bits)} call depths for {len(sizes)} calls")
    return np.repeat(np.asarray(call_bits, np.int32), sizes)


def _check(bases, table, a_pack, b_pack, group_bits, b_win):
    g = table.shape[0]
    want = {
        "bases": (bases, (2 * g,)),
        "table": (table, (g, GROUP_SUBS, _BLK)),
        "a_pack": (a_pack, (a_pack.shape[0], 8, 4, _BLK)),
        "b_pack": (b_pack, (b_pack.shape[0], 8, 2, _BLK)),
        "group_bits": (group_bits, (g,)),
    }
    for name, (t, shape) in want.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on {table.device}")
    if a_pack.shape[0] < 1 or b_pack.shape[0] < 1:
        raise ValueError("packs must hold at least one 8-block ref")
    if not 1 <= b_win <= 5 * 8:
        raise ValueError(f"b_win {b_win} outside the B super-window")


def _check_out(out, n: int, dev) -> None:
    """``out`` must be (int32, float32) contiguous 1-D views of ``n``
    slots on ``dev``, 16-byte aligned on CUDA (the kernel stores int4)."""
    if len(out) != 2:
        raise ValueError("out must be a (keys, vals) pair")
    for name, t, dtype in zip(("keys", "vals"), out, (torch.int32, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"out {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError(f"out {name} must be a contiguous view of {n} slots, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"out {name} is on {t.device}, table on {dev}")
        if dev.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"out {name} must start 16-byte aligned")


def expand_gather(
    bases: torch.Tensor,  # int32[2·G]: (a_base8, b_base8) per group
    table: torch.Tensor,  # int32[G, 8, 128] per-subtile table
    a_pack: torch.Tensor,  # int32[NAB/8, 8, 4, 128]: row, a_val bits, jb, cum
    b_pack: torch.Tensor,  # int32[NBB/8, 8, 2, 128]: col, b_val bits
    group_bits: torch.Tensor,  # int32[G] owner-search depth per group
    *,
    b_win: int,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat (keys int32, vals float32) of length G·8·1024, written into
    ``out`` (contiguous views of that length, e.g. slices of a merge
    stream) when it is given, else into new tensors.

    CUDA tensors launch ``csrc/gexpand.cu``; CPU tensors run
    :func:`expand_gather_plain`; any other device raises."""
    _check(bases, table, a_pack, b_pack, group_bits, b_win)
    dev = table.device
    n = table.shape[0] * GROUP_SUBS * SUB_P
    if out is not None:
        _check_out(out, n, dev)
    if dev.type == "cpu":
        got = expand_gather_plain(bases, table, a_pack, b_pack, group_bits, b_win=b_win)
        if out is None:
            return got
        for o, x in zip(out, got):
            o.copy_(x)
        return out
    if dev.type != "cuda":
        raise ValueError(f"expand_gather runs on cuda or cpu, not {dev}")
    g = table.shape[0]
    if out is None:
        out = (torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(n, dtype=torch.float32, device=dev))
    keys, vals = out
    KERNEL.launch(
        tensor_ptr(bases), tensor_ptr(table), tensor_ptr(a_pack),
        tensor_ptr(b_pack), tensor_ptr(group_bits), tensor_ptr(keys),
        tensor_ptr(vals), g, a_pack.shape[0], b_pack.shape[0], b_win,
        *device_args(dev),
    )
    return keys, vals


def expand_gather_plain(bases, table, a_pack, b_pack, group_bits, *, b_win: int):
    """The same function as the kernel, vectorised over all slots in
    plain PyTorch (int64 index arithmetic)."""
    from outerspace_tpu_torch.ops.spgemm import pack_key_biased

    g = table.shape[0]
    nab8, nbb8 = a_pack.shape[0], b_pack.shape[0]
    tab = table.long()

    def lane(i):  # (G, 8, 1): one table lane per subtile
        return tab[:, :, i].unsqueeze(-1)

    r_a, r_b, p0, plen, anchor = lane(0), lane(1), lane(2), lane(3), lane(6)
    n_cols = tab[:, 0, 5].view(g, 1, 1)
    base = bases.long().view(g, 2)
    a_base8 = base[:, 0].view(g, 1, 1)
    b_base8 = base[:, 1].view(g, 1, 1)
    bits = group_bits.long().view(g, 1, 1)
    slot = torch.arange(SUB_P, device=table.device)
    p = p0 + slot  # (G, 8, 1024)
    a_flat = a_pack.reshape(-1)
    b_flat = b_pack.reshape(-1)

    def a_field(e, f):
        la = r_a + (e >> 7)
        blk = torch.clamp(a_base8 + (la >> 3), max=nab8 - 1) * 8 + (la & 7)
        return a_flat[(blk * 4 + f) * _BLK + (e & (_BLK - 1))]

    ow = torch.where(bits >= 8, torch.zeros_like(anchor), anchor).expand_as(p)
    for bit in range(7, -1, -1):
        probe = ow + (1 << bit)
        take = (bit < bits) & (a_field(probe, 3) <= p)
        ow = torch.where(take, probe, ow)
    row = a_field(ow, 0)
    a_val = a_field(ow, 1).view(torch.float32)
    jloc = a_field(ow, 2) + (p - a_field(ow, 3)) - (b_base8 * 8 + r_b) * _BLK
    jloc = jloc.clamp(0, b_win * _BLK - 1)
    lb = r_b + (jloc >> 7)
    blk = torch.clamp(b_base8 + (lb >> 3), max=nbb8 - 1) * 8 + (lb & 7)
    bi = blk * 2 * _BLK + (jloc & (_BLK - 1))
    b_col = b_flat[bi]
    b_val = b_flat[bi + _BLK].view(torch.float32)
    live = slot < plen
    key = torch.where(live, pack_key_biased(row, b_col, n_cols), _I32_MAX)
    val = torch.where(live, a_val * b_val, 0.0)
    return key.reshape(-1), val.reshape(-1)
