"""K3 and K4, the dense-tile expand: host staging, the CUDA kernels'
wrappers, and their plain PyTorch versions.

Replaces the JAX package's Pallas kernels ``_expand_kernel_packed``
(K3, ``ops/pallas/expand.py:45``, wrapper ``expand_tiles_packed``) and
``_expand_kernel_coords`` (K4, ``:87``, wrapper ``expand_tiles_coords``).
Task t of a class table (``sched.planner``) holds (a_len, b_block, b_lo,
b_hi); it forms the tile_a × 128 outer product of its A slice
(``a_rows_t[t]``, ``a_vals_t[t]``) with B block ``b_block``, masked to
``sub < a_len`` and ``b_lo ≤ lane < b_hi``. K3 writes the biased key
row·n + col − 2³¹ (int32 wrap) and a·b, or INT32_MAX / 0 where masked;
K4 writes (row, col, a·b), or (sentinel_row, 0, 0). Streams are
task-major, then sub, then lane. The kernel source is ``csrc/expand.cu``.

The kernel takes a :class:`TileGroup`: the class tables of one row part
joined (at most three, one per tile class), expanded by one launch into
one output buffer, each class at its first slot. The pipeline passes
each part's merge stream, so the classes land where the stream needs
them (``expand_part_packed`` / ``expand_part_coords``). The single-table
wrappers ``expand_tiles_packed`` / ``expand_tiles_coords``, the
counterparts of the JAX functions of the same names, launch the same
kernel on a group of one class. The JAX package launches a class in
fixed-size slab calls only to reuse compiled executables; a class's
padded table (``OuterProductSchedule.ntasks_padded``) expanded at once
gives the same stream in the same order.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from outerspace_tpu_torch.perf.timer import span
from outerspace_tpu_torch.runtime.build import CudaKernel, device_args, tensor_ptr
from outerspace_tpu_torch.sched.planner import TILE_B, OuterProductSchedule

_A_GROUP = 8  # table rows pad to multiples of 8, as the JAX package's do
_I32_MAX = 2**31 - 1
UNIT_ROWS = 8  # the kernel's work unit: 8 rows × 128 lanes
TILE_AS = (8, 16, 32, 64, 128)  # tile heights the kernel takes: 8·2^k
MAX_CLASSES = 3  # tables per group (one per tile class)
# a descriptor row: tile_a, tasks, first task, first A element, first
# output slot, first unit
DESC_FIELDS = 6

KERNEL_PACKED = CudaKernel(
    "expand",
    "expand_packed_launch",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
)
KERNEL_COORDS = CudaKernel(
    "expand",
    "expand_coords_launch",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
)


def b_blocks_host(
    b_csr_cols: np.ndarray,
    b_csr_vals: np.ndarray,
    nblocks_pad: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Flat B arrays zero-padded into (nblocks_pad, 128) block form.

    ``nblocks_pad=None`` buckets the block count (``round_up_bucket``) as
    the JAX package does; an explicit value (a multiple of 8 ≥ the
    natural count) pins it."""
    from outerspace_tpu_torch.ops.symbolic import round_up_bucket

    nnz_b = b_csr_cols.shape[0]
    nblocks = -(-max(nnz_b, 1) // TILE_B)
    if nblocks_pad is None:
        nblocks_pad = round_up_bucket(
            -(-nblocks // _A_GROUP) * _A_GROUP, min_size=_A_GROUP
        )
        nblocks_pad = -(-nblocks_pad // _A_GROUP) * _A_GROUP
    elif nblocks_pad < nblocks or nblocks_pad % _A_GROUP:
        raise ValueError(
            f"nblocks_pad={nblocks_pad} must be a multiple of {_A_GROUP} "
            f">= the natural block count {nblocks}"
        )
    pad_b = nblocks_pad * TILE_B - nnz_b
    cols_p = np.pad(b_csr_cols, (0, pad_b)).reshape(nblocks_pad, TILE_B)
    vals_p = np.pad(b_csr_vals, (0, pad_b)).reshape(nblocks_pad, TILE_B)
    return cols_p.astype(np.int32), vals_p.astype(np.float32)


def schedule_to_host(
    sched: OuterProductSchedule,
    ntasks_pad: int | None = None,
) -> dict[str, np.ndarray]:
    """One class's padded task table as host arrays (no B staging).

    ``ntasks_pad=None`` pads to the schedule's ``ntasks_padded``; an
    explicit value (a multiple of 8 ≥ ntasks) pins it. Padding tasks
    (a_len = 0) emit pure sentinel output."""
    ntasks = sched.ntasks
    if ntasks_pad is None:
        ntasks_pad = sched.ntasks_padded
    elif ntasks_pad < ntasks or ntasks_pad % _A_GROUP:
        raise ValueError(
            f"ntasks_pad={ntasks_pad} must be a multiple of {_A_GROUP} "
            f">= ntasks {ntasks}"
        )
    tile_a = sched.tile_a
    pad_t = ntasks_pad - ntasks
    tasks = np.zeros((ntasks_pad, 4), np.int32)
    if ntasks:
        tasks[:ntasks] = np.stack(
            [sched.a_len, sched.b_block, sched.b_lo, sched.b_hi], axis=1
        ).astype(np.int32)
    a_rows_t = np.pad(sched.a_rows_t, ((0, pad_t), (0, 0)))
    a_vals_t = np.pad(sched.a_vals_t, ((0, pad_t), (0, 0)))
    if a_rows_t.shape[0] == 0:
        a_rows_t = np.zeros((max(ntasks_pad, _A_GROUP), tile_a), np.int32)
        a_vals_t = np.zeros((max(ntasks_pad, _A_GROUP), tile_a), np.float32)
    return dict(
        tasks=tasks.reshape(-1),
        a_rows_t=a_rows_t.astype(np.int32),
        a_vals_t=a_vals_t.astype(np.float32),
    )


def group_descriptor(layout) -> np.ndarray:
    """The descriptor of a group whose classes have ``layout`` = [(tile_a,
    tasks), ...] in stream order: int32[C, 6], one row (tile_a, tasks,
    first task, first A element, first output slot, first unit) per
    class. Raises on a tile height the kernel does not take, on more
    than ``MAX_CLASSES`` classes, or past the int32 index space."""
    if not 1 <= len(layout) <= MAX_CLASSES:
        raise ValueError(f"a group holds 1 to {MAX_CLASSES} classes, got {len(layout)}")
    rows, task, a, out, unit = [], 0, 0, 0, 0
    for tile_a, ntasks in layout:
        if tile_a not in TILE_AS:
            raise ValueError(f"tile_a {tile_a} not one of {TILE_AS}")
        rows.append((tile_a, ntasks, task, a, out, unit))
        task += ntasks
        a += ntasks * tile_a
        out += ntasks * tile_a * TILE_B
        unit += ntasks * tile_a // UNIT_ROWS
    if out >= 2**31:
        raise ValueError(f"a group of {out} slots exceeds the int32 index space")
    return np.asarray(rows, np.int32).reshape(-1, DESC_FIELDS)


@dataclasses.dataclass(frozen=True)
class TileGroup:
    """The class tables of one row part, staged for one launch: the task
    tables and the A slices joined in class order, the B blocks they
    share, and the descriptor (``group_descriptor``). The descriptor
    stays on the host: a launch passes it to the kernel by value.

    Checked once, when it is made (types, shapes, contiguity, one device,
    the descriptor rebuilt from its layout): a launch then checks only
    its output views."""

    desc: np.ndarray  # int32[C, 6]
    tasks: torch.Tensor  # int32[4·ΣT]: (a_len, b_block, b_lo, b_hi) per task
    a_rows: torch.Tensor  # int32[Σ T·tile_a]
    a_vals: torch.Tensor  # float32[Σ T·tile_a]
    b_cols_blk: torch.Tensor  # int32[NB, 128]
    b_vals_blk: torch.Tensor  # float32[NB, 128]
    layout: list = dataclasses.field(init=False, repr=False)  # [(tile_a, tasks), ...]
    slots: int = dataclasses.field(init=False, repr=False)  # output slots of the group
    _args: tuple = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        desc = self.desc
        if not isinstance(desc, np.ndarray) or desc.dtype != np.int32 or desc.ndim != 2:
            raise TypeError("desc must be a host int32[C, 6] array")
        layout = [(int(r[0]), int(r[1])) for r in desc]
        if desc.shape[1] != DESC_FIELDS or not np.array_equal(desc, group_descriptor(layout)):
            raise ValueError("desc does not describe its classes' layout")
        ntasks = sum(t for _, t in layout)
        na = sum(ta * t for ta, t in layout)
        nb = self.b_cols_blk.shape[0] if self.b_cols_blk.dim() == 2 else -1
        dev = self.tasks.device
        for name, dtype, shape in (
            ("tasks", torch.int32, (4 * ntasks,)),
            ("a_rows", torch.int32, (na,)),
            ("a_vals", torch.float32, (na,)),
            ("b_cols_blk", torch.int32, (nb, TILE_B)),
            ("b_vals_blk", torch.float32, (nb, TILE_B)),
        ):
            _check_tensor(name, getattr(self, name), dtype, shape, dev)
        if nb < 1:
            raise ValueError("B must hold at least one block")
        desc = desc.copy()
        desc.setflags(write=False)
        ptrs = ()
        if dev.type == "cuda":
            ptrs = tuple(tensor_ptr(t) for t in (
                self.tasks, self.a_rows, self.a_vals, self.b_cols_blk, self.b_vals_blk))
        for name, value in (("desc", desc), ("layout", layout),
                            ("slots", sum(ta * t * TILE_B for ta, t in layout)),
                            ("_args", (ctypes.c_void_p(desc.ctypes.data), len(layout), *ptrs))):
            object.__setattr__(self, name, value)

    def table(self, c: int) -> dict[str, torch.Tensor]:
        """Class ``c``'s table as views: the single-table wrappers'
        arguments."""
        tile_a, ntasks, task, a = (int(x) for x in self.desc[c, :4])
        return dict(
            tasks=self.tasks[4 * task:4 * (task + ntasks)],
            a_rows_t=self.a_rows[a:a + ntasks * tile_a].view(ntasks, tile_a),
            a_vals_t=self.a_vals[a:a + ntasks * tile_a].view(ntasks, tile_a),
            b_cols_blk=self.b_cols_blk,
            b_vals_blk=self.b_vals_blk,
        )


def stage_group(tables, b_cols_blk: np.ndarray, b_vals_blk: np.ndarray, device) -> TileGroup:
    """Join host class tables (``[(tile_a, {"tasks", "a_rows_t",
    "a_vals_t"})]``, as :func:`schedule_to_host` gives them, in stream
    order) and their B blocks into one :class:`TileGroup` on ``device``:
    four host-to-device copies for the whole part (a ``spgemm.stage``
    span)."""
    desc = group_descriptor([(ta, h["tasks"].shape[0] // 4) for ta, h in tables])

    def join(key, dtype):
        x = np.concatenate([np.asarray(h[key], dtype).reshape(-1) for _, h in tables])
        return torch.from_numpy(x).to(device)

    with span("spgemm.stage"):
        return TileGroup(
            desc, join("tasks", np.int32), join("a_rows_t", np.int32),
            join("a_vals_t", np.float32),
            torch.from_numpy(np.asarray(b_cols_blk, np.int32)).to(device),
            torch.from_numpy(np.asarray(b_vals_blk, np.float32)).to(device),
        )


def _check_outs(g: TileGroup, outs, dtypes) -> None:
    """Raises unless the output views ``outs`` have the types
    ``dtypes``, are contiguous, 1-D, on the group's device, at least
    ``g.slots`` long and (on CUDA) 16-byte aligned."""
    dev = g.tasks.device
    for name, t, dtype in zip(("out 0", "out 1", "out 2"), outs, dtypes):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D view")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the tables on {dev}")
        if t.shape[0] < g.slots:
            raise ValueError(f"{name} holds {t.shape[0]} slots, the group writes {g.slots}")
        if dev.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the kernel stores int4)")


def _check_tensor(name, t, dtype, shape, dev) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, tasks on {dev}")


def _launch_group(kernel, g: TileGroup, outs, last: int) -> None:
    kernel.launch(*g._args, *(tensor_ptr(t) for t in outs), last, *device_args(g.tasks.device))


def expand_part_packed(
    group: TileGroup, *, n_cols: int, out_keys: torch.Tensor, out_vals: torch.Tensor
) -> None:
    """K3 over every class of ``group`` in one launch: the classes'
    (keys, vals) streams written one after another into the first
    ``group.slots`` slots of ``out_keys`` (int32) / ``out_vals``
    (float32), views of the caller's stream.

    CUDA tensors launch ``csrc/expand.cu``; CPU tensors run
    :func:`expand_part_packed_plain`; any other device raises."""
    _check_outs(group, (out_keys, out_vals), (torch.int32, torch.float32))
    if not 0 < n_cols < 2**31:
        raise ValueError(f"n_cols {n_cols} out of int32 range")
    dev = group.tasks.device
    if dev.type == "cpu":
        return expand_part_packed_plain(group, n_cols=n_cols, out_keys=out_keys, out_vals=out_vals)
    if dev.type != "cuda":
        raise ValueError(f"expand_part_packed runs on cuda or cpu, not {dev}")
    _launch_group(KERNEL_PACKED, group, (out_keys, out_vals), n_cols)


def expand_part_coords(
    group: TileGroup,
    *,
    sentinel_row: int,
    out_rows: torch.Tensor,
    out_cols: torch.Tensor,
    out_vals: torch.Tensor,
) -> None:
    """K4 over every class of ``group`` in one launch, into the first
    ``group.slots`` slots of ``out_rows`` / ``out_cols`` (int32) and
    ``out_vals`` (float32).

    CUDA tensors launch ``csrc/expand.cu``; CPU tensors run
    :func:`expand_part_coords_plain`; any other device raises."""
    outs = (out_rows, out_cols, out_vals)
    _check_outs(group, outs, (torch.int32, torch.int32, torch.float32))
    if not 0 <= sentinel_row < 2**31:
        raise ValueError(f"sentinel_row {sentinel_row} out of int32 range")
    dev = group.tasks.device
    if dev.type == "cpu":
        return expand_part_coords_plain(
            group, sentinel_row=sentinel_row,
            out_rows=out_rows, out_cols=out_cols, out_vals=out_vals,
        )
    if dev.type != "cuda":
        raise ValueError(f"expand_part_coords runs on cuda or cpu, not {dev}")
    _launch_group(KERNEL_COORDS, group, outs, sentinel_row)


def _one_class(tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, tile_a) -> TileGroup:
    """One class table as a group (the single-table wrappers), checked."""
    if tile_a not in TILE_AS:
        raise ValueError(f"tile_a {tile_a} not one of {TILE_AS}")
    if tasks.dim() != 1 or tasks.shape[0] % 4:
        raise ValueError(f"tasks must be flat (a_len, b_block, b_lo, b_hi) rows, got {tuple(tasks.shape)}")
    ntasks = tasks.shape[0] // 4
    dev = tasks.device
    _check_tensor("a_rows_t", a_rows_t, torch.int32, (ntasks, tile_a), dev)
    _check_tensor("a_vals_t", a_vals_t, torch.float32, (ntasks, tile_a), dev)
    return TileGroup(
        group_descriptor([(tile_a, ntasks)]), tasks, a_rows_t.view(-1), a_vals_t.view(-1),
        b_cols_blk, b_vals_blk,
    )


def expand_tiles_packed(
    tasks: torch.Tensor,  # int32[4·T]: (a_len, b_block, b_lo, b_hi) per task
    a_rows_t: torch.Tensor,  # int32[T, tile_a]
    a_vals_t: torch.Tensor,  # float32[T, tile_a]
    b_cols_blk: torch.Tensor,  # int32[NB, 128]
    b_vals_blk: torch.Tensor,  # float32[NB, 128]
    *,
    tile_a: int,
    n_cols: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 on one class table: flat (keys int32, vals float32) of length
    T·tile_a·128.

    CUDA tensors launch ``csrc/expand.cu`` (a group of one class); CPU
    tensors run :func:`expand_tiles_packed_plain`; any other device
    raises."""
    g = _one_class(tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, tile_a)
    keys = torch.empty(g.slots, dtype=torch.int32, device=tasks.device)
    vals = torch.empty(g.slots, dtype=torch.float32, device=tasks.device)
    expand_part_packed(g, n_cols=n_cols, out_keys=keys, out_vals=vals)
    return keys, vals


def expand_tiles_coords(
    tasks: torch.Tensor,
    a_rows_t: torch.Tensor,
    a_vals_t: torch.Tensor,
    b_cols_blk: torch.Tensor,
    b_vals_blk: torch.Tensor,
    *,
    tile_a: int,
    sentinel_row: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 on one class table: flat (rows int32, cols int32, vals
    float32) of length T·tile_a·128, the general form when m·n does not
    fit one key.

    CUDA tensors launch ``csrc/expand.cu`` (a group of one class); CPU
    tensors run :func:`expand_tiles_coords_plain`; any other device
    raises."""
    g = _one_class(tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, tile_a)
    outs = [torch.empty(g.slots, dtype=dt, device=tasks.device)
            for dt in (torch.int32, torch.int32, torch.float32)]
    expand_part_coords(g, sentinel_row=sentinel_row, out_rows=outs[0], out_cols=outs[1],
                       out_vals=outs[2])
    return tuple(outs)


def _outer(tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, tile_a):
    """Mask, rows, cols and products over [T, tile_a, 128] (broadcast)."""
    task = tasks.view(-1, 4).long()
    a_len, b_block = task[:, 0, None, None], task[:, 1]
    b_lo, b_hi = task[:, 2, None, None], task[:, 3, None, None]
    sub = torch.arange(tile_a, device=tasks.device).view(1, -1, 1)
    lane = torch.arange(TILE_B, device=tasks.device).view(1, 1, -1)
    mask = (sub < a_len) & (lane >= b_lo) & (lane < b_hi)
    rows = a_rows_t.unsqueeze(2)
    cols = b_cols_blk[b_block].unsqueeze(1)
    vals = a_vals_t.unsqueeze(2) * b_vals_blk[b_block].unsqueeze(1)
    return mask, rows, cols, vals


def expand_tiles_packed_plain(
    tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, *, tile_a: int, n_cols: int
):
    """K3's function in plain PyTorch (int64 key arithmetic)."""
    from outerspace_tpu_torch.ops.spgemm import pack_key_biased

    mask, rows, cols, vals = _outer(tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, tile_a)
    keys = torch.where(mask, pack_key_biased(rows, cols, n_cols), _I32_MAX)
    return keys.reshape(-1), torch.where(mask, vals, 0.0).reshape(-1)


def expand_tiles_coords_plain(
    tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, *, tile_a: int, sentinel_row: int
):
    """K4's function in plain PyTorch."""
    mask, rows, cols, vals = _outer(tasks, a_rows_t, a_vals_t, b_cols_blk, b_vals_blk, tile_a)
    return (
        torch.where(mask, rows, sentinel_row).reshape(-1),
        torch.where(mask, cols, 0).reshape(-1),
        torch.where(mask, vals, 0.0).reshape(-1),
    )


def _class_slices(group: TileGroup):
    """(table views, tile_a, output slice) of each class of ``group``."""
    for c, (tile_a, ntasks) in enumerate(group.layout):
        out = int(group.desc[c, 4])
        yield group.table(c), tile_a, slice(out, out + ntasks * tile_a * TILE_B)


def expand_part_packed_plain(group: TileGroup, *, n_cols: int, out_keys, out_vals) -> None:
    """:func:`expand_part_packed`'s function in plain PyTorch: each
    class's :func:`expand_tiles_packed_plain` written into its slice."""
    for t, tile_a, sl in _class_slices(group):
        keys, vals = expand_tiles_packed_plain(*t.values(), tile_a=tile_a, n_cols=n_cols)
        out_keys[sl].copy_(keys)
        out_vals[sl].copy_(vals)


def expand_part_coords_plain(
    group: TileGroup, *, sentinel_row: int, out_rows, out_cols, out_vals
) -> None:
    """:func:`expand_part_coords`'s function in plain PyTorch: each
    class's :func:`expand_tiles_coords_plain` written into its slice."""
    for t, tile_a, sl in _class_slices(group):
        rows, cols, vals = expand_tiles_coords_plain(*t.values(), tile_a=tile_a,
                                                     sentinel_row=sentinel_row)
        out_rows[sl].copy_(rows)
        out_cols[sl].copy_(cols)
        out_vals[sl].copy_(vals)
