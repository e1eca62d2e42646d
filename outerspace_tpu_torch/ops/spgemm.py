"""SpGEMM entry point, the merge stage and the tiled strategy.

The port of the pieces of the JAX package's ``ops/spgemm.py`` that the
single-device paths run:

- the merge stage: biased-key packing, sort, merge epilogue (K2), the
  two-key merge, and the merged result (``MergedCOO``);
- the flat strategy: the expand (``expand_partial_products``) over a
  symbolic plan, then the packed merge (sort + K2) or the two-key merge
  (``spgemm_padded``); the tiled strategy's light residue runs the same
  expand when m·n > 2³²;
- the tiled strategy: dense-tile classes expanded by K3 (packed keys)
  or K4 (coordinates), one launch per row part over all its classes,
  the residue by K1, each written in place into the part's merge
  stream, then one merge; with row parts (``plan_tiled_parts``),
  rebased to part-local keys past 2³².

Keys pack (row, col) into one int32 ``row·n + col − 2³¹`` with int32
wraparound, so signed int32 order equals the unsigned order of
``row·n + col`` and one int32 sort covers every m·n ≤ 2³². PyTorch has no
wrapping int32 multiply-add that is safe to rely on, so the arithmetic
runs in int64 and narrows at the end.

A merged result goes to the host compacted on the device
(``MergedCOO.to_csr``): only its nnz entries and ``indptr`` are copied.

Spans (``perf.timer.span``, recorded only under the profiler): a call
of :func:`spgemm` is a ``spgemm`` root with ``spgemm.pick``,
``spgemm.plan`` (``spgemm.stage`` inside, the plan's copies to the
card) and ``fetch``; the phases ``expand``, ``sort`` and ``merge`` sit
in the helpers here, which the MCL chain shares.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from outerspace_tpu_torch.formats.coo import COO, INDEX_DTYPE, VALUE_DTYPE
from outerspace_tpu_torch.formats.csr import CSC, CSR
from outerspace_tpu_torch.ops.kernels.expand import (
    TileGroup,
    b_blocks_host,
    expand_part_coords,
    expand_part_packed,
    schedule_to_host,
    stage_group,
)
from outerspace_tpu_torch.ops.kernels.gexpand import expand_gather, gather_plan_to_host
from outerspace_tpu_torch.ops.kernels.scan import merge_epilogue_scan
from outerspace_tpu_torch.ops.symbolic import (
    ExpansionPlan,
    expansion_plan,
    expansion_plan_subset,
)
from outerspace_tpu_torch.perf.timer import span
from outerspace_tpu_torch.sched.planner import ClassPlan, plan_outer_classes

I32_MAX = 2**31 - 1
KEY_BIAS = -(2**31)


def pack_key_biased(rows: torch.Tensor, cols: torch.Tensor, n_cols) -> torch.Tensor:
    """Pack (row, col) into one biased-uint32 int32 sort key (m·n ≤ 2³²)."""
    u = torch.remainder(rows.long() * n_cols + cols.long(), 2**32)
    return (u + KEY_BIAS).to(torch.int32)


def unpack_key_biased(key: torch.Tensor, n_cols: int):
    """Inverse of :func:`pack_key_biased`: (row, col) as int32."""
    ku = key.long() - KEY_BIAS  # the unsigned value row·n + col
    return (ku // n_cols).to(torch.int32), (ku % n_cols).to(torch.int32)


# --------------------------------------------------------------------------
# Flat expand (the flat strategy, and the tiled residue past 2³²)
# --------------------------------------------------------------------------


def _segment_broadcast_bits(per_segment: torch.Tensor, starts: torch.Tensor, p_pad: int):
    """Broadcast ``per_segment[e]`` (32-bit payloads as int32 bit
    patterns) to every position of segment e, which spans
    ``[starts[e], starts[e+1])`` of a length-``p_pad`` stream.

    Differences are scattered at segment starts and summed, so each
    position telescopes to its segment's pattern (empty segments
    cancel). The JAX package relies on int32 wraparound for this; here
    the sums run in int64 and the low 32 bits are kept, reinterpreted."""
    per = per_segment.long()
    diffs = torch.cat([per[:1], per[1:] - per[:-1]])
    d = torch.zeros(p_pad + 1, dtype=torch.int64, device=per.device)
    # a start at p_pad (empty trailing segments) lands in the extra slot
    d.index_add_(0, starts.long().clamp(max=p_pad), diffs)
    low = torch.remainder(torch.cumsum(d[:p_pad], 0) - KEY_BIAS, 2**32) + KEY_BIAS
    return low.to(torch.int32)


def expand_partial_products(
    a_rows: torch.Tensor,  # int32[nnz_a] output row of each A nonzero (CSC order)
    a_vals: torch.Tensor,  # f32[nnz_a]
    a_k: torch.Tensor,  # int32[nnz_a] outer index of each nonzero
    b_indptr: torch.Tensor,  # int32[k+1]
    b_cols: torch.Tensor,  # int32[nnz_b]
    b_vals: torch.Tensor,  # f32[nnz_b]
    offsets: torch.Tensor,  # int32[nnz_a+1] expansion offsets
    p_total: int,  # true P (≤ p_pad)
    p_pad: int,
    sentinel_row: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The multiply phase over [0, p_pad): (rows, cols, vals). Slots at
    or past ``p_total`` hold (sentinel_row, the column of B's first
    element, 0)."""
    p = torch.arange(p_pad, device=a_rows.device)
    starts = offsets[:-1]
    row = _segment_broadcast_bits(a_rows, starts, p_pad)
    a_val = _segment_broadcast_bits(a_vals.view(torch.int32), starts, p_pad).view(torch.float32)
    # j = position in B's flat arrays: affine in p within each segment
    jb = b_indptr[a_k.long()] - starts
    j = _segment_broadcast_bits(jb, starts, p_pad).long() + p
    valid = p < p_total
    j_safe = torch.where(valid, j, 0)
    out_row = torch.where(valid, row, sentinel_row)
    val = torch.where(valid, a_val * b_vals[j_safe], 0.0)
    return out_row, b_cols[j_safe], val


def plan_to_device(plan: ExpansionPlan, device) -> dict:
    """A symbolic plan's arrays on ``device`` (int32-narrowed), as the
    keyword arguments of :func:`expand_partial_products` minus the pad
    and sentinel. Raises past the int32 index space."""
    if plan.expansion_size >= 2**31:
        raise ValueError(
            f"expansion size {plan.expansion_size} exceeds the int32 index space"
        )

    def put(x, dtype):
        return torch.from_numpy(np.asarray(x, dtype=dtype)).to(device)

    with span("spgemm.stage"):
        return dict(
            a_rows=put(plan.a_rows, np.int32),
            a_vals=put(plan.a_vals, np.float32),
            a_k=put(plan.a_k, np.int32),
            b_indptr=put(plan.b_indptr, np.int32),
            b_cols=put(plan.b_cols, np.int32),
            b_vals=put(plan.b_vals, np.float32),
            offsets=put(plan.offsets, np.int32),
            p_total=plan.expansion_size,
        )


# --------------------------------------------------------------------------
# Merge
# --------------------------------------------------------------------------


def merge_epilogue(key, vals, n_cols: int, sentinel_row: int, pad_count: int = 0):
    """Everything after the sort (K2): segmented sums, unpack, validity
    and nnz over an ALREADY-SORTED biased-key stream."""
    with span("merge"):
        return merge_epilogue_scan(
            key, vals, pad_count, n_cols=n_cols, sentinel_row=sentinel_row
        )


def merge_biased_keys(key, vals, n_cols: int, sentinel_row: int, pad_count: int = 0):
    """Merge a biased-key stream: ``torch.sort`` by key, the values
    gathered by the returned order, then :func:`merge_epilogue`.

    Padding slots carry the sentinel INT32_MAX with value 0; at
    m·n = 2³² the real corner shares that bit pattern and is recovered
    exactly through ``pad_count`` (see ``ops.kernels.scan``). The sort is
    not stable: that only permutes the summands of a run."""
    with span("sort"):
        key, order = torch.sort(key)
        vals = vals[order]
    return merge_epilogue(key, vals, n_cols, sentinel_row, pad_count)


def merge_twokey(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, sentinel_row: int):
    """Merge a (row, col, val) stream of any output shape: sort by the
    int64 key ``row·2³² + col`` (rows ≤ sentinel_row < 2³¹, so sentinel
    rows sort last), sum each run, keep each run's last slot.

    The JAX package sums runs with a shift/add scan whose pass count
    ``max_run`` bounds; here each run's total comes from one
    ``index_add_`` (the sums' order differs, within rounding)."""
    with span("sort"):
        key, order = torch.sort(rows.long() * 2**32 + cols.long())
        vals = vals[order]
    with span("merge"):
        n = key.shape[0]
        change = key[1:] != key[:-1]
        first = torch.ones(n, dtype=torch.bool, device=key.device)
        first[1:] = change
        is_last = torch.ones(n, dtype=torch.bool, device=key.device)
        is_last[:-1] = change
        run = torch.cumsum(first, 0) - 1
        sums = torch.zeros(n, dtype=torch.float32, device=key.device)
        sums.index_add_(0, run, vals)
        rows_s = (key >> 32).to(torch.int32)
        valid = is_last & (rows_s < sentinel_row)
        return (
            torch.where(valid, rows_s, sentinel_row),
            torch.where(valid, (key & 0xFFFFFFFF).to(torch.int32), 0),
            torch.where(valid, sums[run], 0.0),
            valid,
            valid.sum(dtype=torch.int32),
        )


@dataclasses.dataclass
class MergedCOO:
    """Device-resident merged result: padded, row-major sorted, masked."""

    shape: tuple[int, int]
    rows: torch.Tensor  # int32[N], sentinel where ~valid
    cols: torch.Tensor
    vals: torch.Tensor
    valid: torch.Tensor  # bool[N]
    nnz: torch.Tensor  # int32 scalar

    def to_csr(self) -> CSR:
        """An exact-nnz host CSR: compacted on the device
        (``ops.chain.compact_to_csr_device``; the stream is row-major
        sorted and compaction keeps its order), nnz read once, and only
        the nnz columns and values and ``indptr`` copied to the host,
        from a CUDA device into pinned buffers (pageable memory took
        4-8x longer on the H100's host; ``PERF.md`` §6). A ``fetch``
        span."""
        from outerspace_tpu_torch.ops.chain import compact_to_csr_device

        with span("fetch"):
            _, cols, vals, indptr, _ = compact_to_csr_device(
                self.rows, self.cols, self.vals, self.valid,
                nnz_pad=int(self.nnz), m=self.shape[0],
            )
            parts = (indptr, cols, vals)
            if cols.is_cuda:
                host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in parts]
                for h, t in zip(host, parts):
                    h.copy_(t, non_blocking=True)
                torch.cuda.current_stream(cols.device).synchronize()
                parts = host
            return CSR(self.shape, *(t.numpy() for t in parts))


# --------------------------------------------------------------------------
# Flat strategy: one expand over the symbolic plan, then one merge
# --------------------------------------------------------------------------


def _spgemm_device(
    a_rows, a_vals, a_k, b_indptr, b_cols, b_vals, offsets, p_total,
    *, p_pad: int, sentinel_row: int, n_cols: int, packed: bool,
):
    """The flat device stage: expand over [0, p_pad), then the packed
    merge (sort + K2; ``pad_count`` = the slots past P) or the two-key
    merge. Returns (rows, cols, vals, valid, nnz)."""
    args = (a_rows, a_vals, a_k, b_indptr, b_cols, b_vals, offsets, p_total)
    if packed:
        with span("expand"):
            key, v = _expand_light_packed(
                *args, p_pad=p_pad, sentinel_row=sentinel_row, n_cols=n_cols
            )
        return merge_biased_keys(key, v, n_cols, sentinel_row, p_pad - p_total)
    with span("expand"):
        r, c, v = expand_partial_products(*args, p_pad, sentinel_row)
    return merge_twokey(r, c, v, sentinel_row)


def can_pack(plan: ExpansionPlan) -> bool:
    """Biased-uint32 packing covers every m·n ≤ 2³² (e.g. 65536²)."""
    return plan.m * plan.n <= 2**32


def spgemm_padded(
    plan: ExpansionPlan,
    p_pad: int | None = None,
    device_args: dict | None = None,
    packed: bool | None = None,
    device: str | torch.device = "cuda",
) -> MergedCOO:
    """The flat strategy on ``device`` (or where ``device_args``, from
    :func:`plan_to_device`, lie); returns the padded merged result.
    ``p_pad`` (default ``plan.padded_size()``) must hold the expansion;
    ``packed`` (default :func:`can_pack`) picks the packed merge, which
    m·n > 2³² refuses."""
    if p_pad is None:
        p_pad = plan.padded_size()
    if plan.expansion_size > p_pad:
        raise ValueError(f"p_pad={p_pad} smaller than expansion size {plan.expansion_size}")
    if packed is None:
        packed = can_pack(plan)
    if packed and not can_pack(plan):
        raise ValueError(f"packed keys need m*n <= 2^32, got {plan.m}*{plan.n}")
    dev = device_args if device_args is not None else plan_to_device(plan, device)
    rows, cols, vals, valid, nnz = _spgemm_device(
        **dev, p_pad=int(p_pad), sentinel_row=plan.m, n_cols=plan.n, packed=packed
    )
    return MergedCOO((plan.m, plan.n), rows, cols, vals, valid, nnz)


def empty_csr(m: int, n: int) -> CSR:
    """The m × n product with no nonzeros."""
    return CSR(
        (m, n),
        np.zeros(m + 1, dtype=np.int64),
        np.zeros(0, dtype=INDEX_DTYPE),
        np.zeros(0, dtype=VALUE_DTYPE),
    )


# --------------------------------------------------------------------------
# Tiled strategy: dense-tile expand (K3 / K4) for heavy k + gather residue
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TiledPlan:
    """Host plan of the tiled pipeline, staged on ``device``.

    ``group``: the non-empty class tables joined for one K3 / K4 launch
    (None when every class is empty). ``device_args["classes"]``: per
    tile class (``TILE_A_CLASSES``) its padded task table, views into
    ``group``, and the B blocks, or None for an empty class.
    ``device_args["gather"]``: K1's inputs for the residue (m·n ≤ 2³²).
    ``device_args["light"]``: the flat expand's inputs for the residue
    otherwise."""

    m: int
    n: int
    class_plan: ClassPlan
    light_plan: ExpansionPlan | None
    light_pad: int
    device_args: dict
    device: torch.device
    # The windowed-gather residue (K1): groups, stream length, real
    # products, B window, per-slab-call search depths.
    gather_ngroups: int = 0
    gather_p_out: int = 0
    gather_p_real: int = 0
    gather_b_win: int = 0
    gather_call_bits: tuple[int, ...] | None = None
    group: TileGroup | None = None

    @property
    def padded_total(self) -> int:
        return self.class_plan.padded_heavy + self.light_pad + self.gather_p_out

    def class_tables(self):
        """(schedule, staged table) of each non-empty class, in order."""
        return [
            (sched, dev)
            for sched, dev in zip(self.class_plan.classes, self.device_args["classes"])
            if dev is not None
        ]


def group_classes(classes, tables, b_cols_blk, b_vals_blk, device):
    """``(group, per-class tables)``: the host tables of the non-empty
    classes (``tables[i]``, None for an empty class, as
    :func:`schedule_to_host` gives them) joined on ``device``
    (``stage_group``), and each class's table as views into the group,
    None for an empty class. ``(None, [None, ...])`` when all are
    empty."""
    live = [(c.tile_a, t) for c, t in zip(classes, tables) if t is not None]
    if not live:
        return None, [None] * len(classes)
    group = stage_group(live, b_cols_blk, b_vals_blk, device)
    views = (group.table(c) for c in range(len(live)))
    return group, [None if t is None else next(views) for t in tables]


def plan_tiled(
    a_csc: CSC,
    b_csr: CSR,
    waste_limit: float | None = None,
    device: str | torch.device = "cuda",
) -> TiledPlan:
    """Plan the tiled pipeline (tile classes + gather residue, or the
    flat residue past 2³²) and stage it on ``device``;
    ``waste_limit=None`` takes the cost model's pick."""
    from outerspace_tpu_torch.ops.gather_pipeline import _to_device
    from outerspace_tpu_torch.sched.gplanner import call_search_bits, plan_gather_ranges

    device = torch.device(device)
    if waste_limit is None:
        from outerspace_tpu_torch.sched.autotune import best_waste_limit

        waste_limit = best_waste_limit(a_csc, b_csr)
    cp = plan_outer_classes(a_csc, b_csr, waste_limit=waste_limit)
    group, classes = None, [None] * len(cp.classes)
    if any(c.ntasks for c in cp.classes):
        cols_p, vals_p = b_blocks_host(b_csr.indices, b_csr.data)
        tables = [schedule_to_host(c) if c.ntasks else None for c in cp.classes]
        group, classes = group_classes(cp.classes, tables, cols_p, vals_p, device)
    dev = {"classes": classes}
    light_plan = None
    light_pad = 0
    gather_ngroups = gather_p_out = gather_p_real = gather_b_win = 0
    gather_call_bits = None
    m, n = a_csc.shape[0], b_csr.shape[1]
    if m * n <= 2**32 and (cp.light_k.shape[0] > 0 or cp.edge_k.shape[0] > 0):
        # The whole residue goes through K1 (exact P): light k's as whole
        # rows (chunked past the window bound) plus the partial edge
        # blocks of trimmed k's.
        b_ptr = np.asarray(b_csr.indptr).astype(np.int64)
        nbv = b_csr.major_nnz().astype(np.int64)
        lk = cp.light_k.astype(np.int64)
        lk = lk[nbv[lk] > 0]
        gplan = plan_gather_ranges(
            a_csc,
            np.concatenate([lk, cp.edge_k]),
            np.concatenate([b_ptr[lk], cp.edge_jb]),
            np.concatenate([nbv[lk], cp.edge_len]),
            np.asarray(b_csr.indices),
            np.asarray(b_csr.data),
            m,
            n,
        )
        if gplan is not None:
            gather_call_bits = call_search_bits(gplan.group_width, gplan.ngroups)
            dev["gather"] = _to_device(
                gather_plan_to_host(gplan), gather_call_bits, gplan.ngroups, device
            )
            gather_ngroups = gplan.ngroups
            gather_p_out = gplan.p_out
            gather_p_real = gplan.p_real
            gather_b_win = gplan.b_win
    elif cp.light_k.shape[0] > 0 and cp.light_p > 0:
        light_plan = expansion_plan_subset(a_csc, b_csr, cp.light_k)
        # a multiple of 1024, as the JAX package pads it
        light_pad = -(-light_plan.padded_size(min_size=1024) // 1024) * 1024
        dev["light"] = plan_to_device(light_plan, device)
    return TiledPlan(
        m, n, cp, light_plan, light_pad, dev, device,
        gather_ngroups=gather_ngroups,
        gather_p_out=gather_p_out,
        gather_p_real=gather_p_real,
        gather_b_win=gather_b_win,
        gather_call_bits=gather_call_bits,
        group=group,
    )


def _expand_residue_gather(tplan: TiledPlan, out=None):
    g = tplan.device_args["gather"]
    return expand_gather(
        g["bases"], g["table"], g["a_pack"], g["b_pack"], g["group_bits"],
        b_win=tplan.gather_b_win, out=out,
    )


def _expand_light_packed(
    a_rows, a_vals, a_k, b_indptr, b_cols, b_vals, offsets, p_total,
    *, p_pad: int, sentinel_row: int, n_cols: int,
):
    """The light residue's (biased keys, vals) stream; INT32_MAX past P."""
    r, c, v = expand_partial_products(
        a_rows, a_vals, a_k, b_indptr, b_cols, b_vals, offsets, p_total,
        p_pad, sentinel_row,
    )
    valid = torch.arange(p_pad, device=r.device) < p_total
    return torch.where(valid, pack_key_biased(r, c, n_cols), I32_MAX), v


def tiled_expand_packed(
    tplan: TiledPlan, merge_pad: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The packed expand stage, written in place into one stream of
    ``merge_pad`` slots (default ``tplan.padded_total``): K3 once over
    every class table at the front, then K1 on the gather residue, the
    flat expand's light residue, and sentinel slots (INT32_MAX, 0) to
    the end. Returns ``(keys, vals, pad_count)``: the stream and its
    sentinel padding, :func:`tiled_pad_count` plus the tail."""
    total = tplan.padded_total
    length = total if merge_pad is None else merge_pad
    if length < total:
        raise ValueError(f"merge_pad={merge_pad} < part stream {total}")
    with span("expand"):
        keys = torch.empty(length, dtype=torch.int32, device=tplan.device)
        vals = torch.empty(length, dtype=torch.float32, device=tplan.device)
        pos = 0
        if tplan.group is not None:
            pos = tplan.group.slots
            expand_part_packed(tplan.group, n_cols=tplan.n, out_keys=keys[:pos], out_vals=vals[:pos])
        if tplan.gather_ngroups:
            end = pos + tplan.gather_p_out
            _expand_residue_gather(tplan, out=(keys[pos:end], vals[pos:end]))
            pos = end
        if tplan.light_plan is not None:
            k, v = _expand_light_packed(
                **tplan.device_args["light"],
                p_pad=tplan.light_pad, sentinel_row=tplan.m, n_cols=tplan.n,
            )
            keys[pos:pos + tplan.light_pad].copy_(k)
            vals[pos:pos + tplan.light_pad].copy_(v)
            pos += tplan.light_pad
        keys[pos:].fill_(I32_MAX)
        vals[pos:].zero_()
    return keys, vals, tiled_pad_count(tplan) + length - total


def tiled_pad_count(tplan: TiledPlan) -> int:
    """Exact count of sentinel padding slots in the packed expand stream:
    tile-class padding + gather subtile tails + light tail. The one
    source of the pad count that K2's 2³²-corner rule reads."""
    pad_count = sum(s.padded_heavy - s.heavy_p for s, _ in tplan.class_tables())
    pad_count += tplan.gather_p_out - tplan.gather_p_real
    if tplan.light_plan is not None:
        pad_count += tplan.light_pad - tplan.light_plan.expansion_size
    return pad_count


def spgemm_padded_tiled(
    tplan: TiledPlan,
    packed: bool | None = None,
    merge_pad: int | None = None,
) -> MergedCOO:
    """Expand (K3 or K4 once over the class tables, K1 or the flat
    expand on the residue, all in place into one stream), then merge.

    ``packed=None`` packs keys when m·n ≤ 2³². ``merge_pad`` pads the
    packed stream with sentinel slots (counted into ``pad_count``) to the
    row-parts plan's common length."""
    if packed is None:
        packed = tplan.m * tplan.n <= 2**32
    if packed and tplan.m * tplan.n > 2**32:
        raise ValueError(
            f"packed keys need m*n <= 2^32, got {tplan.m}*{tplan.n}; "
            "use packed=False or a rebased row-parts plan"
        )
    if merge_pad is not None and not packed:
        raise ValueError("merge_pad needs packed keys")
    sentinel = tplan.m
    if tplan.group is None and tplan.light_plan is None and not tplan.gather_ngroups:
        dev = tplan.device
        return MergedCOO(
            (tplan.m, tplan.n),
            torch.full((1,), I32_MAX, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.float32, device=dev),
            torch.zeros(1, dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
        )
    if packed:
        key, vals, pad_count = tiled_expand_packed(tplan, merge_pad)
        r, c, v, valid, nnz = merge_biased_keys(key, vals, tplan.n, sentinel, pad_count)
        return MergedCOO((tplan.m, tplan.n), r, c, v, valid, nnz)
    # the coordinate stream, in place: K4 over the classes, then the
    # residue (K1's keys unpacked, or the flat expand)
    with span("expand"):
        total = tplan.padded_total
        rows = torch.empty(total, dtype=torch.int32, device=tplan.device)
        cols = torch.empty(total, dtype=torch.int32, device=tplan.device)
        vals = torch.empty(total, dtype=torch.float32, device=tplan.device)
        pos = 0
        if tplan.group is not None:
            pos = tplan.group.slots
            expand_part_coords(tplan.group, sentinel_row=sentinel,
                               out_rows=rows[:pos], out_cols=cols[:pos], out_vals=vals[:pos])
        if tplan.gather_ngroups:
            # K1 emits packed keys; unpack them for the two-key merge (the
            # gather residue exists only when m·n ≤ 2³²)
            if tplan.m * tplan.n == 2**32:
                raise ValueError(
                    "packed=False with a gather residue cannot recover the "
                    "(m-1, n-1) corner at m*n == 2^32; use the packed merge"
                )
            end = pos + tplan.gather_p_out
            k, _ = _expand_residue_gather(tplan, out=(rows[pos:end], vals[pos:end]))
            gr, gc = unpack_key_biased(k, tplan.n)
            live = k != I32_MAX
            cols[pos:end] = torch.where(live, gc, 0)
            rows[pos:end] = torch.where(live, gr, sentinel)
            pos = end
        if tplan.light_plan is not None:
            for out, x in zip((rows, cols, vals), expand_partial_products(
                    **tplan.device_args["light"], p_pad=tplan.light_pad, sentinel_row=sentinel)):
                out[pos:].copy_(x)
    r, c, v, valid, nnz = merge_twokey(rows, cols, vals, sentinel)
    return MergedCOO((tplan.m, tplan.n), r, c, v, valid, nnz)


# --------------------------------------------------------------------------
# Row-partitioned tiled pipeline
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TiledPartsPlan:
    """The tiled pipeline over contiguous output-row parts, each planned
    by the full planner on its row slice of A. Parts cover ascending row
    ranges, so the concatenated merged parts are row-major among valid
    slots.

    ``merge_pad``: common to every part (each part's packed stream pads
    to it); 0 = per-part lengths. ``rebased``:
    each part was planned on a local-row slice (``_slice_a_rows(...,
    local=True)``), so its keys live in the part's span·n space; this
    takes the packed merge to any m·n, and global rows come back by
    adding the part's first row."""

    m: int
    n: int
    parts: list  # [(row_lo, row_hi, TiledPlan)]
    merge_pad: int = 0
    rebased: bool = False

    @property
    def padded_total(self) -> int:
        if self.merge_pad:
            return self.merge_pad * len(self.parts)
        return sum(p.padded_total for _, _, p in self.parts)


def row_products(a_csc: CSC, b_csr: CSR) -> np.ndarray:
    """Products per output row: Σ over A elements e of nnz_B(k(e))."""
    nb = b_csr.major_nnz().astype(np.int64)
    a_k = np.repeat(
        np.arange(a_csc.shape[1], dtype=np.int64),
        a_csc.major_nnz().astype(np.int64),
    )
    return np.bincount(
        np.asarray(a_csc.indices, dtype=np.int64),
        weights=nb[a_k].astype(np.float64),
        minlength=a_csc.shape[0],
    ).astype(np.int64)


def _slice_a_rows(a_csc: CSC, lo: int, hi: int, local: bool = False) -> CSC:
    """A restricted to output rows [lo, hi), same shape (global rows);
    with ``local=True`` rows rebase to ``row - lo`` and the shape shrinks
    to ``(hi - lo, k)``. CSC columns stay row-sorted."""
    rows = np.asarray(a_csc.indices)
    sel = (rows >= lo) & (rows < hi)
    a_k = np.repeat(
        np.arange(a_csc.shape[1], dtype=np.int64),
        a_csc.major_nnz().astype(np.int64),
    )
    indptr = np.zeros(a_csc.shape[1] + 1, dtype=np.int64)
    np.cumsum(np.bincount(a_k[sel], minlength=a_csc.shape[1]), out=indptr[1:])
    out_rows = rows[sel]
    shape = a_csc.shape
    if local:
        out_rows = out_rows - np.asarray(lo, dtype=out_rows.dtype)
        shape = (hi - lo, a_csc.shape[1])
    return CSC(shape, indptr, out_rows, np.asarray(a_csc.data)[sel])


def default_part_count(padded_total: int, min_part_stream: int = 2 << 20) -> int:
    """Row parts for a padded stream: one per ~``min_part_stream``
    elements, a power of two, at most 4 (8 from 64 M elements). The JAX
    package's rule, kept so both packages cut the same parts."""
    cap = 8 if padded_total >= (64 << 20) else 4
    nparts = int(min(cap, max(1, padded_total // min_part_stream)))
    return 1 << (nparts - 1).bit_length() if nparts > 1 else 1


def _bounds_span_capped(rp: np.ndarray, nparts: int, span_cap: int) -> np.ndarray:
    """Contiguous product-balanced row bounds with every span ≤
    ``span_cap``: a greedy walk toward the even split of what remains,
    clipped to the cap."""
    cum = np.zeros(rp.shape[0] + 1, dtype=np.float64)
    np.cumsum(rp, out=cum[1:])
    total = cum[-1]
    m = rp.shape[0]
    bounds = [0]
    while bounds[-1] < m:
        lo = bounds[-1]
        remaining = max(1, nparts - (len(bounds) - 1))
        target = cum[lo] + (total - cum[lo]) / remaining
        hi = int(np.searchsorted(cum, target, side="left"))
        hi = max(hi, lo + 1)
        # absorb the zero-product run after hi
        hi = int(np.searchsorted(cum, cum[hi], side="right")) - 1
        hi = min(max(hi, lo + 1), lo + span_cap, m)
        bounds.append(hi)
    return np.asarray(bounds, dtype=np.int64)


_MAX_PARTS = 64  # runaway guard for extreme aspect ratios


def plan_tiled_parts(
    a_csc: CSC,
    b_csr: CSR,
    waste_limit: float | None = None,
    nparts: int | None = None,
    min_part_stream: int = 2 << 20,
    budget: float = 1.12,
    device: str | torch.device = "cuda",
) -> TiledPartsPlan | TiledPlan:
    """Plan the row-partitioned tiled pipeline, or return the single
    ``TiledPlan`` when splitting does not pay: a small stream, or a split
    whose padded total exceeds ``budget`` × the unsplit plan's (the
    fragmentation guard, retried at halved part counts).

    For m·n > 2³² the split is mandatory and rebased: each part's span is
    capped at ``2³²//n`` so its packed keys fit, with a looser budget
    (1.5); the unsplit two-key plan is the last resort."""
    from outerspace_tpu_torch.shard.mesh import balanced_contiguous_partition

    if waste_limit is None:
        from outerspace_tpu_torch.sched.autotune import best_waste_limit

        waste_limit = best_waste_limit(a_csc, b_csr)
    base = plan_tiled(a_csc, b_csr, waste_limit=waste_limit, device=device)
    m, n = a_csc.shape[0], b_csr.shape[1]
    rebased = m * n > 2**32
    span_cap = (2**32 // n) if n else m
    min_parts = 1
    if rebased:
        if span_cap < 1 or n >= 2**31:
            return base
        min_parts = -(-m // span_cap)
        if min_parts > _MAX_PARTS:
            return base
        budget = max(budget, 1.5)
    if nparts is None:
        nparts = default_part_count(base.padded_total, min_part_stream)
    nparts = max(nparts, min_parts)
    if nparts <= 1:
        return base
    rp = row_products(a_csc, b_csr).astype(np.float64)
    while nparts >= max(min_parts, 2):
        if rebased:
            bounds = _bounds_span_capped(rp, nparts, span_cap)
            if bounds.shape[0] - 1 > _MAX_PARTS:
                return base
        else:
            bounds = balanced_contiguous_partition(rp, nparts)
        parts = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            lo, hi = int(lo), int(hi)
            if hi <= lo:
                continue
            a_p = _slice_a_rows(a_csc, lo, hi, local=rebased)
            if a_p.nnz == 0:
                continue
            parts.append((lo, hi, plan_tiled(a_p, b_csr, waste_limit=waste_limit, device=device)))
        if len(parts) > 1 or (rebased and parts):
            # the guard charges the commonized total (every part merges
            # merge_pad slots)
            merge_pad = -(-max(p.padded_total for _, _, p in parts) // 4096) * 4096
            split = TiledPartsPlan(m, n, parts, merge_pad=merge_pad, rebased=rebased)
            if split.padded_total <= budget * max(base.padded_total, 1):
                return split
            if rebased and nparts // 2 < min_parts:
                # no smaller legal split: try per-part stream lengths
                uncommon = TiledPartsPlan(m, n, parts, rebased=True)
                if uncommon.padded_total <= budget * max(base.padded_total, 1):
                    return uncommon
                return base
        nparts //= 2
    return base


def spgemm_padded_tiled_parts(
    plan: TiledPartsPlan | TiledPlan,
    packed: bool | None = None,
) -> MergedCOO:
    """Run the (possibly row-partitioned, possibly rebased) tiled
    pipeline; the parts' launches queue back to back, then their merged
    streams join into one (a ``merge`` span)."""
    if isinstance(plan, TiledPlan):
        return spgemm_padded_tiled(plan, packed=packed)
    # The common stream length is a packed-key feature; an explicit
    # packed=False keeps per-part two-key merges. Rebased plans pack by
    # construction (each part's local key space fits).
    packed_eff = (plan.rebased or plan.m * plan.n <= 2**32) if packed is None else packed
    merge_pad = (plan.merge_pad or None) if packed_eff else None
    parts = [(lo, spgemm_padded_tiled(tp, packed=packed, merge_pad=merge_pad))
             for lo, _, tp in plan.parts]
    with span("merge"):
        rows_l, cols_l, vals_l, valid_l, nnz = [], [], [], [], 0
        while parts:  # each part's local rows go once rebased
            lo, part = parts.pop(0)
            rows = part.rows
            if plan.rebased:  # part-local rows (and sentinel) → global
                rows = torch.where(part.valid, rows + lo, plan.m)
            rows_l.append(rows)
            cols_l.append(part.cols)
            vals_l.append(part.vals)
            valid_l.append(part.valid)
            nnz = nnz + part.nnz
        return MergedCOO(
            (plan.m, plan.n),
            torch.cat(rows_l), torch.cat(cols_l), torch.cat(vals_l), torch.cat(valid_l), nnz,
        )


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------


def spgemm(
    a: COO | CSR | CSC,
    b: COO | CSR | CSC,
    strategy: str = "auto",
    packed: bool | None = None,
    config=None,
    device: str | torch.device = "cuda",
    p_pad: int | None = None,
) -> CSR:
    """C = A @ B; returns a host CSR with exact nnz.

    ``strategy``: "gather" runs the row-split windowed-gather pipeline
    (``ops.gather_pipeline``: K1, sort, K2); "tiles" runs the tiled
    pipeline (``plan_tiled_parts``: K3 or K4 per tile class, K1 on the
    residue, then the packed merge with K2, or with ``packed=False`` the
    two-key merge); "flat" expands the whole symbolic plan at once, then
    merges (``spgemm_padded``); "auto" takes the cost model's pick
    (``sched.planner.choose_strategy``). A caller-pinned ``p_pad``
    implies "flat" (tile and gather padding is structural) and is
    refused with "tiles" or "gather". ``packed`` applies to "tiles" and
    "flat". ``config``: a ``outerspace_tpu_torch.config.Config`` whose
    ``waste_limit`` steers the tile planner (None: the cost model's
    pick). Work runs on ``device``; "cpu" runs each kernel's plain
    version.

    A ``spgemm`` span (attribute ``strategy``, the one run) holds
    ``spgemm.plan`` (the symbolic plan, then the strategy's host plan
    with its ``spgemm.stage`` copies), ``spgemm.pick`` for "auto", the
    phases and ``fetch``."""
    from outerspace_tpu_torch.config import DEFAULT

    if strategy not in ("auto", "gather", "tiles", "flat"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    cfg = config if config is not None else DEFAULT
    with span("spgemm") as call:
        a_csc = a if isinstance(a, CSC) else a.to_csc()
        b_csr = b if isinstance(b, CSR) else b.to_csr()
        with span("spgemm.plan"):
            plan = expansion_plan(a_csc, b_csr)
        if plan.expansion_size == 0:
            return empty_csr(plan.m, plan.n)
        if strategy == "auto":
            from outerspace_tpu_torch.sched.planner import choose_strategy

            with span("spgemm.pick"):
                strategy = "flat" if p_pad is not None else choose_strategy(a_csc, b_csr)
        call.set(strategy=strategy)
        if strategy in ("tiles", "gather") and p_pad is not None:
            raise ValueError(
                "p_pad is only honored by the flat strategy; tile/gather "
                "padding is structural (use strategy='flat' or drop p_pad)"
            )
        if strategy == "tiles":
            with span("spgemm.plan"):
                tplan = plan_tiled_parts(a_csc, b_csr, waste_limit=cfg.waste_limit, device=device)
            return spgemm_padded_tiled_parts(tplan, packed=packed).to_csr()
        if strategy == "gather":
            from outerspace_tpu_torch.ops.gather_pipeline import spgemm_gather

            return spgemm_gather(a_csc, b_csr, device=device)
        return spgemm_padded(plan, p_pad, packed=packed, device=device).to_csr()


def spgemm_coo(a, b, p_pad: int | None = None, device: str | torch.device = "cuda") -> COO:
    """:func:`spgemm` as a COO; a ``p_pad`` runs the flat strategy."""
    return spgemm(a, b, p_pad=p_pad, device=device).to_coo()
