"""Analytical roofline of the port's SpGEMM and MCL pipelines on one card.

Each phase takes the larger of its float32 operations over the card's
peak rate and the bytes it must move over the memory rate
(:meth:`GPUConfig.time`). The bytes are those of the port's own
pipeline, read from its tensors' dtypes:

- the expand (K1 / K3 / the flat expand) writes one packed int32 key and
  one float32 value per slot (:data:`STREAM_BYTES`) and reads each
  operand nonzero's int32 index and float32 value once;
- the merge is ``torch.sort`` of the int32 keys, a radix sort of 8-bit
  digits over the keys and their int64 order (one read and one write of
  both per digit pass), the values gathered by that order, then K2's
  epilogue (keys and values in; rows, columns, values and the valid flag
  out).

It is a closed-form cross-check printed beside measured times (the
command line's ``spgemm`` and ``graph mcl``), the counterpart of the JAX
package's ``perf/roofline.py``. The sharded predictors
(:func:`predict_sharded_tiled`, ``predict_spgemm_time(ndev > 1)``,
:func:`predict_mcl_sharded_iteration`) add the exchange over NVLink.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class GPUConfig:
    """The card's constants, the counterpart of the JAX package's
    ``TPUConfig``. Defaults: one NVIDIA H100 SXM at its 700 W power
    limit, from NVIDIA's spec sheet, not measured: 3.35e12 B/s of HBM3,
    67e12 float32 op/s outside the tensor cores, 989e12 dense bf16 op/s
    in them, and 450e9 B/s of NVLink out of each card (the sharded
    mode's exchange). A card set to a lower power limit runs slower than
    these."""

    hbm_bw_bytes: float = 3.35e12  # spec sheet, not measured
    fp32_ops: float = 67e12  # spec sheet, not measured
    # the tensor cores' dense bf16 rate (the event model's matrix unit):
    # spec sheet, not measured
    tensor_ops: float = 989e12
    # NVLink 4 out of one card, one direction (900 GB/s both ways, all to
    # all through the NVSwitch): spec sheet, not measured
    nvlink_bw_bytes: float = 450e9

    def time(self, ops: float, bytes_moved: float) -> float:
        """Seconds: the larger of ``ops`` float32 operations at the peak
        rate and ``bytes_moved`` at the memory rate."""
        return max(ops / self.fp32_ops, bytes_moved / self.hbm_bw_bytes)


STREAM_BYTES = 8  # per expanded slot: int32 packed key + float32 value
OPERAND_BYTES = 8  # per operand nonzero: int32 index + float32 value
RADIX_PASSES = 4  # 32-bit keys in 8-bit digits
SORT_SLOT_BYTES = 4 + 8  # per slot and pass: the int32 key and its int64 order
GATHER_BYTES = 8 + 4 + 4  # vals[order]: the order and a value in, a value out
EPILOGUE_BYTES = (4 + 4) + (4 + 4 + 4 + 1)  # K2: key, val in; row, col, val, valid out
SORT_IMPLS = ("cub_radix", "xla_bitonic")


def multiply_bytes(padded_products: int, nnz_a: int, nnz_b: int) -> int:
    """Bytes of the expand: the stream written once, the operands read once."""
    return padded_products * STREAM_BYTES + (nnz_a + nnz_b) * OPERAND_BYTES


def sort_bytes(n: int, sort_impl: str = "cub_radix") -> int:
    """Bytes of sorting an n-slot (key, value) stream.

    "cub_radix": the port's ``torch.sort`` (``RADIX_PASSES`` passes over
    the keys and their order) and the values gathered by the order.
    "xla_bitonic": a two-lane (key, value) bitonic network that keeps
    about 8 of its log²-many stages on chip per round trip to memory."""
    if sort_impl == "cub_radix":
        return n * (RADIX_PASSES * 2 * SORT_SLOT_BYTES + GATHER_BYTES)
    if sort_impl == "xla_bitonic":
        lg = math.ceil(math.log2(max(n, 2)))
        return int(n * 8 * 2 * max((lg * lg + lg) // 2 / 8.0, 1.0))
    raise ValueError(f"sort_impl {sort_impl!r}: expected one of {SORT_IMPLS}")


def merge_bytes(n: int, sort_impl: str = "cub_radix") -> int:
    """Bytes of merging an n-slot stream: the sort, then K2's epilogue
    (and its int32 nnz)."""
    return sort_bytes(n, sort_impl) + n * EPILOGUE_BYTES + 4


def predict_multiply_time(
    padded_products: int, nnz_a: int, nnz_b: int, cfg: GPUConfig = GPUConfig()
) -> float:
    """Expand phase: one multiply per slot, :func:`multiply_bytes`."""
    return cfg.time(padded_products, multiply_bytes(padded_products, nnz_a, nnz_b))


def predict_merge_time(
    padded_products: int,
    cfg: GPUConfig = GPUConfig(),
    sort_impl: str = "cub_radix",
    parts: int = 1,
) -> float:
    """Merge phase: the sort and K2 (one add per slot),
    :func:`merge_bytes`. ``parts``: the row parts of the pipeline, each
    merging ⌈P / parts⌉ slots on its own."""
    if parts > 1:
        per = -(-padded_products // parts)
        return parts * predict_merge_time(per, cfg, sort_impl)
    n = max(padded_products, 2)
    return cfg.time(n, merge_bytes(n, sort_impl))


def predict_sort_time(
    n_pairs: int, cfg: GPUConfig = GPUConfig(), sort_impl: str = "cub_radix"
) -> float:
    """Sort only: the merge model without K2's epilogue."""
    return cfg.time(0, sort_bytes(max(n_pairs, 2), sort_impl))


def predict_spgemm_time(
    padded_products: int,
    nnz_a: int,
    nnz_b: int,
    cfg: GPUConfig = GPUConfig(),
    ndev: int = 1,
    per_device_products: list[int] | None = None,
) -> float:
    """Whole pipeline: multiply plus merge. With ``ndev > 1`` the sharded
    mode's plan-free estimate: the most loaded rank (``per_device_products``,
    default an even split) expands its slice, sorts it by owner, sends
    the (ndev − 1)/ndev of it that other ranks own over NVLink, and
    merges as many products again. :func:`predict_sharded_tiled` charges a
    real plan."""
    if ndev == 1 and per_device_products is None:
        return predict_multiply_time(padded_products, nnz_a, nnz_b, cfg) + predict_merge_time(
            padded_products, cfg
        )
    per_dev = per_device_products or [padded_products // ndev] * ndev
    worst = max(per_dev)
    t = predict_multiply_time(worst, nnz_a // ndev + 1, nnz_b, cfg)
    t += predict_sort_time(worst, cfg)
    t += worst * STREAM_BYTES * (ndev - 1) / ndev / cfg.nvlink_bw_bytes
    return t + predict_merge_time(worst, cfg)


def predict_sharded_tiled(plan, cfg: GPUConfig = GPUConfig()) -> float:
    """The tiled sharded program (``shard/tiled.py``) on the most loaded
    rank of a ``ShardedTiledPlan``, stage by stage:

    1. the expand of the rank's streams (its own tasks and K1's groups,
       ``tiled.rank_stream_lens``), and their sort: once over the
       stream, or per rebased bucket at that bucket's stream length;
    2. per chunk, the bucket fill (kx·capacity slots read and written)
       and the all_to_all: the (kx − 1) buckets other ranks own, over
       NVLink (nothing with one rank on the axis);
    3. the merges: chunks × merge_parts streams of kx·mcap slots, each
       part filled first when there are several; with kx = 1 the stream
       arrives sorted and only K2 runs."""
    from outerspace_tpu_torch.shard.tiled import rank_stream_lens

    kx = plan.kx
    t = 0.0
    for i in range(kx):
        for j in range(plan.ny):
            lens = rank_stream_lens(plan, i, j)
            tr = predict_multiply_time(sum(lens), 0, 0, cfg)
            tr += sum(predict_sort_time(n, cfg) for n in lens if n)
            t = max(t, tr)
    slots = kx * plan.capacity
    t += plan.chunks * _stream_time(cfg, slots, 2 * STREAM_BYTES)
    t += plan.chunks * (kx - 1) * plan.capacity * STREAM_BYTES / cfg.nvlink_bw_bytes
    per = max(kx * plan.mcap, 2)
    n_streams = plan.chunks * plan.merge_parts
    if plan.merge_parts > 1:
        t += n_streams * _stream_time(cfg, per, 2 * STREAM_BYTES)
    if kx == 1:
        t += n_streams * cfg.time(per, per * EPILOGUE_BYTES + 4)
    else:
        t += n_streams * predict_merge_time(per, cfg)
    return t


# Per-slot bytes of the sharded MCL loop's stages (shard/mcl.py), each
# input read once and each output written once:
# the flat expand (ops.spgemm.expand_partial_products), per product slot:
# three segment broadcasts (row, value, B offset: an int64 difference
# scattered, cumsummed, narrowed to int32), the B position and the valid
# flag, B's column and value gathered, the product, the key packed and
# masked
_FLAT_EXPAND_BYTES = 3 * (8 + (8 + 8) + (8 + 4)) + (4 + 8) + 1 + (8 + 4 + 4) * 2 + (4 + 4 + 4) \
    + (4 + 4 + 4 + 1 + 4)
# after the merge, per merged slot: the power and the prune (value and
# valid in; value and keep out), the column sums scattered, the
# normalisation (value, column, the gathered sum in; value out), the new
# flow's key packed, and after its sort the column-major key packed
_MCL_INFLATE_BYTES = (4 + 1 + 4 + 1) + (4 + 4 + 4) + (4 + 4 + 4 + 4) + (4 + 4 + 1 + 4) \
    + (4 + 4 + 4 + 4)


def predict_mcl_sharded_iteration(plan, cfg: GPUConfig = GPUConfig()) -> float:
    """One iteration of the device-resident sharded MCL loop
    (``shard/mcl.py``) on a ``ShardedMclPlan``'s rank, stage by stage:

    1. the flat expand of ``p_pad`` slots and their sort;
    2. the bucket fill (kx·cap slots) and the all_to_all of the kx − 1
       buckets other ranks own, over NVLink;
    3. the merge of the kx·cap received slots (``torch.sort`` and K2; K2
       alone with one sender);
    4. inflate, prune and normalise over the merged slots, the column
       sums all-reduced along "x" (m float32 over NVLink);
    5. the re-shard: the new flow's sort and the column-major sort of
       the merged slots, the fill and all_to_all of kx·ecap slots, the
       all_gather along "y" and the A side's sort (``na`` slots).

    The counterpart of the JAX package's predictor, built from this
    module's terms (the card's spec-sheet rates, not measured); its
    event-model twin is ``perf.perfsim.simulate_mcl_sharded_iteration``."""
    kx, ny = plan.kx, plan.ny
    merged = kx * plan.cap
    t = _stream_time(cfg, plan.p_pad, _FLAT_EXPAND_BYTES) + predict_sort_time(plan.p_pad, cfg)
    t += _stream_time(cfg, merged, 2 * STREAM_BYTES)
    t += (kx - 1) * plan.cap * STREAM_BYTES / cfg.nvlink_bw_bytes
    if kx == 1:
        t += cfg.time(merged, merged * EPILOGUE_BYTES + 4)
    else:
        t += predict_merge_time(merged, cfg)
    t += _stream_time(cfg, merged, _MCL_INFLATE_BYTES)
    t += 2 * plan.m * 4 * (kx - 1) / kx / cfg.nvlink_bw_bytes
    t += 2 * predict_sort_time(merged, cfg)
    t += _stream_time(cfg, kx * plan.ecap, 2 * STREAM_BYTES)
    t += (kx - 1) * plan.ecap * STREAM_BYTES / cfg.nvlink_bw_bytes
    t += (ny - 1) * kx * plan.ecap * STREAM_BYTES / cfg.nvlink_bw_bytes
    return t + predict_sort_time(plan.na, cfg)


# Per-slot bytes of the MCL chain's stages (ops/chain.py), each input
# read once and each output written once:
# the prune and compaction of a merged stream (csrc/prune_compact.cu,
# after the first squaring and after each loop squaring), per input slot:
# value and valid in; the survivors' keys (or rows and columns) read and
# their keys and values written are bounded by the element slots
# (_COMPACT_OUT_BYTES)
_PRUNE_COMPACT_BYTES = 4 + 1
# a compaction, per output slot: the survivors' keys (or rows and
# columns) read and their keys and values written
_COMPACT_OUT_BYTES = 2 * (4 + 4)
# after each compaction, per element slot: the power (value, key in;
# value out), the column starts (the keys searched once, one probe per
# column, at most one column per element), the column sums (column keys
# made, K2 over them, the totals broadcast back) and the normalisation
_ELEM_TAIL_BYTES = (4 + 4 + 4) + (4 + 8) + ((4 + 4) + EPILOGUE_BYTES + 8) + (4 + 4 + 4 + 4)
# the loop's per-element preparation: the key split into column, row and
# valid; the column degree gathered; the product offsets (int64 cumsum)
_ELEM_PREP_BYTES = 4 + (4 + 4 + 1) + (4 + 1 + 4) + (4 + 4 + 4) + (4 + 8)
# the loop's expand, per product slot (the gather join): the element's
# column and value broadcast, the B-side row and value gathered, the
# key packed and masked
_LOOP_EXPAND_BYTES = (4 + 4) + (4 + 4 + 4 + 4) + (4 + 4 + 4 + 4)
# the end: the CSC key unpacked and repacked row-major (sorted, then
# fitted to the output and unpacked), bounded by the element slots
_FINAL_BYTES = (4 + 8) + (8 + 4) + (4 + 4 + 4 + 4 + 4 + 4 + 1)


def _stream_time(cfg: GPUConfig, slots: int, bytes_per_slot: int) -> float:
    return cfg.time(slots, slots * bytes_per_slot)


def predict_mcl_time(
    p_stage1: int,
    p_pads: list[int] | tuple[int, ...],
    elem_pad: int,
    nnz_stage1_stream: int | None = None,
    cfg: GPUConfig = GPUConfig(),
    stage1_parts: int = 1,
) -> float:
    """The staged MCL chain (``ops/chain.py:mcl_whole_traced``), stage by
    stage:

    1. the first squaring: expand of ``p_stage1`` slots and the merge of
       its stream (``nnz_stage1_stream`` slots, default ``p_stage1``) in
       ``stage1_parts`` row parts;
    2. its prune, the compaction of that stream to ``elem_pad`` slots and
       their sort, then the power, column starts, column sums and
       normalisation;
    3. per loop iteration (``p_pads``: each one's product slots, at least
       ``elem_pad``): the elements' preparation, the expand, the sort and
       K2 over the products, the prune and compaction back to
       ``elem_pad``, and the same per-element tail;
    4. the row-major sort of the final flow.

    Charged per stage as in this module's header; a column-start probe
    per element slot bounds the m + 1 probes (the flow keeps its
    diagonal, so m ≤ nnz ≤ ``elem_pad``)."""
    l1 = nnz_stage1_stream or p_stage1
    t = predict_multiply_time(p_stage1, elem_pad, elem_pad, cfg)
    t += predict_merge_time(l1, cfg, parts=stage1_parts)
    t += _stream_time(cfg, l1, _PRUNE_COMPACT_BYTES)
    t += predict_sort_time(elem_pad, cfg)
    t += _stream_time(cfg, elem_pad, _COMPACT_OUT_BYTES + _ELEM_TAIL_BYTES)
    for pp in p_pads:
        pp = max(pp, elem_pad)
        t += _stream_time(cfg, elem_pad, _ELEM_PREP_BYTES)
        t += _stream_time(cfg, pp, _LOOP_EXPAND_BYTES)
        t += predict_merge_time(pp, cfg)
        t += _stream_time(cfg, pp, _PRUNE_COMPACT_BYTES)
        t += _stream_time(cfg, elem_pad, _COMPACT_OUT_BYTES + _ELEM_TAIL_BYTES)
    t += predict_sort_time(elem_pad, cfg)
    t += _stream_time(cfg, elem_pad, _FINAL_BYTES)
    return t


def achieved_fraction(measured_s: float, predicted_s: float) -> float:
    """Roofline attainment: predicted / measured (1.0 = at the roof)."""
    return predicted_s / max(measured_s, 1e-12)
