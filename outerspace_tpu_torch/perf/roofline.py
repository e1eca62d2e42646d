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
package's ``perf/roofline.py``. The sharded predictors wait for the
sharded mode's port.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class GPUConfig:
    """The card's constants, the counterpart of the JAX package's
    ``TPUConfig``. Defaults: one NVIDIA H100 SXM at its 700 W power
    limit, from NVIDIA's spec sheet, not measured: 3.35e12 B/s of HBM3,
    and 67e12 float32 op/s outside the tensor cores. A card set to a lower
    power limit runs slower than these."""

    hbm_bw_bytes: float = 3.35e12  # spec sheet, not measured
    fp32_ops: float = 67e12  # spec sheet, not measured

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
    """Whole single-device pipeline: multiply plus merge. ``ndev > 1``
    (and ``per_device_products``) belong to the sharded mode, which is not
    ported yet."""
    if ndev != 1 or per_device_products is not None:
        raise NotImplementedError(
            "multi-device prediction needs the sharded mode, which the port does not have yet"
        )
    return predict_multiply_time(padded_products, nnz_a, nnz_b, cfg) + predict_merge_time(
        padded_products, cfg
    )


# Per-slot bytes of the MCL chain's stages (ops/chain.py), each input
# read once and each output written once:
# the first squaring's prune: rows, cols, vals, valid in; the CSC key,
# the clamped value and the survivor flag out
_PRUNE1_BYTES = (4 + 4 + 4 + 1) + (4 + 4 + 1)
# the loop's prune of the merged stream: value and valid in; the clamped
# value and the survivor flag out, the survivor flag read again
_PRUNE_BYTES = (4 + 1) + (4 + 1) + 1 + 4
# _to_front, per input slot: the survivor flag in, its int64 running
# count out, the destinations made, then per stream (key, value) the
# destination and a 4-byte element in
_COMPACT_IN_BYTES = (1 + 8) + (8 + 1 + 8) + 2 * (8 + 4)
# _to_front, per output slot: the two streams filled, then written
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
    t += _stream_time(cfg, l1, _PRUNE1_BYTES + _COMPACT_IN_BYTES)
    t += predict_sort_time(elem_pad, cfg)
    t += _stream_time(cfg, elem_pad, _COMPACT_OUT_BYTES + _ELEM_TAIL_BYTES)
    for pp in p_pads:
        pp = max(pp, elem_pad)
        t += _stream_time(cfg, elem_pad, _ELEM_PREP_BYTES)
        t += _stream_time(cfg, pp, _LOOP_EXPAND_BYTES)
        t += predict_merge_time(pp, cfg)
        t += _stream_time(cfg, pp, _PRUNE_BYTES + _COMPACT_IN_BYTES)
        t += _stream_time(cfg, elem_pad, _COMPACT_OUT_BYTES + _ELEM_TAIL_BYTES)
    t += predict_sort_time(elem_pad, cfg)
    t += _stream_time(cfg, elem_pad, _FINAL_BYTES)
    return t


def achieved_fraction(measured_s: float, predicted_s: float) -> float:
    """Roofline attainment: predicted / measured (1.0 = at the roof)."""
    return predicted_s / max(measured_s, 1e-12)
