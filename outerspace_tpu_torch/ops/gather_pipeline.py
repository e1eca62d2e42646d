"""Row-split SpGEMM pipeline over the windowed-gather expand (K1).

The packed-uint32 merge key covers m·n ≤ 2³². For larger output spaces
(e.g. the 100k×100k ER workload, m·n = 10¹⁰), the outer-product stream
is **partitioned by output-row ranges** chosen so each part's span×n
fits the key space (``sched.gplanner.row_partition``). Each part expands
with K1 (exact P: wide rows are chunked by the range planner, so nothing
needs a fallback), pads with sentinels, sorts, runs the merge epilogue
(K2), and the parts concatenate into one ``MergedCOO`` that is globally
row-major by construction.

A port of the JAX package's ``ops/gather_pipeline.py``: the host plan is
the same numpy code, so both packages run identical plans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from outerspace_tpu_torch.formats.csr import CSC, CSR
from outerspace_tpu_torch.ops.kernels.gexpand import (
    expand_gather,
    gather_plan_to_host,
    group_search_bits,
)
from outerspace_tpu_torch.ops.spgemm import (
    I32_MAX,
    MergedCOO,
    empty_csr,
    merge_biased_keys,
)
from outerspace_tpu_torch.perf.timer import span
from outerspace_tpu_torch.sched.gplanner import (
    WIDE_B_WIN,
    call_search_bits,
    padded_group_count,
    plan_gather_ranges,
    row_partition,
    slabbed_stream_len,
)


@dataclasses.dataclass
class GatherPart:
    row_base: int
    span: int
    b_win: int  # B-window blocks this part planned with
    ngroups: int
    p_out: int  # gather stream length
    p_real: int
    merge_pad: int  # merge stream length (gather stream + sentinel tail)
    nab8: int  # 8-block refs of the part's own A / B packs, before the
    nbb8: int  # zero blocks that pad the parts to one shape
    # per-slab-call owner-search depth (gplanner.call_search_bits),
    # common across the parts of one plan
    call_bits: tuple[int, ...]
    # K1's inputs on the plan's device: bases, table, a_pack, b_pack
    # (as ``gather_plan_to_host`` stages them) and group_bits
    dev: dict[str, torch.Tensor]


@dataclasses.dataclass
class GatherPipelinePlan:
    m: int
    n: int
    parts: list[GatherPart]

    @property
    def flops(self) -> int:
        return sum(p.p_real for p in self.parts)

    @property
    def padded_total(self) -> int:
        """Slots of the parts' merge streams (sentinel tails included)."""
        return sum(p.merge_pad for p in self.parts)


def _to_device(host: dict, call_bits, ngroups: int, device) -> dict[str, torch.Tensor]:
    """Copy staged host arrays to ``device`` (a ``spgemm.stage`` span)."""
    with span("spgemm.stage"):
        dev = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        dev["group_bits"] = torch.from_numpy(group_search_bits(call_bits, ngroups)).to(device)
    return dev


def plan_spgemm_gather(
    a_csc: CSC,
    b_csr: CSR,
    part_cap: int | None = None,
    device: str | torch.device = "cuda",
) -> GatherPipelinePlan:
    """Host planning: row partition + per-part gather plans + staging
    to ``device``. ``part_cap`` overrides the partitioner's perf-driven
    part limit (``gplanner.PART_CAP``)."""
    m, n = a_csc.shape[0], b_csr.shape[1]
    bounds = row_partition(a_csc, b_csr, part_cap=part_cap)
    nbv = b_csr.major_nnz().astype(np.int64)
    b_ptr = np.asarray(b_csr.indptr).astype(np.int64)
    b_cols_all = np.asarray(b_csr.indices)
    b_vals_all = np.asarray(b_csr.data)
    ks = np.nonzero(nbv > 0)[0].astype(np.int64)
    multi = len(bounds) > 2
    a_rows_all = np.asarray(a_csc.indices)
    a_k_all = np.repeat(
        np.arange(a_csc.shape[1], dtype=np.int64),
        a_csc.major_nnz().astype(np.int64),
    )
    row_of_flat = np.repeat(np.arange(nbv.shape[0], dtype=np.int64), nbv) if multi else None
    staged: list[tuple] = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        lo, hi = int(lo), int(hi)
        if multi:
            # Per-part COMPACTED B: only the k's with at least one
            # in-range A element keep their rows, laid out contiguously,
            # so out-of-range k's leave no jb gaps in the B windows.
            sel = (a_rows_all >= lo) & (a_rows_all < hi)
            ks_ref = np.unique(a_k_all[sel])
            ks_ref = ks_ref[nbv[ks_ref] > 0]
            if ks_ref.shape[0] == 0:
                continue
            nb_ref = nbv[ks_ref]
            jb_sub = np.zeros(ks_ref.shape[0], dtype=np.int64)
            np.cumsum(nb_ref[:-1], out=jb_sub[1:])
            keep_mask = np.zeros(nbv.shape[0], dtype=bool)
            keep_mask[ks_ref] = True
            flat_keep = np.nonzero(keep_mask[row_of_flat])[0]
            # the compacted jb advances ~1 position per product, so plan
            # with the wide window to keep subtiles ~full
            plan = plan_gather_ranges(
                a_csc, ks_ref, jb_sub, nb_ref,
                b_cols_all[flat_keep], b_vals_all[flat_keep], m, n,
                row_range=(lo, hi), row_base=lo, b_win=WIDE_B_WIN,
            )
        else:
            plan = plan_gather_ranges(
                a_csc, ks, b_ptr[ks], nbv[ks],
                b_cols_all, b_vals_all, m, n,
                row_base=lo,
            )
        if plan is not None:
            staged.append((lo, hi, plan))

    parts: list[GatherPart] = []
    if len(staged) > 1:
        # COMMONIZE the parts to one shape, as the JAX package does:
        # group counts round up to a slab granule (padding groups emit
        # pure sentinel, plen = 0), packs pad with zero blocks, and the
        # merge streams share one length (sentinels sort to the tail;
        # pad_count stays per-part exact).
        ngroups_pad = padded_group_count(max(p.ngroups for _, _, p in staged))
        stream_len = slabbed_stream_len(ngroups_pad)
        merge_pad = max(stream_len, 4096)
        nab8_pad = max(p.a_pack.shape[0] // 8 for _, _, p in staged)
        nbb8_pad = max(p.b_pack.shape[0] // 8 for _, _, p in staged)
        # common per-call search depth: the per-position width max over
        # parts (each part orders its groups width-descending)
        gw_max = np.ones(ngroups_pad, dtype=np.int64)
        for _, _, plan in staged:
            gw_max[: plan.ngroups] = np.maximum(
                gw_max[: plan.ngroups], plan.group_width
            )
        common_bits = call_search_bits(gw_max, ngroups_pad)
        for lo, hi, plan in staged:
            host = gather_plan_to_host(
                plan, ngroups_pad=ngroups_pad,
                nab8_pad=nab8_pad, nbb8_pad=nbb8_pad,
            )
            parts.append(
                GatherPart(
                    row_base=lo,
                    span=hi - lo,
                    b_win=plan.b_win,
                    ngroups=ngroups_pad,
                    p_out=stream_len,
                    p_real=plan.p_real,
                    merge_pad=merge_pad,
                    nab8=plan.a_pack.shape[0] // 8,
                    nbb8=plan.b_pack.shape[0] // 8,
                    call_bits=common_bits,
                    dev=_to_device(host, common_bits, ngroups_pad, device),
                )
            )
    elif staged:
        lo, hi, plan = staged[0]
        bits = call_search_bits(plan.group_width, plan.ngroups)
        parts.append(
            GatherPart(
                row_base=lo,
                span=hi - lo,
                b_win=plan.b_win,
                ngroups=plan.ngroups,
                p_out=plan.p_out,
                p_real=plan.p_real,
                merge_pad=max(plan.p_out, 4096),
                nab8=plan.a_pack.shape[0] // 8,
                nbb8=plan.b_pack.shape[0] // 8,
                call_bits=bits,
                dev=_to_device(gather_plan_to_host(plan), bits, plan.ngroups, device),
            )
        )
    return GatherPipelinePlan(m, n, parts)


def run_part(part: GatherPart, n_cols: int, sentinel_row: int):
    """One row part: K1 → sentinel pad to ``merge_pad`` (an ``expand``
    span) → sort → K2. Returns part-local (rows, cols, vals, valid,
    nnz)."""
    dev = part.dev
    with span("expand"):
        key, vals = expand_gather(
            dev["bases"], dev["table"], dev["a_pack"], dev["b_pack"],
            dev["group_bits"], b_win=part.b_win,
        )
        extra = part.merge_pad - key.shape[0]
        if extra:
            key = torch.cat([key, key.new_full((extra,), I32_MAX)])
            vals = torch.cat([vals, vals.new_zeros(extra)])
    return merge_biased_keys(
        key, vals, n_cols, sentinel_row, part.merge_pad - part.p_real
    )


def spgemm_gather_padded(plan: GatherPipelinePlan) -> MergedCOO:
    """Run all row parts in order and concatenate into one MergedCOO
    (the rows rebased and the parts joined in a ``merge`` span).
    Launches are asynchronous, so the parts queue back to back."""
    parts = [(p.row_base, run_part(p, plan.n, plan.m)) for p in plan.parts]
    with span("merge"):
        rows_l, cols_l, vals_l, valid_l, nnz = [], [], [], [], 0
        while parts:  # each part's local rows go once rebased
            row_base, (r, c, v, valid, pn) = parts.pop(0)
            rows_l.append(torch.where(valid, r + row_base, plan.m))
            cols_l.append(c)
            vals_l.append(v)
            valid_l.append(valid)
            nnz = nnz + pn
        return MergedCOO(
            (plan.m, plan.n),
            torch.cat(rows_l), torch.cat(cols_l), torch.cat(vals_l),
            torch.cat(valid_l), nnz,
        )


def spgemm_gather(a, b, device: str | torch.device = "cuda") -> CSR:
    """C = A @ B via the row-split windowed-gather pipeline."""
    a_csc = a if isinstance(a, CSC) else a.to_csc()
    b_csr = b if isinstance(b, CSR) else b.to_csr()
    with span("spgemm.plan"):
        plan = plan_spgemm_gather(a_csc, b_csr, device=device)
    if not plan.parts:  # no partial products
        return empty_csr(plan.m, plan.n)
    return spgemm_gather_padded(plan).to_csr()
