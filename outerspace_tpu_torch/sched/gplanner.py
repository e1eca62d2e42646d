"""Host planner for the windowed-gather expand kernel (K1,
``ops.kernels.gexpand``).

A numpy copy of the JAX package's ``sched/gplanner.py``, so both packages
build identical plans from the same operands. The expansion stream visits
B's flat arrays almost monotonically: within any window of ~1024
consecutive partial products, the B elements touched span only ~100-300
consecutive flat positions, and the owning A-elements span ~100. So the
expansion runs as *windowed* gathers: each 1024-product subtile reads one
small aligned A-window and one small aligned B-window.

This planner cuts the element stream into subtiles subject to three
monotone window constraints (products, B-span, A-span), packs 8 subtiles
per group under super-window constraints, and stages the field-stacked
arrays the kernel reads. The subtile cuts and group packing run the
native C++ core (``csrc/gplan.cpp``, built with g++ at first use); the
Python loops ``_cut_subtiles_loop`` / ``_pack_groups_loop`` are their
definition, which the tests hold the core to bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SUB_P = 1024  # products per subtile
GROUP_SUBS = 8  # subtiles per group
# groups per slab call of the JAX package's kernel; the plans keep its
# slab layout (group counts, search depths) so both packages agree
GROUP_SLAB = 128
A_WIN = 2  # A-window blocks per subtile (256 candidates)
# Default B-window blocks per subtile (384 lanes). Plans may override
# per call: the row-split pipeline's per-part COMPACTED B makes a full
# 1024-product ER subtile span ~300-400 compact positions, so it plans
# with b_win=5 (WIDE_B_WIN) to keep subtiles ~full; the tiled
# strategy's skewed residue keeps 3 (its per-k clustering makes spans
# tiny).
B_WIN = 3
WIDE_B_WIN = 5
# Super-window refs (8 blocks each) per group, per side (the kernel is
# generic over both counts). B holds GROUP_SUBS fat subtiles
# × ~3 blocks each plus the widest window: 5 refs = 40 blocks.
SUPER_A = 3
SUPER_B = 5
SUPER = SUPER_A  # back-compat alias (A-side)
_BLK = 128


@dataclasses.dataclass
class GatherPlan:
    """Device-shippable plan for one gexpand call."""

    m: int
    n: int
    b_win: int  # per-subtile B-window blocks (selects the kernel variant)
    ngroups: int
    p_out: int  # output stream length = nsubtiles * SUB_P
    p_real: int  # true products covered (rest sentinel-padded)
    # A side, field-stacked (NAB, 4, 128) int32:
    #   [a_rows, a_val_bits, jb, cumprod]
    a_pack: np.ndarray
    # B side, field-stacked (NBB, 2, 128) int32: [b_cols, b_val_bits]
    b_pack: np.ndarray
    # per-group window bases (ngroups, 2): [a_base8, b_base8]
    bases: np.ndarray
    # per-group table (ngroups, 8, 128) int32; per subtile s lanes:
    #   [0]=r_a (A-window block, rel. to a_base8*8), [1]=r_b (B-window
    #   block), [2]=p0 (absolute product index of subtile start),
    #   [3]=plen, [5]=n_cols (host-staged broadcast), [6]=anchor
    #   element's offset within the A-window (the shallow-search base)
    table: np.ndarray
    # per-group max owner-span width (search candidates needed); padding
    # groups carry 1. Host-side data: selects the per-call search
    # depth (``call_search_bits``).
    group_width: np.ndarray | None = None


def group_slab_layout(ngroups: int) -> list[tuple[int, int]]:
    """Kernel calls as (group_start, call_size) over a (possibly padded)
    group count: whole ``GROUP_SLAB`` slabs + coarse tails from the
    fixed set {slab/2, slab/4}, or one bucketed call for small plans.
    Deterministic from the padded total, so the device loop can derive
    the same layout from ``plan.ngroups`` alone."""
    if ngroups <= 0:
        return []
    granule = GROUP_SLAB // 4
    if ngroups < granule:
        from outerspace_tpu_torch.ops.symbolic import round_up_bucket

        return [(0, round_up_bucket(ngroups, min_size=1))]
    full = ngroups // GROUP_SLAB
    layout = [(i * GROUP_SLAB, GROUP_SLAB) for i in range(full)]
    pos = full * GROUP_SLAB
    rem_g = -(-(ngroups - pos) // granule)  # 0..4 granules
    if rem_g >= 4:
        layout.append((pos, GROUP_SLAB))
        return layout
    if rem_g >= 2:
        layout.append((pos, 2 * granule))
        pos += 2 * granule
        rem_g -= 2
    if rem_g:
        layout.append((pos, granule))
    return layout


def padded_group_count(ngroups: int) -> int:
    """Smallest layout-exact group count ≥ ``ngroups``: a count whose
    :func:`group_slab_layout` covers exactly that many groups (granule
    multiples, or the small-plan bucket). The gather pipeline's part
    commonization pads to this so planner tables and the kernel's
    derived layout agree by construction."""
    granule = GROUP_SLAB // 4
    if ngroups >= granule:
        return -(-ngroups // granule) * granule
    from outerspace_tpu_torch.ops.symbolic import round_up_bucket

    return round_up_bucket(max(ngroups, 1), min_size=1)


def call_search_bits(
    group_width: np.ndarray | None, ngroups: int
) -> tuple[int, ...]:
    """Per-slab-call owner-search depth for :func:`group_slab_layout`'s
    calls: the smallest kernel variant whose ``2**bits`` anchored
    candidate range covers every subtile owner-span in the call.
    Depths are bounded to {4, 6, 8} bits (8 = the full-window search
    from offset 0; 4/6 search from the anchor offset in table lane 6). ``None`` widths
    (plans predating the metadata) degrade to all-8."""
    out = []
    for g0, size in group_slab_layout(ngroups):
        if group_width is None:
            out.append(8)
            continue
        w = int(group_width[g0 : g0 + size].max(initial=1))
        out.append(4 if w <= 16 else (6 if w <= 64 else 8))
    return tuple(out)


def slabbed_stream_len(ngroups: int) -> int:
    """Output stream length (products incl. sentinel slots) of the slab
    layout for ``ngroups`` — the single source of truth for sizing the
    merge stream that consumes :func:`group_slab_layout`'s calls."""
    return (
        sum(size for _, size in group_slab_layout(ngroups))
        * GROUP_SUBS * SUB_P
    )


def _gplan_library():
    """The native planner core (``csrc/gplan.cpp``), built with g++ at
    first use; a failed build raises."""
    import ctypes

    from outerspace_tpu_torch.runtime.build import host_library

    lib = host_library("gplan")
    ll, pll = ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)
    lib.osp_plan_subtiles.argtypes = [pll, pll, pll, *[ll] * 6, pll, pll, pll]
    lib.osp_plan_subtiles.restype = ll
    lib.osp_pack_groups.argtypes = [pll, pll, *[ll] * 6, ctypes.POINTER(ctypes.c_int32)]
    lib.osp_pack_groups.restype = ll
    return lib


def _ptr(a: np.ndarray, ctype):
    import ctypes

    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _cut_subtiles(cum, jb, jend, b_win: int):
    """Greedy product-space subtile cuts: (p0, owners, b_anchors) int64
    arrays, by the native core (rolling pointers, O(nk + nsub)). Where a
    plan would overflow the core's output capacity (the core returns
    -1), :func:`_cut_subtiles_loop`, the definition, cuts it."""
    import ctypes

    nk = jb.shape[0]
    # capacity covers every realistic plan (full subtiles + window cuts)
    cap = int(cum[-1]) // SUB_P + 4 * nk + 1024
    out = [np.empty(cap, np.int64) for _ in range(3)]
    arrs = [np.ascontiguousarray(a, np.int64) for a in (cum, jb, jend)]
    ll = ctypes.c_longlong
    nsub = _gplan_library().osp_plan_subtiles(
        *(_ptr(a, ll) for a in arrs), nk, b_win, A_WIN, SUB_P, _BLK, cap,
        *(_ptr(a, ll) for a in out),
    )
    if nsub == -1:
        return _cut_subtiles_loop(cum, jb, jend, b_win)
    if nsub < 0:
        raise ValueError(f"osp_plan_subtiles rejected its inputs ({nsub})")
    return tuple(a[:nsub].copy() for a in out)


def _cut_subtiles_loop(cum, jb, jend, b_win: int):
    """The definition of :func:`_cut_subtiles`: one Python iteration per
    subtile (~P/1024)."""
    nk = jb.shape[0]
    p_real = int(cum[-1])
    starts_p, owner_l, banchor_l = [], [], []
    p = 0
    while p < p_real:
        s = int(np.searchsorted(cum, p, side="right")) - 1
        # anchor at the OWNER ELEMENT's row-start block (not the
        # mid-element position): anchors stay monotone across same-k
        # element runs (which restart at the k's jb), the window covers
        # both the continuation of s and every following element's rows
        # from below, and each cut is lossless — a B-bound cut includes
        # the violating element's prefix up to the window edge and the
        # next subtile re-anchors exactly there
        anchor_blk = int(jb[s]) // _BLK
        limit_b = (anchor_blk + b_win) * _BLK
        # first element whose row end exceeds the B-window (jend is
        # non-decreasing: ranges are sorted and same-k repeats share
        # (jb, nb)); its prefix up to the window edge is includable
        f = int(np.searchsorted(jend, limit_b, side="right"))
        if f < nk:
            q_b = int(cum[f]) + max(0, limit_b - int(jb[f]))
        else:
            q_b = p_real
        # first element outside the A-window (256 elements from the
        # block floor of the owner)
        ea = (s // _BLK + A_WIN) * _BLK
        q_a = int(cum[ea]) if ea < nk else p_real
        q = min(p + SUB_P, q_b, q_a, p_real)
        assert q > p
        starts_p.append(p)
        owner_l.append(s)
        banchor_l.append(anchor_blk)
        p = q
    return (
        np.asarray(starts_p, dtype=np.int64),
        np.asarray(owner_l, dtype=np.int64),
        np.asarray(banchor_l, dtype=np.int64),
    )


def _pack_groups(a_blk, b_blk, b_win: int) -> list[list[int]]:
    """Pack consecutive subtiles into ≤``GROUP_SUBS`` groups sharing
    super-windows anchored at each group's FIRST subtile, by the native
    core; :func:`_pack_groups_loop` is the definition."""
    import ctypes

    nsub = a_blk.shape[0]
    if nsub == 0:
        return []
    gid = np.empty(nsub, np.int32)
    ll = ctypes.c_longlong
    ng = _gplan_library().osp_pack_groups(
        _ptr(np.ascontiguousarray(a_blk, np.int64), ll),
        _ptr(np.ascontiguousarray(b_blk, np.int64), ll),
        nsub, b_win, A_WIN, GROUP_SUBS, SUPER_A, SUPER_B, _ptr(gid, ctypes.c_int32),
    )
    bounds = np.searchsorted(gid, np.arange(1, ng, dtype=np.int32))
    return [list(g) for g in np.split(np.arange(nsub), bounds)]


def _pack_groups_loop(a_blk, b_blk, b_win: int) -> list[list[int]]:
    """The definition of :func:`_pack_groups`: B anchors must not dip
    below the first subtile's base (product-space cuts make them locally
    non-monotone)."""
    nsub = a_blk.shape[0]
    groups: list[list[int]] = []
    cur: list[int] = []
    a_lo = b_lo = 0
    for t in range(nsub):
        al, bl = int(a_blk[t]), int(b_blk[t])
        if cur:
            a0, b0 = a_lo, b_lo
            fits = (
                len(cur) < GROUP_SUBS
                and al + A_WIN <= (a0 // 8) * 8 + 8 * SUPER_A
                and bl + b_win <= (b0 // 8) * 8 + 8 * SUPER_B
                # product-space cuts make B anchors non-monotone (a
                # mid-element start in a later A-element of the same k
                # re-anchors back at that k's row): the ref base is the
                # FIRST subtile's, so later subtiles must not anchor
                # below it
                and bl >= (b0 // 8) * 8
            )
            if not fits:
                groups.append(cur)
                cur = []
        if not cur:
            a_lo, b_lo = al, bl
        cur.append(t)
    if cur:
        groups.append(cur)
    return groups


def plan_gather(
    a_rows: np.ndarray,  # int32[nA] output row per kept element
    a_vals: np.ndarray,  # f32[nA]
    jb: np.ndarray,  # int64[nA] flat B start per element
    nb: np.ndarray,  # int64[nA] B-row length per element
    b_cols: np.ndarray,
    b_vals: np.ndarray,
    m: int,
    n: int,
    b_win: int = B_WIN,
) -> tuple[GatherPlan | None, np.ndarray]:
    """Build the gather plan. Returns (plan, fallback_mask) where
    fallback_mask marks input elements the windows cannot serve.
    ``b_win`` is the per-subtile B-window in 128-blocks (≤ SUPER_B·8
    minus packing slack); it is recorded on the plan."""
    nA = a_rows.shape[0]
    nb = nb.astype(np.int64)
    jb = jb.astype(np.int64)
    # Window-servable elements: nonzero products, B row fits a subtile
    # window with room for alignment slack.
    ok = (nb > 0) & (nb <= (b_win - 1) * _BLK)
    fallback = ~ok & (nb > 0)
    if not ok.any():
        return None, fallback
    a_rows = a_rows[ok].astype(np.int32)
    a_vals = a_vals[ok].astype(np.float32)
    jb = jb[ok]
    nb = nb[ok]
    nk = a_rows.shape[0]
    jend = jb + nb  # monotone: jb = b_indptr[k] rows, full rows
    cum = np.zeros(nk + 1, dtype=np.int64)
    np.cumsum(nb, out=cum[1:])
    p_real = int(cum[-1])

    # --- greedy cuts in PRODUCT space: ~P/1024 iterations ---
    # Subtiles cut at product granularity, not element granularity: a
    # cut may land mid-element (the element's remaining products carry
    # into the next subtile, re-anchored at its current flat-B
    # position), and the first element whose row end exceeds the
    # B-window still contributes its prefix up to the window edge. The
    # kernel's owner search supports any consistent (window, p0, plen)
    # table.
    p0, owners, b_anchor = _cut_subtiles(cum, jb, jend, b_win)
    nsub = p0.shape[0]
    a_blk = owners // _BLK
    b_blk = b_anchor  # already int64 from _cut_subtiles
    plen = np.concatenate([p0[1:], [p_real]]) - p0
    assert int(plen.max(initial=0)) <= SUB_P
    # Anchored-search metadata: the anchor element's offset within the
    # A-window (table lane 6) and each subtile's owner-span width — the
    # number of candidates the kernel's binary search must cover, so
    # groups whose subtiles all span few owners run a shallower search
    # (see ``call_search_bits``).
    aoff = owners - a_blk * _BLK  # anchor offset in window, ∈ [0, 128)
    lasts = np.searchsorted(cum, p0 + plen - 1, side="right") - 1
    widths = lasts - owners + 1  # owner-span per subtile, ≥ 1

    # --- group packing: 8 subtiles sharing 24-block super-windows ---
    groups = _pack_groups(a_blk, b_blk, b_win)
    # Order groups by descending owner-span width: group order is free
    # (the output stream feeds a sort), and clustering wide groups at
    # the front lets the slab layout's per-call max width classify most
    # calls as shallow-search even when a few subtiles span many owners
    # (power-law operands cluster light elements).
    # Flatten the group structure once: per-subtile (group, slot) indices
    # let every table fill below be one fancy-indexed assignment.
    glen = np.fromiter((len(g) for g in groups), dtype=np.int64,
                       count=len(groups))
    goff = np.zeros(len(groups) + 1, dtype=np.int64)
    np.cumsum(glen, out=goff[1:])
    flat_t = np.fromiter(
        (t for g in groups for t in g), dtype=np.int64, count=int(goff[-1])
    )
    gw = np.maximum.reduceat(widths[flat_t], goff[:-1])
    order_g = np.argsort(-gw, kind="stable")
    groups = [groups[i] for i in order_g]
    gw = gw[order_g]
    glen = glen[order_g]
    # re-flatten in the new group order
    flat_t = np.fromiter(
        (t for g in groups for t in g), dtype=np.int64, count=int(goff[-1])
    )
    np.cumsum(glen, out=goff[1:])
    flat_gi = np.repeat(np.arange(len(groups), dtype=np.int64), glen)
    flat_si = np.arange(int(goff[-1]), dtype=np.int64) - goff[flat_gi]
    # Pad the group count to the coarse slab layout (whole GROUP_SLAB
    # slabs + {slab/2, slab/4} tails from a fixed shape set — empty
    # groups emit pure sentinel padding). Small plans use one bucketed
    # call.
    ngroups = sum(size for _, size in group_slab_layout(len(groups)))

    from outerspace_tpu_torch.ops.symbolic import round_up_bucket

    # --- stage device arrays ---
    def _pack_fields(fields, blocks_pad):
        k = len(fields)
        out = np.zeros((blocks_pad, k, _BLK), dtype=np.int32)
        for fi, (arr, fill) in enumerate(fields):
            # fill the strided field view in place: whole blocks as one
            # reshaped assignment, then the partial tail block — no
            # npad-sized temp per field
            f = out[:, fi, :]
            na = arr.shape[0]
            nfull = na // _BLK
            f[:nfull] = arr[: nfull * _BLK].reshape(nfull, _BLK)
            rem = na - nfull * _BLK
            if rem:
                f[nfull, :rem] = arr[nfull * _BLK :]
            if fill != 0:
                if rem:
                    f[nfull, rem:] = fill
                    f[nfull + 1 :] = fill
                else:
                    f[nfull:] = fill
        return out

    # cumprod per candidate: strictly increasing; pad with p_real so
    # out-of-range candidates never win the owner search.
    if p_real >= 2**31:
        raise ValueError("gather plan exceeds int32 product space")
    cum32 = cum[:nk].astype(np.int32)
    nab = -(-nk // _BLK) + (8 * SUPER)  # slack so base8+2 refs stay in range
    nab = round_up_bucket(-(-nab // 8) * 8, min_size=8)
    nab = -(-nab // 8) * 8  # bucketed block count
    a_pack = _pack_fields(
        [
            (a_rows, 0),
            (a_vals.view(np.int32), 0),
            (jb.astype(np.int32), int(min(jb[-1], 2**31 - 1))),
            (cum32, p_real),
        ],
        nab,
    )
    nnz_b = b_cols.shape[0]
    nbb = -(-nnz_b // _BLK) + (8 * SUPER_B)
    nbb = round_up_bucket(-(-nbb // 8) * 8, min_size=8)
    nbb = -(-nbb // 8) * 8
    # asarray: no copy when the caller already holds the right dtypes
    b_pack = _pack_fields(
        [
            (np.asarray(b_cols, np.int32), 0),
            (np.asarray(b_vals, np.float32).view(np.int32), 0),
        ],
        nbb,
    )

    bases = np.zeros((ngroups, 2), dtype=np.int32)
    table = np.zeros((ngroups, GROUP_SUBS, _BLK), dtype=np.int32)
    first_t = flat_t[goff[:-1]]  # each group's first subtile
    a_base8 = a_blk[first_t] // 8
    b_base8 = b_blk[first_t] // 8
    bases[: len(groups), 0] = a_base8
    bases[: len(groups), 1] = b_base8
    table[flat_gi, flat_si, 0] = a_blk[flat_t] - a_base8[flat_gi] * 8
    table[flat_gi, flat_si, 1] = b_blk[flat_t] - b_base8[flat_gi] * 8
    table[flat_gi, flat_si, 2] = p0[flat_t]
    table[flat_gi, flat_si, 3] = plen[flat_t]
    table[flat_gi, flat_si, 6] = aoff[flat_t]
    group_width = np.ones(ngroups, dtype=np.int32)
    group_width[: len(groups)] = gw

    plan = GatherPlan(
        m=m,
        n=n,
        b_win=b_win,
        ngroups=ngroups,
        p_out=ngroups * GROUP_SUBS * SUB_P,
        p_real=p_real,
        a_pack=a_pack,
        b_pack=b_pack,
        bases=bases,
        table=table,
        group_width=group_width,
    )
    return plan, fallback


def plan_gather_ranges(
    a_csc,
    ranges_k: np.ndarray,  # int64[nr] outer index of each range
    ranges_jb: np.ndarray,  # int64[nr] flat-B start of each range
    ranges_len: np.ndarray,  # int64[nr] range length (>0)
    b_cols: np.ndarray,
    b_vals: np.ndarray,
    m: int,
    n: int,
    chunk: int | None = None,
    row_range: tuple[int, int] | None = None,
    row_base: int = 0,
    b_win: int = B_WIN,
) -> GatherPlan | None:
    """Gather-plan arbitrary per-k flat-B ranges.

    Each range (k, jb, len) is chunked to ≤``chunk`` (the kernel's
    B-window bound) and crossed with every A-element of column k, so the
    gather path serves *any* residue exactly — whole light rows, wide
    rows (chunked), and the partial edge blocks of trimmed rows — with
    no fallback. All construction is vectorised; ranges are re-sorted by
    ``jb`` to satisfy the planner's monotone-window requirement.

    ``row_range``/``row_base``: restrict to A-elements whose output row
    lies in [lo, hi) and rebase rows by ``row_base`` (the row-split
    pipeline's packed-key contract, as in :func:`plan_gather_from_csr`).
    """
    nr = ranges_k.shape[0]
    if nr == 0:
        return None
    if chunk is None:
        chunk = (b_win - 1) * _BLK
    order = np.argsort(ranges_jb, kind="stable")
    rk = ranges_k[order].astype(np.int64)
    rjb = ranges_jb[order].astype(np.int64)
    rlen = ranges_len[order].astype(np.int64)
    # The downstream plan_gather searchsorted needs the per-chunk jb
    # stream monotone, which sorting range *starts* only guarantees for
    # disjoint ranges. Every current caller passes non-overlapping
    # flat-B ranges; fail loudly rather than mis-window if that changes.
    if nr > 1 and not (rjb[1:] >= rjb[:-1] + rlen[:-1]).all():
        raise ValueError(
            "plan_gather_ranges requires disjoint flat-B ranges "
            "(overlap would break the monotone-window invariant)"
        )
    na = a_csc.major_nnz().astype(np.int64)
    a_ptr = np.asarray(a_csc.indptr).astype(np.int64)

    # ranges → chunks
    nchunks = -(-rlen // chunk)
    coff = np.zeros(nr + 1, dtype=np.int64)
    np.cumsum(nchunks, out=coff[1:])
    nc = int(coff[-1])
    c_owner = np.repeat(np.arange(nr, dtype=np.int64), nchunks)
    c_i = np.arange(nc, dtype=np.int64) - coff[c_owner]
    c_jb = rjb[c_owner] + c_i * chunk
    c_len = np.minimum(chunk, rlen[c_owner] - c_i * chunk)
    c_k = rk[c_owner]

    # chunks × A-elements of k
    c_na = na[c_k]
    eoff = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(c_na, out=eoff[1:])
    ne = int(eoff[-1])
    e_owner = np.repeat(np.arange(nc, dtype=np.int64), c_na)
    within = np.arange(ne, dtype=np.int64) - eoff[e_owner]
    a_idx = a_ptr[c_k[e_owner]] + within
    a_rows = np.asarray(a_csc.indices)[a_idx].astype(np.int32)
    e_jb = c_jb[e_owner]
    e_len = c_len[e_owner]
    if row_range is not None:
        lo, hi = row_range
        keep = (a_rows >= lo) & (a_rows < hi)
        a_idx, a_rows = a_idx[keep], a_rows[keep]
        e_jb, e_len = e_jb[keep], e_len[keep]
        if a_rows.shape[0] == 0:
            return None
    if row_base:
        a_rows = a_rows - np.int32(row_base)
    plan, fb = plan_gather(
        a_rows,
        np.asarray(a_csc.data)[a_idx].astype(np.float32),
        e_jb,
        e_len,
        b_cols,
        b_vals,
        m,
        n,
        b_win=b_win,
    )
    assert not fb.any(), "chunked ranges must be window-servable"
    return plan


def plan_gather_from_csr(
    a_csc, b_csr, k_subset=None, row_range=None, row_base: int = 0
):
    """Convenience: build a GatherPlan for C = A@B (optionally restricted
    to outer indices ``k_subset`` and/or output rows in ``row_range``);
    ``row_base`` is subtracted from every row so packed keys stay within
    uint32 for row-split pipelines. Returns (plan, fallback_element_plan)
    where the second item is an ExpansionPlan for the fallback elements
    (row-rebased the same way; None when all elements are servable)."""
    from outerspace_tpu_torch.ops.symbolic import expansion_plan, expansion_plan_subset

    if k_subset is None:
        ep = expansion_plan(a_csc, b_csr)
    else:
        ep = expansion_plan_subset(a_csc, b_csr, k_subset)
    if row_range is not None:
        lo, hi = row_range
        rows = np.asarray(ep.a_rows)
        ep = _element_subset(ep, np.nonzero((rows >= lo) & (rows < hi))[0])
    if row_base:
        import dataclasses as _dc

        ep = _dc.replace(ep, a_rows=np.asarray(ep.a_rows) - row_base)
    nb = np.diff(ep.offsets)
    jb = np.asarray(ep.b_indptr)[ep.a_k]
    plan, fb = plan_gather(
        np.asarray(ep.a_rows),
        np.asarray(ep.a_vals),
        jb,
        nb,
        np.asarray(ep.b_cols),
        np.asarray(ep.b_vals),
        ep.m,
        ep.n,
    )
    fb_plan = _element_subset(ep, np.nonzero(fb)[0]) if fb.any() else None
    return plan, fb_plan


def _element_subset(ep, keep):
    """ExpansionPlan restricted to A-nonzero indices ``keep``."""
    import dataclasses as _dc

    nb = np.diff(ep.offsets)
    counts = nb[keep]
    offs = np.zeros(keep.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    return _dc.replace(
        ep,
        a_rows=np.asarray(ep.a_rows)[keep],
        a_vals=np.asarray(ep.a_vals)[keep],
        a_k=np.asarray(ep.a_k)[keep],
        offsets=offs,
    )


PART_CAP = 64  # max perf-driven row parts (key-space needs may exceed it)


def perf_part_count(
    total: float,
    max_part_products: int = 7 << 19,
    part_cap: int | None = None,
) -> int:
    """Perf-driven part count for a product stream — the same rule
    :func:`row_partition` applies (key-space needs may add parts on
    top)."""
    cap = PART_CAP if part_cap is None else part_cap
    if max_part_products and total > 1.5 * max_part_products:
        return int(min(cap, np.ceil(total / max_part_products)))
    return 1


def row_partition(
    a_csc, b_csr, key_space: int = 2**32,
    max_part_products: int = 7 << 19,
    part_cap: int | None = None,
) -> np.ndarray:
    """Output-row range boundaries such that each part's rows_span × n
    fits the packed-uint32 key space, product-balanced across parts.
    Returns int64[nparts+1] row bounds.

    Beyond the key-space requirement, large streams split further so
    each part's merge sorts ≲ ``max_part_products`` pairs (capped at
    ``PART_CAP`` parts). The ~3.7M default is the JAX package's, kept
    so both packages partition alike; it was tuned for the TPU's sort
    and is not yet re-measured for this card. Parts are contiguous
    output-row ranges = disjoint key ranges, so concatenating per-part
    merges IS the global merge."""
    m, n = a_csc.shape[0], b_csr.shape[1]
    # per-row product counts: sum over A nonzeros in that row of nnz_B(k)
    nb_per_k = b_csr.major_nnz().astype(np.int64)
    a_k = np.repeat(
        np.arange(a_csc.shape[1], dtype=np.int64),
        a_csc.major_nnz().astype(np.int64),
    )
    per_row = np.bincount(
        np.asarray(a_csc.indices, dtype=np.int64),
        weights=nb_per_k[a_k].astype(np.float64),
        minlength=m,
    )
    total = float(per_row.sum())
    perf_parts = perf_part_count(total, max_part_products, part_cap)
    if m * n <= key_space and perf_parts <= 1:
        return np.array([0, m], dtype=np.int64)
    max_span = max(key_space // max(n, 1), 1) if m * n > key_space else m
    cum = np.concatenate([[0.0], np.cumsum(per_row)])
    nparts = max(
        int(-(-(m) // max_span)),
        int(np.ceil(m * n / key_space)),
        perf_parts,
    )
    bounds = [0]
    for p in range(1, nparts):
        target = cum[-1] * p / nparts
        r = int(np.searchsorted(cum, target))
        r = min(max(r, bounds[-1] + 1), bounds[-1] + max_span)
        bounds.append(min(r, m))
    bounds.append(m)
    # enforce span cap strictly (balance is secondary)
    out = [0]
    for b in bounds[1:]:
        while b - out[-1] > max_span:
            out.append(out[-1] + max_span)
        if b > out[-1]:
            out.append(b)
    if out[-1] != m:
        out.append(m)
    return np.asarray(out, dtype=np.int64)
