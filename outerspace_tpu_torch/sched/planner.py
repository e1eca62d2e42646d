"""Static task planning for the dense-tile expand (K3 / K4).

A numpy copy of the planner half of the JAX package's
``sched/planner.py``; both packages cut identical task tables from it.

- **Tile classes**: each outer index *k* goes to the dense
  (tile_a × 128) tile class with the fewest tasks whose padding stays
  under a waste limit; tall columns take tall tiles, short-but-wide ones
  (8 × 128), and the residue routes to the windowed-gather expand (K1).
- **Trim pass** (m·n ≤ 2³²): a residue row's 128-aligned B interior goes
  to the cheapest tile class, its partial edge blocks to the gather
  path, whenever the cost model (``sched.autotune``) says so.
- **Tasks**: each k in a class becomes a grid of (tile_a A-elements ×
  one 128-lane B block) tasks with sub/lane masks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from outerspace_tpu_torch.formats.csr import CSC, CSR

TILE_A = 8  # default sublane tile: A-elements per task
TILE_B = 128  # lane tile: B-elements per task
TILE_A_CLASSES = (128, 32, 8)  # tall-first tile classes


@dataclasses.dataclass
class OuterProductSchedule:
    """Task table for one dense-tile class.

    Task *t* computes the outer product of A-elements
    ``[a_start[t], a_start[t] + tile_a)`` (CSC flat order, masked to
    ``a_len[t]``) with the 128-lane block ``b_block[t]`` of the flat CSR
    arrays of B, masked to lanes ``[b_lo[t], b_hi[t])``.
    """

    tile_a: int
    # int32[ntasks] each:
    a_start: np.ndarray
    a_len: np.ndarray
    b_block: np.ndarray  # index into the B arrays viewed as (-1, 128)
    b_lo: np.ndarray
    b_hi: np.ndarray
    # A-side slices, shape (ntasks, tile_a):
    a_rows_t: np.ndarray  # int32 output row of each A element
    a_vals_t: np.ndarray  # f32
    # The outer indices this class covers:
    heavy_k: np.ndarray  # int32[]
    heavy_p: int  # true partial products in this class's stream

    @property
    def ntasks(self) -> int:
        return int(self.a_start.shape[0])

    @property
    def slab_tasks(self) -> int:
        """Tasks per slab (~2^20 stream elements), a multiple of 8. The
        JAX package calls its kernel once per slab; the port launches a
        class once, but pads its table the same way so both streams
        agree slot for slot."""
        s = max(1 << 20, self.tile_a * TILE_B) // (self.tile_a * TILE_B)
        return max(8, -(-s // 8) * 8)

    @property
    def slab_layout(self) -> list[tuple[int, int]]:
        """The table as (task_start, size) pieces: whole slabs plus a
        tail drawn from {slab, slab/2, slab/4}; tables smaller than
        slab/4 are one bucketed piece (``round_up_bucket``)."""
        if self.ntasks == 0:
            return []
        slab = self.slab_tasks
        granule = max(8, slab // 4)
        if self.ntasks < granule:
            from outerspace_tpu_torch.ops.symbolic import round_up_bucket

            size = -(-round_up_bucket(self.ntasks, min_size=8) // 8) * 8
            return [(0, size)]
        nfull = self.ntasks // slab
        layout = [(i * slab, slab) for i in range(nfull)]
        pos = nfull * slab
        rem_g = -(-(self.ntasks - pos) // granule)  # 0..4 granules
        if rem_g >= 4:  # the remainder rounds up to a whole slab
            layout.append((pos, slab))
            return layout
        if rem_g >= 2:
            layout.append((pos, 2 * granule))
            pos += 2 * granule
            rem_g -= 2
        if rem_g:
            layout.append((pos, granule))
        return layout

    @property
    def ntasks_padded(self) -> int:
        """Staged task count (empty padding tasks emit pure sentinel)."""
        layout = self.slab_layout
        if not layout:
            return 0
        s0, size = layout[-1]
        return s0 + size

    @property
    def padded_heavy(self) -> int:
        return self.ntasks_padded * self.tile_a * TILE_B


@dataclasses.dataclass
class ClassPlan:
    """One OuterProductSchedule per tile class plus the light-k residue
    the gather path serves.

    ``edge_k/edge_jb/edge_len``: flat-B ranges of *trimmed* k's — the
    partial first/last 128-blocks of B rows whose aligned interior went
    to a tile class; the gather path serves them exactly."""

    classes: list[OuterProductSchedule]
    light_k: np.ndarray
    light_p: int
    edge_k: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    edge_jb: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    edge_len: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )

    @property
    def heavy_p(self) -> int:
        return sum(c.heavy_p for c in self.classes)

    @property
    def padded_heavy(self) -> int:
        return sum(c.padded_heavy for c in self.classes)


def _schedule_for_ks(
    a_csc: CSC,
    b_csr: CSR,
    ks: np.ndarray,
    tile_a: int,
    b_start: np.ndarray | None = None,
    b_end: np.ndarray | None = None,
) -> OuterProductSchedule:
    """The task table for outer indices ``ks`` at tile height ``tile_a``.
    ``b_start``/``b_end`` (int64[len(ks)]) restrict each k to a sub-range
    of its flat B row (the trim pass's 128-aligned interiors)."""
    na = a_csc.major_nnz().astype(np.int64)
    nb = b_csr.major_nnz().astype(np.int64)
    a_ptr = np.asarray(a_csc.indptr)
    b_ptr = np.asarray(b_csr.indptr)
    empty_i = np.zeros(0, dtype=np.int32)
    if ks.shape[0] == 0:
        return OuterProductSchedule(
            tile_a, empty_i, empty_i, empty_i, empty_i, empty_i,
            np.zeros((0, tile_a), np.int32),
            np.zeros((0, tile_a), np.float32),
            ks.astype(np.int32), 0,
        )
    hk = ks.astype(np.int64)
    na_h = na[hk]
    nat_h = (-(-na_h // tile_a)).astype(np.int64)
    b_s = b_ptr[hk] if b_start is None else b_start.astype(np.int64)
    b_e = b_s + nb[hk] if b_end is None else b_end.astype(np.int64)
    nb_h = b_e - b_s
    b_blk0 = b_s // TILE_B
    nbt_h = (-(-(b_e - b_blk0 * TILE_B) // TILE_B)).astype(np.int64)

    tasks_per_k = nat_h * nbt_h
    t_off = np.zeros(hk.shape[0] + 1, dtype=np.int64)
    np.cumsum(tasks_per_k, out=t_off[1:])
    ntasks = int(t_off[-1])

    owner = np.repeat(np.arange(hk.shape[0]), tasks_per_k)
    local = np.arange(ntasks) - t_off[owner]
    # B-major within each k: consecutive tasks share one B block.
    ia = local % nat_h[owner]
    jb = local // nat_h[owner]

    a_start = (a_ptr[hk][owner] + ia * tile_a).astype(np.int64)
    a_len = np.minimum(na_h[owner] - ia * tile_a, tile_a).astype(np.int32)
    b_block = (b_blk0[owner] + jb).astype(np.int32)
    blk_lane0 = b_block.astype(np.int64) * TILE_B
    b_lo = np.maximum(b_s[owner] - blk_lane0, 0).astype(np.int32)
    b_hi = np.minimum(b_e[owner] - blk_lane0, TILE_B).astype(np.int32)

    gather_idx = a_start[:, None] + np.arange(tile_a)[None, :]
    gather_idx = np.minimum(gather_idx, max(a_ptr[-1] - 1, 0))
    a_rows_t = np.asarray(a_csc.indices)[gather_idx].astype(np.int32)
    a_vals_t = np.asarray(a_csc.data)[gather_idx].astype(np.float32)

    prod = (na_h * nb_h).sum()
    return OuterProductSchedule(
        tile_a,
        a_start.astype(np.int32),
        a_len,
        b_block,
        b_lo,
        b_hi,
        a_rows_t,
        a_vals_t,
        ks.astype(np.int32),
        int(prod),
    )


def trim_split(
    na: np.ndarray,
    nb: np.ndarray,
    b_mis: np.ndarray | int,
    candidates: np.ndarray,
    tile_a_classes: tuple[int, ...] = TILE_A_CLASSES,
):
    """The trim rule, shared by the planner and the autotuner: among
    ``candidates`` (boolean mask over outer indices), split each B row
    into its 128-aligned interior (cheapest tile class by
    ``autotune.tile_ns``) plus exact gather edges, whenever the model
    prices that below expanding the whole row through the gather path.
    ``b_mis`` is the flat-B row-start misalignment mod 128.

    Returns (do_trim, tile_ci, tile_part, edges)."""
    from outerspace_tpu_torch.sched.autotune import GATHER_NS, SORT_NS, tile_ns

    interior = np.maximum(
        (nb + b_mis) // TILE_B * TILE_B
        - ((b_mis + TILE_B - 1) // TILE_B) * TILE_B,
        0,
    )
    edges = np.where(interior > 0, nb - interior, nb)
    tile_part = tile_cost = None
    tile_ci = np.zeros(na.shape[0], dtype=np.int64)
    for ci, ta in enumerate(tile_a_classes):
        part = (-(-na // ta)) * ta * interior
        cost = part * (tile_ns(ta) + SORT_NS)
        if tile_part is None:
            tile_part, tile_cost = part, cost
        else:
            better = cost < tile_cost
            tile_part = np.where(better, part, tile_part)
            tile_cost = np.where(better, cost, tile_cost)
            tile_ci = np.where(better, ci, tile_ci)
    cost_trim = tile_cost + na * edges * (GATHER_NS + SORT_NS)
    cost_gather = na * nb * (GATHER_NS + SORT_NS)
    do_trim = candidates & (interior > 0) & (cost_trim < cost_gather)
    return do_trim, tile_ci, tile_part, edges


def plan_outer_classes(
    a_csc: CSC,
    b_csr: CSR,
    waste_limit: float = 1.1,
    tile_a_classes: tuple[int, ...] = TILE_A_CLASSES,
    rescue_limit: float = 6.0,
    gather_max_nb: int = 256,
    gather_edges: bool | None = None,
) -> ClassPlan:
    """Assign every outer index to the tile class with the fewest tasks
    whose padding stays under ``waste_limit``; the rest is the light
    residue.

    Second pass, ``gather_edges`` (default when m·n ≤ 2³², the gather
    kernel's packed-key space): residue k's are trimmed (see
    :func:`trim_split`), and every other light k goes to the gather
    path. Without it (m·n > 2³²): the *rescue* pass — wide-B-row residue
    takes its least-padding whole-row class up to ``rescue_limit``,
    since the flat path is the only alternative."""
    na = a_csc.major_nnz().astype(np.int64)
    nb = b_csr.major_nnz().astype(np.int64)
    if gather_edges is None:
        gather_edges = a_csc.shape[0] * b_csr.shape[1] <= 2**32
    prod = na * nb
    nonzero = prod > 0
    # Tall classes first: the fewest tasks within the waste limit.
    best_class = np.full(na.shape[0], -1, dtype=np.int64)
    for ci, ta in enumerate(tile_a_classes):
        padded = (-(-na // ta)) * ta * (-(-nb // TILE_B)) * TILE_B
        ok = nonzero & (padded <= waste_limit * prod) & (best_class < 0)
        best_class[ok] = ci
    trim_class = np.full(na.shape[0], -1, dtype=np.int64)
    b_ptr = np.asarray(b_csr.indptr).astype(np.int64)
    b_s = b_ptr[:-1]
    b_e = b_s + nb
    if gather_edges:
        do_trim, tile_ci, _, _ = trim_split(
            na, nb, b_s % TILE_B, nonzero & (best_class < 0), tile_a_classes,
        )
        trim_class[do_trim] = tile_ci[do_trim]
    else:
        need_rescue = nonzero & (best_class < 0) & (nb > gather_max_nb)
        if need_rescue.any():
            best_pad = np.full(na.shape[0], np.iinfo(np.int64).max)
            best_ci = np.zeros(na.shape[0], dtype=np.int64)
            for ci, ta in enumerate(tile_a_classes):
                padded = (-(-na // ta)) * ta * (-(-nb // TILE_B)) * TILE_B
                better = padded < best_pad
                best_pad = np.where(better, padded, best_pad)
                best_ci = np.where(better, ci, best_ci)
            ok = need_rescue & (best_pad <= rescue_limit * prod)
            best_class[ok] = best_ci[ok]
    classes = []
    for ci, ta in enumerate(tile_a_classes):
        ks_full = np.nonzero(best_class == ci)[0]
        ks_trim = np.nonzero(trim_class == ci)[0]
        if ks_trim.shape[0]:
            ks = np.concatenate([ks_full, ks_trim])
            bs = np.concatenate(
                [b_s[ks_full], (-(-b_s[ks_trim] // TILE_B)) * TILE_B]
            )
            be = np.concatenate([b_e[ks_full], (b_e[ks_trim] // TILE_B) * TILE_B])
            classes.append(_schedule_for_ks(a_csc, b_csr, ks, ta, b_start=bs, b_end=be))
        else:
            classes.append(_schedule_for_ks(a_csc, b_csr, ks_full, ta))
    light_k = np.nonzero(nonzero & (best_class < 0) & (trim_class < 0))[0].astype(np.int32)
    light_p = int(prod[light_k].sum()) if light_k.shape[0] else 0
    # Edge ranges of the trimmed k's (head before the aligned interior,
    # tail after it), each ≤ TILE_B-1 elements.
    tk = np.nonzero(trim_class >= 0)[0]
    if tk.shape[0]:
        head_len = (-(-b_s[tk] // TILE_B)) * TILE_B - b_s[tk]
        tail_jb = (b_e[tk] // TILE_B) * TILE_B
        tail_len = b_e[tk] - tail_jb
        ek = np.concatenate([tk, tk])
        ejb = np.concatenate([b_s[tk], tail_jb])
        elen = np.concatenate([head_len, tail_len])
        keep = elen > 0
        ek, ejb, elen = ek[keep], ejb[keep], elen[keep]
    else:
        ek = np.zeros(0, np.int64)
        ejb = np.zeros(0, np.int64)
        elen = np.zeros(0, np.int64)
    return ClassPlan(classes, light_k, light_p, ek, ejb, elen)


def choose_strategy(a_csc: CSC, b_csr: CSR) -> str:
    """The expand strategy for these operands, by the cost model
    (``sched.autotune.autotune``): "tiles" (dense-tile expand on heavy
    k's beside a gather residue), "gather" (pure windowed gather with
    row-split packed keys; any m·n) or "flat" (one flat expand)."""
    from outerspace_tpu_torch.sched.autotune import autotune

    return autotune(a_csc, b_csr)[0]
