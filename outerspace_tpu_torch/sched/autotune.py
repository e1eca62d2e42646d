"""Cost-model autotuning: the tile waste limit per operand pair, from a
per-element cost model over the operands' degree distributions (host
numpy, no device work).

A copy of the JAX package's ``sched/autotune.py``. Its weights are the
JAX planner's and are kept only so that both packages cut the same
plans: ``plan_tiled`` takes its default waste limit from
:func:`best_waste_limit`, and ``sched.planner.trim_split`` picks a
trimmed row's tile class with :func:`tile_ns`. They are relative weights in the
planner's own units, not times of any kernel of this port, and they are
no measurement of the H100. Recalibrating them on the card is queued in
ROADMAP.md (queue A, item 3), and with it the JAX package's strategy
pick (tiles, gather or flat), which ``spgemm(strategy="auto")`` will
read; until then "auto" means "gather".
"""

from __future__ import annotations

import numpy as np

from outerspace_tpu_torch.formats.csr import CSC, CSR
from outerspace_tpu_torch.sched.planner import TILE_A_CLASSES, TILE_B

# Per-element weights of the JAX planner (see the module docstring).
SORT_NS = 1.6
TILE_NS = 0.22  # the (8, 128) anchor class
GATHER_NS = 0.15
FLAT_NS = 9.0
GATHER_MAX_NB = 256
WASTE_GRID = (1.05, 1.1, 1.15, 1.25, 1.5, 2.0)

# Per tile class, the weight the JAX planner's ``tile_ns`` gives when its
# native event model is built: the anchor class keeps TILE_NS and the
# taller classes scale by that model's step-overhead ratio. The JAX
# package falls back to TILE_NS for every class without its native
# library; the parity tests set this table to whatever it gives.
TILE_NS_BY_CLASS = {
    128: 0.01811236186785358,
    32: 0.055839392602256156,
    8: TILE_NS,
}


def tile_ns(tile_a: int) -> float:
    """Per-element weight of the dense-tile expand at height ``tile_a``."""
    return TILE_NS_BY_CLASS.get(tile_a, TILE_NS)


def _class_totals(
    na: np.ndarray,
    nb: np.ndarray,
    waste_limit: float,
    rescue_limit: float = 6.0,
    gather_edges: bool = True,
    b_mis: np.ndarray | int = 0,
) -> tuple[list[int], int, int]:
    """(per-class padded tile stream, gather-served products, flat-served
    products) under the same assignment rules as
    ``sched.planner.plan_outer_classes``.

    The assignment uses aligned padding (no ``b_mis``), as the planner
    does; the padded stream charged is the staged footprint including
    each B row's flat-start misalignment ``b_mis`` (mod 128)."""
    prod = na * nb
    nonzero = prod > 0
    assigned = np.zeros(na.shape[0], dtype=bool)
    padded_cls = [0] * len(TILE_A_CLASSES)
    for ci, ta in enumerate(TILE_A_CLASSES):
        padded = (-(-na // ta)) * ta * (-(-nb // TILE_B)) * TILE_B
        cost = (-(-na // ta)) * ta * (-(-(nb + b_mis) // TILE_B)) * TILE_B
        ok = nonzero & ~assigned & (padded <= waste_limit * prod)
        padded_cls[ci] += int(cost[ok].sum())
        assigned |= ok
    gather_p = 0
    if gather_edges:
        from outerspace_tpu_torch.sched.planner import trim_split

        rest = nonzero & ~assigned
        do_trim, tile_ci, tile_part, edges = trim_split(
            na, nb, b_mis, rest, TILE_A_CLASSES
        )
        for ci in range(len(TILE_A_CLASSES)):
            padded_cls[ci] += int(tile_part[do_trim & (tile_ci == ci)].sum())
        gather_p += int((na * edges)[do_trim].sum())
        gather_p += int(prod[rest & ~do_trim].sum())
        return padded_cls, gather_p, 0
    # rescue pass for window-incompatible k
    need = nonzero & ~assigned & (nb > GATHER_MAX_NB)
    if need.any():
        best = None
        best_ci = np.zeros(na.shape[0], dtype=np.int64)
        for ci, ta in enumerate(TILE_A_CLASSES):
            padded = (-(-na // ta)) * ta * (-(-nb // TILE_B)) * TILE_B
            if best is None:
                best = padded
            else:
                better = padded < best
                best = np.where(better, padded, best)
                best_ci = np.where(better, ci, best_ci)
        ok = need & (best <= rescue_limit * prod)
        for ci in range(len(TILE_A_CLASSES)):
            padded_cls[ci] += int(best[ok & (best_ci == ci)].sum())
        assigned |= ok
    rest = nonzero & ~assigned
    gatherable = rest & (nb <= GATHER_MAX_NB)
    gather_p = int(prod[gatherable].sum())
    flat_p = int(prod[rest & ~gatherable].sum())
    return padded_cls, gather_p, flat_p


def modeled_cost_ns(
    na: np.ndarray,
    nb: np.ndarray,
    waste_limit: float,
    gather_edges: bool = True,
    b_mis: np.ndarray | int = 0,
) -> float:
    """The model's weighted stream total at ``waste_limit``."""
    padded_cls, gather_p, flat_p = _class_totals(
        na, nb, waste_limit, gather_edges=gather_edges, b_mis=b_mis
    )
    stream = sum(padded_cls) + gather_p + flat_p
    return (
        sum(p * tile_ns(ta) for p, ta in zip(padded_cls, TILE_A_CLASSES))
        + gather_p * GATHER_NS
        + flat_p * FLAT_NS
        + stream * SORT_NS
    )


def best_waste_limit(
    a_csc: CSC, b_csr: CSR, waste_grid: tuple[float, ...] = WASTE_GRID
) -> float:
    """The waste limit of ``waste_grid`` with the least modeled cost
    (the JAX package's ``autotune(...)[1]``)."""
    na = a_csc.major_nnz().astype(np.int64)
    nb = b_csr.major_nnz().astype(np.int64)
    if int((na * nb).sum()) == 0:
        return waste_grid[0]
    # The tiled residue is gather-servable whenever its planner can pack
    # keys: globally (m·n ≤ 2³²) or in rebased row parts
    # (ops.spgemm.plan_tiled_parts).
    from outerspace_tpu_torch.ops.spgemm import _MAX_PARTS

    mn = a_csc.shape[0] * b_csr.shape[1]
    gather_edges = mn <= 2**32 or (
        b_csr.shape[1] < 2**31 and mn <= _MAX_PARTS * 2**32
    )
    b_mis = np.asarray(b_csr.indptr)[:-1].astype(np.int64) % TILE_B
    costs = {
        wl: modeled_cost_ns(na, nb, wl, gather_edges=gather_edges, b_mis=b_mis)
        for wl in waste_grid
    }
    return min(costs, key=costs.get)
