"""Cost model of the SpGEMM strategies: the tile waste limit per operand
pair and the strategy pick (tiles, gather or flat), from per-element
weights over the operands' degree distributions (host numpy, no device
work). A port of the JAX package's ``sched/autotune.py``.

The weights are device times of this port's stages on an NVIDIA H100
80GB HBM3 at a 700.00 W power limit, in ns per stream slot, measured by
``chip_smoke.py`` (device-only CUDA events on rmat14_ef8 A²'s streams;
``PERF.md`` §6):

- ``GATHER_NS``: K1, the windowed-gather expand, per slot it writes;
- ``SORT_NS``: the merge, ``torch.sort`` + K2, per merge-stream slot;
- ``FLAT_NS``: the flat expand (``expand_partial_products`` and key
  packing) per slot of the flat plan;
- ``TILE_NS_BY_CLASS``: K3, the dense-tile expand, per padded slot of
  each tile class (``TILE_NS`` is the (8, 128) class's).

The model counts device work only: the host plan, staging and the fetch
to CSR are outside it. ``plan_tiled`` takes its default waste limit from
:func:`best_waste_limit`, and ``sched.planner.trim_split`` picks a
trimmed row's tile class with :func:`tile_ns`, so the port's plans follow
these weights; the parity tests set the JAX package's weights first.
"""

from __future__ import annotations

import numpy as np

from outerspace_tpu_torch.formats.csr import CSC, CSR
from outerspace_tpu_torch.sched.planner import TILE_A_CLASSES, TILE_B

# ns per slot (see the module docstring)
SORT_NS = 0.0903714688040334
GATHER_NS = 0.005728853562476825
FLAT_NS = 0.2045143105533498
TILE_NS_BY_CLASS = {
    128: 0.00992838522506645,
    32: 0.005228678408760364,
    8: 0.005483773981915454,
}
TILE_NS = TILE_NS_BY_CLASS[8]  # the (8, 128) anchor class
GATHER_MAX_NB = 256
WASTE_GRID = (1.05, 1.1, 1.15, 1.25, 1.5, 2.0)
# The gather pipeline's merge stream per product: the subtile cuts'
# padding and the parts' common length. A property of the plan (both
# packages plan alike): 1.007-1.074 on the JAX package's A² suite,
# 1.0129 on rmat14_ef8 and 1.0221 on er100k in the port (PERF.md §6).
GATHER_FILL = 1.04
# Tiles must beat gather by this modeled margin: the model leaves out
# the parts' padding to a common merge length and a launch per (part,
# class) table. On the card rmat14_ef8 modeled tiles 2% above gather
# and measured them 17% above by the profiler's busy time (PERF.md §6).
TILES_MARGIN = 1.15


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


def _waste_costs(a_csc: CSC, b_csr: CSR, waste_grid: tuple[float, ...]):
    """(na, nb, total products, gather_edges, b_mis, modeled cost per
    waste limit of ``waste_grid``); the costs are None when there are no
    products."""
    na = a_csc.major_nnz().astype(np.int64)
    nb = b_csr.major_nnz().astype(np.int64)
    total = int((na * nb).sum())
    # The tiled residue is gather-servable whenever its planner can pack
    # keys: globally (m·n ≤ 2³²) or in rebased row parts
    # (ops.spgemm.plan_tiled_parts).
    from outerspace_tpu_torch.ops.spgemm import _MAX_PARTS

    mn = a_csc.shape[0] * b_csr.shape[1]
    gather_edges = mn <= 2**32 or (
        b_csr.shape[1] < 2**31 and mn <= _MAX_PARTS * 2**32
    )
    b_mis = np.asarray(b_csr.indptr)[:-1].astype(np.int64) % TILE_B
    costs = None
    if total:
        costs = {
            wl: modeled_cost_ns(na, nb, wl, gather_edges=gather_edges, b_mis=b_mis)
            for wl in waste_grid
        }
    return na, nb, total, gather_edges, b_mis, costs


def best_waste_limit(
    a_csc: CSC, b_csr: CSR, waste_grid: tuple[float, ...] = WASTE_GRID
) -> float:
    """The waste limit of ``waste_grid`` with the least modeled cost
    (:func:`autotune`'s second value)."""
    costs = _waste_costs(a_csc, b_csr, waste_grid)[-1]
    return waste_grid[0] if costs is None else min(costs, key=costs.get)


def strategy_costs(
    a_csc: CSC, b_csr: CSR, waste_grid: tuple[float, ...] = WASTE_GRID
) -> tuple[dict[str, float], float, int] | None:
    """The modeled cost of each strategy, ns: ``({"tiles", "gather",
    "flat"}: cost, best waste limit, padded tile stream at it)``, or
    None for operands with no products."""
    na, nb, total, gather_edges, b_mis, costs = _waste_costs(a_csc, b_csr, waste_grid)
    if costs is None:
        return None
    wl_best = min(costs, key=costs.get)
    padded_best = sum(
        _class_totals(na, nb, wl_best, gather_edges=gather_edges, b_mis=b_mis)[0]
    )
    # Chunked ranges make every row gather-servable (any m·n via the
    # row-split pipeline), so pure gather has no flat part.
    return {
        "tiles": costs[wl_best],
        "gather": int(total * GATHER_FILL) * (GATHER_NS + SORT_NS),
        "flat": total * (FLAT_NS + SORT_NS),
    }, wl_best, padded_best


def autotune(
    a_csc: CSC, b_csr: CSR, waste_grid: tuple[float, ...] = WASTE_GRID
) -> tuple[str, float]:
    """Pick (strategy, waste_limit) by modeled cost: "tiles" (the hybrid
    at the best waste limit), "gather" (pure windowed gather, row-split
    packed keys) or "flat"."""
    got = strategy_costs(a_csc, b_csr, waste_grid)
    if got is None:
        return "flat", waste_grid[0]
    cost, wl_best, padded_best = got
    # a hybrid with zero tile work degenerates to the gather pipeline:
    # prefer the real thing (it also row-splits past the 2^32 key space)
    if padded_best == 0 and cost["gather"] <= cost["tiles"]:
        return "gather", wl_best
    # near-tie band (TILES_MARGIN)
    if cost["gather"] <= cost["tiles"] * TILES_MARGIN:
        cost["tiles"] = float("inf")
    return min(cost, key=cost.get), wl_best
