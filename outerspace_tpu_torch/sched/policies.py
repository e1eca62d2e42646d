"""Residency-policy and merge-scheduling studies (host numpy), a port of
the JAX package's ``sched/policies.py``; the event model
(``perf/perfsim.py``) is its reader.

A re-design of the reference's disabled research code
(``SimSpGEMM.cpp:304-812``, all inside ``#if 0``):

- the Belady/MIN and LRU cache-policy studies (``policyMIN``,
  ``policySlotMIN``, ``:561-810``) become **on-chip block-residency
  analysis**: given the expand kernel's B-block access stream (from the
  scheduler's task table), how many HBM refetches does each policy incur
  when a given number of B blocks stays on chip (in K3's shared memory,
  or in L2)? This guides task ordering — the B-major order the planner
  emits exists precisely because it turns MIN-optimal reuse into plain
  adjacency.
- the size-sorted k-way merge scheduler with partial-result requeue
  (``merge``, ``:445-517``) becomes ``merge_schedule``: a Huffman-style
  plan for hierarchical merging of sorted runs, with its cost model —
  used to reason about multi-pass merge kernels (fan-in choice).
"""

from __future__ import annotations

import heapq

import numpy as np


def simulate_lru(accesses: np.ndarray, capacity: int) -> tuple[int, int]:
    """(hits, misses) of an LRU cache of ``capacity`` blocks over the
    access stream (block ids)."""
    from collections import OrderedDict

    cache: OrderedDict[int, None] = OrderedDict()
    hits = misses = 0
    for b in accesses:
        b = int(b)
        if b in cache:
            hits += 1
            cache.move_to_end(b)
        else:
            misses += 1
            cache[b] = None
            if len(cache) > capacity:
                cache.popitem(last=False)
    return hits, misses


def simulate_belady(accesses: np.ndarray, capacity: int) -> tuple[int, int]:
    """(hits, misses) of Belady's MIN (evict the block reused furthest in
    the future) — the reference's ``policyMIN`` study
    (``SimSpGEMM.cpp:561-653``), block-granular."""
    n = len(accesses)
    next_use = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
    last_seen: dict[int, int] = {}
    for i in range(n - 1, -1, -1):
        b = int(accesses[i])
        next_use[i] = last_seen.get(b, np.iinfo(np.int64).max)
        last_seen[b] = i
    cache: dict[int, int] = {}  # block -> next use index
    heap: list[tuple[int, int]] = []  # (-next_use, block) lazy heap
    hits = misses = 0
    for i, b in enumerate(accesses):
        b = int(b)
        if b in cache:
            hits += 1
        else:
            misses += 1
            if len(cache) >= capacity:
                while heap:
                    nu, victim = heapq.heappop(heap)
                    if victim in cache and cache[victim] == -nu:
                        del cache[victim]
                        break
        cache[b] = int(next_use[i])
        heapq.heappush(heap, (-int(next_use[i]), b))
    return hits, misses


def residency_study(
    b_blocks: np.ndarray, capacities: list[int]
) -> dict[int, dict[str, float]]:
    """Hit rates of LRU vs Belady over the expand task stream's B-block
    accesses at several on-chip budgets (blocks kept); the gap quantifies how much a
    smarter task order could still save."""
    out = {}
    n = max(len(b_blocks), 1)
    for cap in capacities:
        lh, _ = simulate_lru(b_blocks, cap)
        bh, _ = simulate_belady(b_blocks, cap)
        out[cap] = {"lru": lh / n, "belady": bh / n}
    return out


def simulate_slot_min(
    accesses: np.ndarray, capacity: int, lookahead: int
) -> tuple[int, int]:
    """Finite-lookahead slot-MIN — the reference's ``policySlotMIN``
    (``SimSpGEMM.cpp:657-810``), the hardware-realistic MIN variant:
    a fixed array of ``capacity`` slots; on a miss with all slots full,
    the victim is chosen by a tournament over slots comparing each
    resident block's next use *within the next ``lookahead`` accesses*
    (a fresh window scan — blocks unused inside the window all look
    maximally-distant), ties resolved to the lowest slot index (the
    deterministic tree order). Infinite lookahead recovers
    :func:`simulate_belady`; ``lookahead=0`` degrades to FIFO-ish slot
    replacement. Returns (hits, misses). O(misses × lookahead) — a
    study tool, not a production path."""
    n = len(accesses)
    acc = np.asarray(accesses, dtype=np.int64)
    slots_block = np.full(capacity, -1, dtype=np.int64)
    block2slot: dict[int, int] = {}
    hits = misses = 0
    free = list(range(capacity - 1, -1, -1))
    for i in range(n):
        b = int(acc[i])
        if b in block2slot:
            hits += 1
            continue
        misses += 1
        if free:
            s = free.pop()
        else:
            # fresh window scan: first in-window next-use per resident
            window = acc[i + 1 : i + 1 + lookahead]
            dist = np.full(capacity, lookahead + 1, dtype=np.int64)
            seen = 0
            for d, wb in enumerate(window):
                s_w = block2slot.get(int(wb))
                if s_w is not None and dist[s_w] > lookahead:
                    dist[s_w] = d
                    seen += 1
                    if seen == capacity:
                        break
            s = int(np.argmax(dist))  # furthest next use; ties → lowest slot
            del block2slot[int(slots_block[s])]
        slots_block[s] = b
        block2slot[b] = s
    return hits, misses


def policy_study(
    b_blocks: np.ndarray,
    capacities: list[int],
    lookaheads: list[int] = (64, 256, 1024),
) -> dict[int, dict[str, float]]:
    """Hit rates of LRU vs finite-window slot-MIN vs full MIN over a
    B-block access stream — the reference's three-policy comparison
    (``policyMIN``/``policySlotMIN``/LRU) on the real task stream. The
    LRU↔slot-MIN gap shows what bounded foresight buys; the
    slot-MIN↔MIN gap what the window costs."""
    out = {}
    n = max(len(b_blocks), 1)
    for cap in capacities:
        row = {"lru": simulate_lru(b_blocks, cap)[0] / n,
               "belady": simulate_belady(b_blocks, cap)[0] / n}
        for la in lookaheads:
            row[f"slot_min_{la}"] = (
                simulate_slot_min(b_blocks, cap, la)[0] / n
            )
        out[cap] = row
    return out


def task_b_stream(
    a_csc, b_csr, tile_a: int = 8, order: str = "b_major",
    waste_limit: float = 8.0,
) -> np.ndarray:
    """The expand task stream's B-block access sequence for the heavy
    outer indices under a given intra-k task order — ``"b_major"`` (the
    planner's real order: consecutive tasks share a B block) or
    ``"a_major"`` (the counterfactual: B blocks sweep per A tile).
    Feeds the policy study that justifies the B-major choice."""
    from outerspace_tpu_torch.sched.planner import TILE_B, plan_outer_classes

    cp = plan_outer_classes(
        a_csc, b_csr, tile_a_classes=(tile_a,), waste_limit=waste_limit,
        gather_edges=False,
    )
    sched = cp.classes[0]
    if sched.ntasks == 0:
        return np.zeros(0, dtype=np.int64)
    if order == "b_major":
        return sched.b_block.astype(np.int64)
    # Counterfactual: per-k grids are contiguous task ranges laid out
    # local = jb·nat + ia (B block repeats nat times, then advances);
    # transposing each k's (nbt, nat) grid emits the A-major sweep.
    blocks = sched.b_block.astype(np.int64)
    out = []
    t = 0
    na = a_csc.major_nnz().astype(np.int64)
    nb = b_csr.major_nnz().astype(np.int64)
    b_ptr = np.asarray(b_csr.indptr).astype(np.int64)
    for k in sched.heavy_k.astype(np.int64):
        nat = -(-na[k] // tile_a)
        b_s = b_ptr[k]
        b_blk0 = b_s // TILE_B
        nbt = -(-(b_s + nb[k] - b_blk0 * TILE_B) // TILE_B)
        grid = blocks[t : t + nat * nbt].reshape(nbt, nat)
        out.append(grid.T.reshape(-1))
        t += nat * nbt
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


def merge_schedule(run_sizes: list[int], ways: int = 2) -> tuple[list, int]:
    """Huffman-style ``ways``-ary merge plan over sorted runs.

    The reference's scheduler repeatedly merged the smallest runs and
    requeued the partial result (``SimSpGEMM.cpp:445-517``, max 64-way);
    for k-way merging the optimal plan is the k-ary Huffman tree. Returns
    (steps, total_cost) where each step is the tuple of merged run sizes
    and cost = Σ elements moved.
    """
    if not run_sizes:
        return [], 0
    heap = [(int(s), i) for i, s in enumerate(run_sizes)]
    heapq.heapify(heap)
    # Pad so (len - 1) % (ways - 1) == 0 — classic k-ary Huffman fix-up.
    if ways > 2:
        while (len(heap) - 1) % (ways - 1) != 0:
            heapq.heappush(heap, (0, -1))
    steps = []
    cost = 0
    next_id = len(run_sizes)
    while len(heap) > 1:
        group = [heapq.heappop(heap) for _ in range(min(ways, len(heap)))]
        merged = sum(s for s, _ in group)
        cost += merged
        steps.append(tuple(s for s, _ in group))
        heapq.heappush(heap, (merged, next_id))
        next_id += 1
    return steps, cost


def optimal_fanin(run_sizes: list[int], candidates=(2, 4, 8, 16, 64)) -> int:
    """Pick the merge fan-in minimising total moved elements, modelling a
    fixed per-step overhead for wider merges (on-chip memory pressure)."""
    best, best_cost = 2, float("inf")
    for w in candidates:
        _, cost = merge_schedule(run_sizes, w)
        penalty = 1.0 + 0.02 * w  # wider compare networks cost per element
        if cost * penalty < best_cost:
            best, best_cost = w, cost * penalty
    return best
