"""The LFR benchmark graph (Lancichinetti, Fortunato and Radicchi, "Benchmark
graphs for testing community detection algorithms", Phys. Rev. E 78,
046110, 2008), undirected and unweighted, in numpy, drawn from one seed.

Following the paper:

1. each vertex's degree is drawn from a power law of exponent ``tau1`` on
   [k_min, k_max], with k_min set so that the mean is ``mean_degree``;
2. community sizes are drawn from a power law of exponent ``tau2`` on
   [c_min, c_max] until they sum to N;
3. each vertex keeps ``round((1 - mu) * k)`` of its k stubs inside its
   community and joins only a community larger than that;
4. the internal stubs of each community, and the external stubs of the
   whole graph, are wired by the configuration model;
5. self loops and multi-edges are removed.

Departures from the paper's procedure, each a choice of mechanics and
not of the distribution drawn (the configuration lists them under
``assumed``):

- the power laws are continuous, each draw rounded to the nearest
  integer, and k_min is the real number that makes the continuous mean
  ``mean_degree``;
- the last community size drawn is cut so that the sizes sum to N; a cut
  below c_min is dropped and its vertices go one by one to communities
  below c_max, picked at random;
- vertices are placed in descending order of internal degree, each
  group of equal internal degree at once, in free places of the
  communities large enough for it, drawn at random without replacement
  (the paper places vertices at random and evicts on overflow);
- a community with an odd number of internal stubs turns one internal
  stub of a random member into an external one; an odd external total
  gives one more external stub to a random vertex below k_max;
- the configuration model's self loops, repeated edges and (external)
  edges inside one community are rewired by up to :data:`SWAP_ROUNDS`
  rounds of degree-preserving double-edge swaps (:func:`_wire`), as the
  paper rewires them; the internal stubs of an edge no swap could repair
  (a few per thousand, in the densest communities) become external
  stubs of their vertices. So every vertex keeps its drawn degree (one
  vertex at most gains one), and the mixing comes out a few thousandths
  above ``mu``.

Vertex labels are scrambled as ``generators.make`` scrambles them, by a
permutation drawn from the seed (``generators.relabel``).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import generators

# rounds of double-edge swaps that rewire the configuration model's
# self loops, repeats and forbidden edges
SWAP_ROUNDS = 200


def _power_law(rng, size: int, tau: float, lo: float, hi: float) -> np.ndarray:
    """Draws of density ∝ x^-tau on [lo, hi], by the inverse of the
    cumulative distribution."""
    u = rng.random(size)
    if abs(tau - 1.0) < 1e-12:
        return lo * (hi / lo) ** u
    a = 1.0 - tau
    return (lo**a + u * (hi**a - lo**a)) ** (1.0 / a)


def _power_law_mean(tau: float, lo: float, hi: float) -> float:
    """The mean of the continuous power law of exponent ``tau`` on [lo, hi]."""
    def integral(p):  # ∫ x^p dx on [lo, hi]
        if abs(p + 1.0) < 1e-12:
            return np.log(hi / lo)
        return (hi ** (p + 1) - lo ** (p + 1)) / (p + 1)

    return integral(1.0 - tau) / integral(-tau)


def min_degree(mean_degree: float, max_degree: float, tau1: float) -> float:
    """The k_min at which the degree law on [k_min, k_max] has the mean
    ``mean_degree`` (bisection; the mean rises with k_min)."""
    lo, hi = 1.0, float(max_degree)
    if not _power_law_mean(tau1, lo, hi) <= mean_degree < max_degree:
        raise ValueError(f"no k_min in [1, {max_degree}] gives the mean degree {mean_degree}")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _power_law_mean(tau1, mid, max_degree) < mean_degree:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _community_sizes(rng, n: int, tau2: float, c_min: int, c_max: int) -> np.ndarray:
    sizes = []
    total = 0
    while total < n:
        batch = np.rint(_power_law(rng, max(16, (n - total) // c_min), tau2, c_min, c_max))
        for s in batch.astype(np.int64):
            sizes.append(int(min(s, n - total)))
            total += sizes[-1]
            if total == n:
                break
    sizes = np.asarray(sizes, dtype=np.int64)
    if sizes[-1] < c_min and sizes.shape[0] > 1:
        rest, sizes = int(sizes[-1]), sizes[:-1]
        for _ in range(rest):
            room = np.flatnonzero(sizes < c_max)
            sizes[room[rng.integers(room.shape[0])]] += 1
    return sizes


def _place(rng, k_in: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """The community of each vertex: vertices in descending order of
    internal degree, each group of equal degree drawn without
    replacement among the free places of communities larger than it."""
    free = sizes.copy()
    member = np.full(k_in.shape[0], -1, dtype=np.int64)
    for d in np.unique(k_in)[::-1]:
        who = np.flatnonzero(k_in == d)
        fits = np.flatnonzero((sizes > d) & (free > 0))
        places = np.repeat(fits, free[fits])
        if places.shape[0] < who.shape[0]:
            raise ValueError(f"{who.shape[0]} vertices of internal degree {d} do not fit the "
                             f"communities larger than {d}")
        got = places[rng.choice(places.shape[0], size=who.shape[0], replace=False)]
        member[who] = got
        np.subtract.at(free, got, 1)
    return member


def _pair_stubs(rng, owner: np.ndarray, group: np.ndarray) -> np.ndarray:
    """The configuration model within each group: the stubs of a group
    (``owner[i]`` is stub i's vertex, ``group[i]`` its group) shuffled and
    paired in order; a group with an odd count drops its last stub.
    Returns the edges as an (E, 2) array."""
    order = np.lexsort((rng.random(owner.shape[0]), group))
    owner, group = owner[order], group[order]
    start = np.flatnonzero(np.concatenate([[True], group[1:] != group[:-1]]))
    length = np.diff(np.concatenate([start, [group.shape[0]]]))
    pos = np.arange(group.shape[0]) - np.repeat(start, length)
    first = (pos % 2 == 0) & (pos + 1 < np.repeat(length, length))
    i = np.flatnonzero(first)
    return np.stack([owner[i], owner[i + 1]], axis=1)


def _keys(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """The undirected edge (a, b)'s key, min·n + max."""
    return np.minimum(a, b) * n + np.maximum(a, b)


def _wire(rng, owner: np.ndarray, vertex_group: np.ndarray, forbid=None):
    """The configuration model of :func:`_pair_stubs` over the stubs
    ``owner`` (each vertex's group from ``vertex_group``), then up to
    :data:`SWAP_ROUNDS` rounds of rewiring. A bad edge is a self loop, a
    repeat of an edge (every copy but one), or, with ``forbid``, an edge
    whose ends share a ``forbid`` label. In each round each bad edge
    (u, v) draws an edge (x, y) of its group at random, in a random
    orientation, and the pair becomes (u, x) and (v, y) where the draw
    is a good edge drawn by no other and both new edges are good and
    new (a degree-preserving double-edge swap). Returns the good edges
    as an (E, 2) array and the stubs (vertices) of the bad edges left."""
    n = vertex_group.shape[0]
    edges = _pair_stubs(rng, owner, vertex_group[owner])
    # the keys present: those of the pairing, then those the swaps add
    # (a key a swap removes stays, which only turns a few swaps down)
    present, first = np.unique(_keys(edges[:, 0], edges[:, 1], n), return_index=True)
    added = np.empty(0, np.int64)
    bad = np.ones(edges.shape[0], dtype=bool)
    bad[first] = False
    bad |= edges[:, 0] == edges[:, 1]
    if forbid is not None:
        bad |= forbid[edges[:, 0]] == forbid[edges[:, 1]]
    group = vertex_group[edges[:, 0]]
    by_group = np.argsort(group, kind="stable")
    sorted_group = group[by_group]
    todo = np.flatnonzero(bad)
    for _ in range(SWAP_ROUNDS):
        if not todo.shape[0]:
            break
        g = group[todo]
        lo = np.searchsorted(sorted_group, g, "left")
        hi = np.searchsorted(sorted_group, g, "right")
        draw = by_group[lo + (rng.random(todo.shape[0]) * (hi - lo)).astype(np.int64)]
        _, once = np.unique(draw, return_index=True)
        take = np.zeros(todo.shape[0], dtype=bool)
        take[once] = True
        take &= ~bad[draw]
        b, d = todo[take], draw[take]
        u, v = edges[b, 0], edges[b, 1]
        flip = rng.random(b.shape[0]) < 0.5
        x = np.where(flip, edges[d, 1], edges[d, 0])
        y = np.where(flip, edges[d, 0], edges[d, 1])
        k1, k2 = _keys(u, x, n), _keys(v, y, n)
        ok = (u != x) & (v != y) & (k1 != k2)
        for keys in (present, added):
            if keys.shape[0]:
                for k in (k1, k2):
                    ok &= keys[np.minimum(np.searchsorted(keys, k), keys.shape[0] - 1)] != k
        if forbid is not None:
            ok &= (forbid[u] != forbid[x]) & (forbid[v] != forbid[y])
        # two swaps of one round may not make the same edge
        made, times = np.unique(np.concatenate([k1[ok], k2[ok]]), return_counts=True)
        twice = made[times > 1]
        ok[ok] &= ~np.isin(k1[ok], twice) & ~np.isin(k2[ok], twice)
        edges[b[ok]] = np.stack([u[ok], x[ok]], axis=1)
        edges[d[ok]] = np.stack([v[ok], y[ok]], axis=1)
        bad[b[ok]] = False
        todo = todo[bad[todo]]
        new = np.sort(np.concatenate([k1[ok], k2[ok]]))
        added = np.insert(added, np.searchsorted(added, new), new)
    return edges[~bad], edges[bad].ravel()


def lfr_graph(n: int, *, mean_degree: float, max_degree: int, tau1: float, tau2: float,
              min_community: int, max_community: int, mixing: float, seed: int):
    """An LFR graph as the module's header draws it: its CSR (numpy
    arrays, float32 ones, symmetric, no self loops, labels not yet
    scrambled) and each vertex's community."""
    rng = np.random.default_rng([seed, 0x1F8])
    k_min = min_degree(mean_degree, max_degree, tau1)
    degree = np.rint(_power_law(rng, n, tau1, k_min, max_degree)).astype(np.int64)
    k_in = np.rint((1.0 - mixing) * degree).astype(np.int64)
    sizes = _community_sizes(rng, n, tau2, min_community, max_community)
    member = _place(rng, k_in, sizes)
    # a random member of each community with an odd internal stub count
    # turns one internal stub external
    odd = np.flatnonzero(np.bincount(member, weights=k_in, minlength=sizes.shape[0]) % 2 == 1)
    has = np.flatnonzero(k_in > 0)
    has = has[np.lexsort((rng.random(has.shape[0]), member[has]))]
    k_in[has[np.searchsorted(member[has], odd)]] -= 1
    vertex = np.arange(n, dtype=np.int64)
    internal, left = _wire(rng, np.repeat(vertex, k_in), member)
    k_out = degree - k_in + np.bincount(left, minlength=n)
    if k_out.sum() % 2:
        room = np.flatnonzero(degree < max_degree)
        k_out[room[rng.integers(room.shape[0])]] += 1
    external, left = _wire(rng, np.repeat(vertex, k_out), np.zeros(n, np.int64), forbid=member)
    if left.shape[0]:
        raise ValueError(f"{left.shape[0] // 2} external edges could not be rewired")
    edges = np.concatenate([internal, external])
    rows = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int32)
    cols = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int32)
    g = generators.coo_to_csr((n, n), rows, cols, np.ones(rows.shape[0], np.float32))
    return g, member


def make(config: dict):
    """The CSR of an LFR configuration (``"generator": "lfr"``), drawn
    from its ``graph_seed``, labels scrambled by a permutation drawn from
    the same seed."""
    if config["generator"] != "lfr":
        raise ValueError(f"not an LFR configuration: {config['generator']!r}")
    g, _ = lfr_graph(
        config["n_vertices"], mean_degree=config["mean_degree"], max_degree=config["max_degree"],
        tau1=config["tau1"], tau2=config["tau2"], min_community=config["min_community"],
        max_community=config["max_community"], mixing=config["mixing"],
        seed=config["graph_seed"])
    perm = np.random.default_rng([config["graph_seed"], 0x9E1A]).permutation(g[0][0])
    return generators.relabel(g, perm)
