"""Static gossip topologies for the DFL federation (paper §VI-D scale-out).

The part of the JAX package's ``repro.core.topology`` that the heap
simulator and the vectorized engine need, as host-side numpy with the same
results bit for bit: the ``Topology`` graph object, validation, the five
generators (``ring``, ``kregular``, ``erdos``, ``smallworld``, ``full``),
BFS hop distances, and the vectorized engine's static budgets:

* ``delivery_budget(adj, ttl)`` — max ttl-ball size over receivers: the
  width of the sparse/compact engines' per-receiver arrival-slot buffers.
* ``compaction_budget(adj, ttl, intervals)`` — exact bound on deliveries
  due on any ONE tick across the whole federation: the compact engine's
  work-buffer width ``W``.
* ``batch_budgets(adj, ttl, intervals, dead_sets)`` — both bounds per
  federation of a batch sharing one topology, and their max.

The gossip permutation schedules serve the production gossip round and are
ported with it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

KINDS = ("ring", "kregular", "erdos", "smallworld", "full")

_UNREACH = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class Topology:
    """An undirected, connected, self-loop-free gossip graph."""

    kind: str
    adj: np.ndarray  # (N, N) bool, symmetric, zero diagonal

    def __post_init__(self):
        validate_adjacency(self.adj)

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]

    def neighbors(self, i: int) -> List[int]:
        return [int(j) for j in np.flatnonzero(self.adj[i])]

    def as_name_dict(self, names: Sequence[str]) -> Dict[str, List[str]]:
        """Adjacency in the heap `Simulator`'s {name: [peer, ...]} form."""
        if len(names) != self.num_nodes:
            raise ValueError(
                f"{len(names)} names for {self.num_nodes} nodes")
        return {names[i]: [names[j] for j in self.neighbors(i)]
                for i in range(self.num_nodes)}

    def hop_distance(self) -> np.ndarray:
        """(N, N) int32 BFS hop counts; unreachable pairs get INT32_MAX."""
        return hop_distance_from_adj(self.adj)

    def is_connected(self) -> bool:
        return bool((self.hop_distance() < _UNREACH).all())


def hop_distance_from_adj(adj: np.ndarray, *,
                          max_hops: int | None = None) -> np.ndarray:
    """BFS hop counts over a raw (possibly partially-masked) adjacency;
    unreachable pairs get INT32_MAX. No validity requirements — usable on
    graphs with isolated nodes (e.g. dead-node-masked simulations).

    ``max_hops`` caps the search depth: pairs farther than ``max_hops``
    report INT32_MAX exactly as if unreachable. The tick simulators only
    consume distances within ``ttl`` (reach masks, delay tables, ring
    sizes), so capping at ``ttl`` is result-identical for them while
    turning the all-pairs cost from O(N * edges * diameter) into
    O(N^2 * max_hops / word-width) — the difference between minutes and
    sub-second at the sharded engine's N ~ 10^4 scale.

    All sources advance one synchronized frontier per step (a boolean
    product against the adjacency), so distances are the BFS hop counts
    bit-for-bit — there is no per-source ordering to diverge. Sparse
    graphs (max in-degree <= 64) expand frontiers by gathering padded
    in-neighbor lists, O(N^2 * degree) per hop; dense ones fall back to a
    float32 matmul (BLAS; exact for row sums <= 2^24)."""
    n = adj.shape[0]
    dist = np.full((n, n), _UNREACH, np.int32)
    np.fill_diagonal(dist, 0)
    frontier = np.eye(n, dtype=np.bool_)
    visited = frontier.copy()
    limit = n if max_hops is None else min(int(max_hops), n)
    deg_in = adj.sum(axis=0)
    k = int(deg_in.max()) if n else 0
    if k == 0 or limit < 1:
        return dist
    if k <= 64:
        # padded in-neighbor lists: nlist[u] = {v : edge v->u}, pad = n
        vs, us = np.nonzero(adj)
        order = np.argsort(us, kind="stable")
        us_s, vs_s = us[order], vs[order]
        starts = np.concatenate(
            ([0], np.cumsum(np.bincount(us_s, minlength=n))[:-1]))
        nlist = np.full((n, k), n, np.int64)
        nlist[us_s, np.arange(len(us_s)) - starts[us_s]] = vs_s
        fr_pad = np.zeros((n, n + 1), np.bool_)  # col n: always-False pad
        d = 0
        while frontier.any() and d < limit:
            d += 1
            fr_pad[:, :n] = frontier
            nxt = fr_pad[:, nlist[:, 0]]
            for j in range(1, k):                # per-column gathers avoid
                nxt |= fr_pad[:, nlist[:, j]]    # the (N, N, k) temp
            frontier = nxt & ~visited
            dist[frontier] = d
            visited |= frontier
        return dist
    adj_f = adj.astype(np.float32)
    d = 0
    while frontier.any() and d < limit:
        d += 1
        frontier = ((frontier.astype(np.float32) @ adj_f) > 0) & ~visited
        dist[frontier] = d
        visited |= frontier
    return dist


def ttl_ball_sizes(adj: np.ndarray, ttl: int, *,
                   dist: np.ndarray | None = None) -> np.ndarray:
    """(N,) int32: per node, how many OTHER nodes lie within ``ttl`` hops.

    This is the per-receiver in-flight bound of the tick simulators: a flood
    from ``src`` reaches ``dst`` iff ``1 <= dist(src, dst) <= ttl``, and each
    (dst, src) pair carries at most one in-flight model at a time, so no tick
    can deliver more than ``|ball(dst, ttl)|`` models to ``dst``. Works on
    raw (possibly dead-node-masked) adjacencies like
    ``hop_distance_from_adj``.
    """
    if ttl < 1:
        raise ValueError("ttl must be >= 1")
    if dist is None:
        dist = hop_distance_from_adj(adj)
    return ((dist >= 1) & (dist <= ttl)).sum(axis=1).astype(np.int32)


def delivery_budget(adj: np.ndarray, ttl: int, *,
                    dist: np.ndarray | None = None) -> int:
    """Static per-tick slot budget for the sparse delivery engine.

    ``max_dst |ball(dst, ttl)|`` — the exact worst case of simultaneous
    arrivals at one receiver (every in-ball sender timed so its model lands
    the same tick). The naive bound ``max_degree * ttl``-ish overcounts on
    dense graphs and undercounts on irregular ones; the BFS ball is both
    tight and safe, so the fixed-size slot buffer can never overflow.
    """
    return int(ttl_ball_sizes(adj, ttl, dist=dist).max())


def ring_sizes(adj: np.ndarray, ttl: int, *,
               dist: np.ndarray | None = None,
               receivers: np.ndarray | None = None) -> np.ndarray:
    """(N, ttl) int32: ``ring_sizes[s, d-1]`` = how many nodes lie at hop
    distance exactly ``d`` from ``s``. Rows sum to ``ttl_ball_sizes`` — the
    ball is the disjoint union of its rings. Works on raw (possibly
    dead-node-masked) adjacencies like ``hop_distance_from_adj``.

    ``receivers`` restricts the count to a subset of receiver columns: the
    sharded delivery engine budgets each shard by the deliveries landing on
    ITS nodes only, so each sender's ring is intersected with the shard's
    receiver block. Senders stay all-N — any node can send into the block.
    """
    if ttl < 1:
        raise ValueError("ttl must be >= 1")
    if dist is None:
        dist = hop_distance_from_adj(adj)
    if receivers is not None:
        dist = dist[:, np.asarray(receivers)]
    n = adj.shape[0]
    out = np.zeros((n, ttl), np.int32)
    for d in range(1, ttl + 1):
        out[:, d - 1] = (dist == d).sum(axis=1)
    return out


def compaction_budget(adj: np.ndarray, ttl: int, intervals, *,
                      latency: int = 1,
                      dist: np.ndarray | None = None,
                      receivers: np.ndarray | None = None) -> int:
    """Static bound on deliveries due on any ONE tick across the whole
    federation — the compact delivery engine's work-buffer width.

    A broadcast from ``src`` at tick ``t_b`` schedules its ttl-ball
    arrivals at ``t_b + d * latency``: one hop-distance *ring* of receivers
    per future tick. Two rings of the SAME sender can be due on the same
    tick only when they stem from two broadcasts spaced exactly
    ``(d2 - d1) * latency`` ticks apart, and a node trains at most once
    every ``lo = intervals[0]`` ticks — so co-due distances must be at
    least ``g = ceil(lo / latency)`` apart. Each sender therefore
    contributes at most its max-weight subset of ``{1..ttl}`` with pairwise
    gaps ``>= g``, weighted by its ring sizes, and the per-tick total is
    that summed over senders (exact: nothing stops every sender from timing
    its heaviest feasible ring combination onto one tick).

    In the recommended operating regime ``lo >= ttl * latency`` (outside
    it ``LaxSimulator`` warns: re-broadcast overwrites in-flight snapshots,
    which ALSO forbids multi-ring co-dueness, so the bound stays safe there
    too — just no longer tight) the gap exceeds ``ttl - 1``, feasible sets
    are singletons, and the bound collapses to
    ``sum_src max_d |ring(src, d)|``. Always ``<= N * delivery_budget``
    (the sparse engine's total slot count): the compact buffer is never
    larger than the sparse one.

    ``receivers`` restricts the bound to deliveries landing on that subset
    of nodes (see ``ring_sizes``): the sharded engine sizes each shard's
    work buffer by its own receiver block, so the per-shard budgets sum to
    at most the global one (rings partition over disjoint blocks).
    """
    lo = int(intervals[0]) if np.ndim(intervals) else int(intervals)
    if lo < 1:
        raise ValueError(f"min train interval must be >= 1, got {lo}")
    if latency < 1:
        raise ValueError(f"latency must be >= 1, got {latency}")
    rings = ring_sizes(adj, ttl, dist=dist, receivers=receivers)  # (N, ttl)
    g = max(1, -(-lo // latency))                    # ceil(lo / latency)
    # per-sender max-weight subset of distances with pairwise gaps >= g:
    # f[d] = ring[d] + best over earlier picks at distance <= d - g
    n = rings.shape[0]
    f = np.zeros((n, ttl + 1), np.int64)             # f[:, d], d = 1..ttl
    best_prefix = np.zeros((n, ttl + 1), np.int64)   # max f[:, 1..d]
    for d in range(1, ttl + 1):
        prev = best_prefix[:, d - g] if d - g >= 1 else 0
        f[:, d] = rings[:, d - 1] + prev
        best_prefix[:, d] = np.maximum(best_prefix[:, d - 1], f[:, d])
    return int(best_prefix[:, ttl].sum())


@dataclasses.dataclass(frozen=True)
class BatchBudgets:
    """Static delivery/compaction budgets for a batch of federations that
    share one topology (but may differ in dead-node sets): the per-member
    bounds plus their max over the batch. A vmapped multi-federation run
    carries ONE static ``(N, budget)`` slot layout and ONE ``(W,)`` work
    buffer for the whole batch, so the shared widths are the maxima; the
    per-federation columns record how much headroom each member has."""

    delivery: int                             # max over the batch, >= 1
    compaction: int                           # max over the batch, >= 1
    per_federation_delivery: tuple            # (B,) ints
    per_federation_compaction: tuple          # (B,) ints


def batch_budgets(adj: np.ndarray, ttl: int, intervals,
                  dead_sets: Sequence[Sequence[int]], *,
                  latency: int = 1,
                  dists: Optional[Sequence[np.ndarray]] = None
                  ) -> BatchBudgets:
    """``delivery_budget`` / ``compaction_budget`` over a batch of
    federations sharing one topology: member ``b`` routes on ``adj`` with
    ``dead_sets[b]`` masked out (rows AND columns — dead nodes neither
    send nor forward, exactly the mask ``LaxSimulator`` applies), and the
    batch budget is the max over members. ``dists`` optionally supplies
    precomputed ``hop_distance_from_adj`` results per member (the caller
    usually needs them anyway). Budgets are floored at 1 so downstream
    array shapes stay non-degenerate even for an all-dead member."""
    if not len(dead_sets):
        raise ValueError("batch_budgets needs >= 1 federation")
    if dists is not None and len(dists) != len(dead_sets):
        raise ValueError(
            f"{len(dists)} dists for {len(dead_sets)} federations")
    per_del, per_comp = [], []
    for b, dead in enumerate(dead_sets):
        alive = np.ones((adj.shape[0],), np.bool_)
        alive[list(dead)] = False
        masked = adj & alive[None, :] & alive[:, None]
        dist = dists[b] if dists is not None \
            else hop_distance_from_adj(masked)
        per_del.append(max(1, delivery_budget(masked, ttl, dist=dist)))
        per_comp.append(max(1, compaction_budget(
            masked, ttl, intervals, latency=latency, dist=dist)))
    return BatchBudgets(
        delivery=max(per_del), compaction=max(per_comp),
        per_federation_delivery=tuple(per_del),
        per_federation_compaction=tuple(per_comp))


def validate_adjacency(adj: np.ndarray) -> None:
    if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    if adj.dtype != np.bool_:
        raise ValueError("adjacency must be boolean")
    if adj.shape[0] < 2:
        raise ValueError("a gossip graph needs at least 2 nodes")
    if np.diagonal(adj).any():
        raise ValueError("self-loops are not allowed")
    if not (adj == adj.T).all():
        raise ValueError("adjacency must be symmetric (undirected gossip)")
    if (adj.sum(axis=1) == 0).any():
        raise ValueError("isolated node: every node needs >= 1 neighbor")


def ring(n: int) -> Topology:
    return kregular(n, 1)


def kregular(n: int, k: int = 1) -> Topology:
    """Circulant ring: node i adjacent to i±1..i±k (mod n)."""
    if k < 1 or (2 * k > n - 1 and not (n % 2 == 0 and k == n // 2)):
        raise ValueError(f"kregular needs 1 <= k <= (n-1)/2 (or k=n/2, even "
                         f"n); got n={n}, k={k}")
    adj = np.zeros((n, n), np.bool_)
    for d in range(1, k + 1):
        for i in range(n):
            adj[i, (i + d) % n] = adj[i, (i - d) % n] = True
    return Topology("kregular" if k > 1 else "ring", adj)


def full(n: int) -> Topology:
    adj = ~np.eye(n, dtype=np.bool_)
    return Topology("full", adj)


def erdos_renyi(n: int, p: float = 0.2, seed: int = 0,
                max_tries: int = 200) -> Topology:
    """G(n, p), resampled (fresh seed each try) until connected."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"erdos needs 0 < p <= 1, got {p}")
    rng = np.random.RandomState(seed)
    for _ in range(max_tries):
        upper = rng.rand(n, n) < p
        adj = np.triu(upper, 1)
        adj = adj | adj.T
        if (adj.sum(axis=1) > 0).all():
            topo = Topology("erdos", adj)
            if topo.is_connected():
                return topo
    raise ValueError(
        f"could not sample a connected G({n}, {p}) in {max_tries} tries; "
        "raise p")


def small_world(n: int, k: int = 2, beta: float = 0.2,
                seed: int = 0) -> Topology:
    """Watts–Strogatz: kregular ring, each +offset edge rewired w.p. beta."""
    if not 0.0 <= beta <= 1.0:
        raise ValueError(f"smallworld needs 0 <= beta <= 1, got {beta}")
    rng = np.random.RandomState(seed)
    adj = kregular(n, k).adj.copy()
    for d in range(1, k + 1):
        for i in range(n):
            j = (i + d) % n
            if not adj[i, j] or rng.rand() >= beta:
                continue
            candidates = np.flatnonzero(~adj[i])
            candidates = candidates[candidates != i]
            if candidates.size == 0:
                continue
            t = int(rng.choice(candidates))
            adj[i, j] = adj[j, i] = False
            adj[i, t] = adj[t, i] = True
    topo = Topology("smallworld", adj)
    if not topo.is_connected():  # rare at beta<1; rewire again deterministically
        return small_world(n, k, beta, seed + 1)
    return topo


def make(kind: str, n: int, *, degree: int = 2, p: float = 0.2,
         beta: float = 0.2, seed: int = 0) -> Topology:
    """Factory over ``KINDS``: ``ring|kregular|erdos|smallworld|full``."""
    if kind == "ring":
        return ring(n)
    if kind == "kregular":
        return kregular(n, degree)
    if kind == "erdos":
        return erdos_renyi(n, p, seed)
    if kind == "smallworld":
        return small_world(n, degree, beta, seed)
    if kind == "full":
        return full(n)
    raise ValueError(f"unknown topology {kind!r}; choose from {KINDS}")
