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

The adjacency is also decomposed into the production gossip round's
static plans, all numpy: ``Topology.perm_schedule`` (directed edges as
partial permutations, one collective each), ``gossip_schedule`` (one
ttl-bounded round as a sequence of forwarding steps: the exact per-hop
``frontier`` lowering, or the legacy ``chain`` walk kept as an oracle) and
``audit_schedule`` (a schedule checked against the BFS ttl-ball).
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

    @property
    def num_edges(self) -> int:
        return int(self.adj.sum()) // 2

    def degrees(self) -> np.ndarray:
        return self.adj.sum(axis=1).astype(np.int32)

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

    def perm_schedule(self) -> List[List[tuple]]:
        """Decompose directed edges into partial permutations.

        Each returned colour class is a list of ``(src, dst)`` pairs in which
        every node appears at most once as a source and at most once as a
        destination — the contract of one collective permute (every node
        sends at most one payload and receives at most one). Every directed
        edge (both orientations of each undirected edge) lands in exactly
        one class; König's bound guarantees max-degree classes exist, the
        greedy here may use a few more on irregular graphs (harmless: one
        extra permute per extra class).

        Circulant graphs (ring/kregular) are special-cased so the classes come
        out as the offset permutations [+1, -1, +2, -2, ...] — for ``ring``
        this reproduces the seed's ``ring_perms`` lowering verbatim.
        """
        n = self.num_nodes
        offsets = _circulant_offsets(self.adj)
        if offsets is not None:
            sched = []
            for k in offsets:
                sched.append([(i, (i + k) % n) for i in range(n)])
                if 2 * k != n:  # ±n/2 coincide on even n: one perm suffices
                    sched.append([(i, (i - k) % n) for i in range(n)])
            return sched
        edges = [(i, int(j)) for i in range(n)
                 for j in np.flatnonzero(self.adj[i])]
        sched = []
        while edges:
            srcs, dsts, cls, rest = set(), set(), [], []
            for (u, v) in edges:
                if u in srcs or v in dsts:
                    rest.append((u, v))
                else:
                    srcs.add(u)
                    dsts.add(v)
                    cls.append((u, v))
            sched.append(cls)
            edges = rest
        return sched



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


def _circulant_offsets(adj: np.ndarray):
    """If adj is the circulant graph with neighbour offsets ±1..±k, return
    [1..k]; otherwise None."""
    n = adj.shape[0]
    row = adj[0]
    offs = sorted(int(o) for o in np.flatnonzero(row) if int(o) <= n // 2)
    ks = [o for o in offs if o <= (n - 1) // 2 or 2 * o == n]
    if ks != list(range(1, len(ks) + 1)):
        return None
    expect = np.zeros((n, n), np.bool_)
    for k in range(1, len(ks) + 1):
        for i in range(n):
            expect[i, (i + k) % n] = expect[i, (i - k) % n] = True
    return list(range(1, len(ks) + 1)) if (expect == adj).all() else None


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


# ------------------------------------------------------------ gossip schedules
SCHEDULES = ("frontier", "chain")


@dataclasses.dataclass(frozen=True)
class GossipSchedule:
    """Static lowering plan for one gossip round over a topology.

    ``steps``   sequence of (perm, parent) pairs. Each step permutes either
                the node's own payload (``parent == -1``) or the payload
                received at an earlier step (``parent`` = that step's index,
                forming a forwarding chain). One permute per step:
                ``num_collectives == len(steps)``.
    ``senders`` (num_steps, N) int32: senders[s, i] is the node whose model
                device i holds after step s, or -1 when nothing new arrives
                there — the receiver masks that contribution's weight to
                zero, so every (receiver, sender) pair is counted AT MOST
                ONCE per round.
    ``hops``    (num_steps,) int32: the flood hop each step belongs to. The
                default ``frontier`` lowering delivers every pair (r, s) at
                hop ``hop_distance(r, s)`` — the same timing the tick
                simulators use (``arrive = t + dist * latency``).

    Coverage: the default ``frontier`` lowering is EXACT for every topology —
    each pair within the ttl-ball is delivered exactly once, nothing outside
    it ever is (``audit_schedule`` verifies this). The legacy ``chain``
    lowering (kept as a pinned-regression oracle) floods irregular graphs
    along colour-class chain walks, which silently under-covers the ball at
    ttl >= 2; circulant graphs (ring/kregular/full) lower identically under
    both (one offset permutation per in-ball distance).
    """

    steps: tuple       # ((perm, parent), ...)
    senders: np.ndarray
    hops: Optional[np.ndarray] = None

    @property
    def num_collectives(self) -> int:
        return len(self.steps)

    def delivery_counts(self) -> np.ndarray:
        """(N, N) int: how many times the schedule delivers sender s's model
        to receiver r (an exact schedule is the 0/1 ttl-ball indicator)."""
        n = self.senders.shape[1]
        got = np.zeros((n, n), int)
        for row in self.senders:
            for i in np.flatnonzero(row >= 0):
                got[i, row[i]] += 1
        return got


def _circulant_ball_schedule(n: int, k: int, ttl: int):
    """One permutation per offset in the ttl-ball {1..k*ttl} (mod wrap).

    In a circulant graph the ball of radius ttl is exactly the offsets
    o <= k*ttl; delivering each by its own one-hop permutation keeps the
    collective count at 2*k*ttl (the chain lowering's count) while hitting
    every in-ball sender exactly once — for k=1 this is the seed ring
    lowering's 2*ttl permutes.
    """
    steps, senders, hops = [], [], []
    idx = np.arange(n)
    radius = min(k * ttl, (n - 1) // 2)
    for o in range(1, radius + 1):
        hop = -(-o // k)                     # circulant dist of offset o
        steps.append((tuple((i, (i + o) % n) for i in range(n)), -1))
        senders.append((idx - o) % n)
        hops.append(hop)
        steps.append((tuple((i, (i - o) % n) for i in range(n)), -1))
        senders.append((idx + o) % n)
        hops.append(hop)
    if n % 2 == 0 and k * ttl >= n // 2:
        o = n // 2
        steps.append((tuple((i, (i + o) % n) for i in range(n)), -1))
        senders.append((idx + o) % n)
        hops.append(-(-o // k))
    return steps, np.asarray(senders, np.int32), np.asarray(hops, np.int32)


def _frontier_schedule(topo: Topology, ttl: int):
    """Exact per-hop BFS-frontier lowering for arbitrary graphs.

    Hop 1 is the colour-class decomposition of the adjacency (every direct
    neighbour delivered once, own payloads, ``parent == -1``). Hop h >= 2
    delivers every pair at BFS distance exactly h by forwarding along fresh
    frontier edges: each pair (r, s) picks a parent p — a neighbour of r one
    hop closer to s — which received s's payload at a known hop-(h-1) step.
    A permute step forwards ONE earlier step's payload, so hop-h tasks are
    grouped by that parent step and each group is greedily edge-coloured
    into partial permutations. Every step delivers at least one new pair;
    every in-ball pair is delivered exactly once, at its BFS hop.
    """
    n = topo.num_nodes
    dist = topo.hop_distance()
    steps, senders, hops = [], [], []
    deliv_step = np.full((n, n), -1, np.int64)   # [receiver, sender] -> step

    for cls in topo.perm_schedule():             # hop 1: own payloads
        row = np.full((n,), -1, np.int32)
        for (u, v) in cls:
            row[v] = u
            deliv_step[v, u] = len(steps)
        steps.append((tuple(cls), -1))
        senders.append(row)
        hops.append(1)

    for h in range(2, ttl + 1):
        pairs = [(r, s) for r in range(n) for s in range(n)
                 if dist[r, s] == h]
        if not pairs:
            break                                # ball saturated early
        # parent choice balances per-(step, node) load so the greedy
        # colouring below needs fewer permutes; ties break deterministically
        groups: Dict[int, list] = {}             # parent step -> [(p, r, s)]
        load_src: Dict[tuple, int] = {}
        load_dst: Dict[tuple, int] = {}
        for r, s in pairs:
            best = None
            for p in np.flatnonzero(topo.adj[r]):
                p = int(p)
                if dist[p, s] != h - 1:
                    continue
                sigma = int(deliv_step[p, s])    # p got s here at hop h-1
                cost = max(load_src.get((sigma, p), 0),
                           load_dst.get((sigma, r), 0))
                if best is None or (cost, sigma, p) < best[0]:
                    best = ((cost, sigma, p), p, sigma)
            _, p, sigma = best                   # BFS guarantees a parent
            groups.setdefault(sigma, []).append((p, r, s))
            load_src[(sigma, p)] = load_src.get((sigma, p), 0) + 1
            load_dst[(sigma, r)] = load_dst.get((sigma, r), 0) + 1
        for sigma in sorted(groups):
            colours = []                         # [(srcs, dsts, perm, row)]
            for p, r, s in groups[sigma]:
                for c in colours:
                    if p not in c[0] and r not in c[1]:
                        break
                else:
                    c = (set(), set(), [], np.full((n,), -1, np.int32))
                    colours.append(c)
                c[0].add(p)
                c[1].add(r)
                c[2].append((p, r))
                c[3][r] = s
            for _, _, perm, row in colours:
                for i in np.flatnonzero(row >= 0):
                    deliv_step[i, row[i]] = len(steps)
                steps.append((tuple(perm), sigma))
                senders.append(row)
                hops.append(h)
    return steps, np.asarray(senders, np.int32), np.asarray(hops, np.int32)


def _chain_schedule(topo: Topology, ttl: int):
    """The legacy chain-walk lowering (pinned-regression oracle): forward
    along each colour-class chain for ttl hops, masking out pairs already
    delivered. At ttl >= 2 the chain walks cover only a SUBSET of the
    ttl-ball on irregular graphs — the exact-flooding bug the frontier
    scheduler fixes; kept behind ``schedule="chain"`` so the under-coverage
    stays measurable (``audit_schedule``)."""
    n = topo.num_nodes
    perms = topo.perm_schedule()
    steps, senders, hops = [], [], []
    delivered = np.zeros((n, n), bool)   # [receiver, sender]
    for perm in perms:
        recv_from = np.full((n,), -1, np.int64)
        for (src, dst) in perm:
            recv_from[dst] = src
        cur = recv_from.copy()  # after hop 1, device i holds cur[i]'s model
        parent = -1
        for h in range(ttl):
            row = np.full((n,), -1, np.int32)
            for i in range(n):
                s = cur[i]
                if s >= 0 and s != i and not delivered[i, s]:
                    row[i] = s
                    delivered[i, s] = True
            steps.append((tuple(perm), parent))
            senders.append(row)
            hops.append(h + 1)
            parent = len(steps) - 1
            ok = cur >= 0
            nxt = np.full((n,), -1, np.int64)
            nxt[ok] = recv_from[cur[ok]]  # extend the backward walk one link
            cur = nxt
    # prune steps that deliver nothing (e.g. 2-cycle colour classes bounce
    # every payload home at even hops) unless a later delivering step
    # forwards through them — each step costs a full-model permute
    keep = [bool((row >= 0).any()) for row in senders]
    for s in range(len(steps)):
        if keep[s]:
            p = steps[s][1]
            while p >= 0 and not keep[p]:
                keep[p] = True
                p = steps[p][1]
    remap, kept_steps, kept_senders, kept_hops = {}, [], [], []
    for s, (step, row) in enumerate(zip(steps, senders, strict=True)):
        if not keep[s]:
            continue
        perm, parent = step
        remap[s] = len(kept_steps)
        kept_steps.append((perm, remap[parent] if parent >= 0 else -1))
        kept_senders.append(row)
        kept_hops.append(hops[s])
    return (kept_steps, np.asarray(kept_senders, np.int32),
            np.asarray(kept_hops, np.int32))


def gossip_schedule(topo: Topology, ttl: int, *,
                    schedule: str = "frontier") -> GossipSchedule:
    """Lower one ttl-bounded gossip round to a static permute plan.

    ``schedule="frontier"`` (default) is exact on every topology; circulant
    graphs (ring/kregular/full) take the closed-form offset lowering either
    way, so their collective count is identical under both modes.
    ``schedule="chain"`` replays the legacy chain-walk lowering, which
    under-covers the ttl-ball on irregular graphs at ttl >= 2.
    """
    if ttl < 1:
        raise ValueError("ttl must be >= 1")
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r}; choose from {SCHEDULES}")
    n = topo.num_nodes
    offsets = _circulant_offsets(topo.adj)
    if offsets is not None:
        steps, senders, hops = _circulant_ball_schedule(n, len(offsets), ttl)
    elif schedule == "frontier":
        steps, senders, hops = _frontier_schedule(topo, ttl)
    else:
        steps, senders, hops = _chain_schedule(topo, ttl)
    return GossipSchedule(steps=tuple(steps), senders=senders, hops=hops)


@dataclasses.dataclass(frozen=True)
class ScheduleAudit:
    """``audit_schedule``'s verdict on one GossipSchedule vs the BFS ball.

    ``missing``      in-ball (receiver, sender) pairs the schedule never
                     delivers — the chain lowering's under-coverage bug
    ``duplicates``   pairs delivered more than once (double-counted weights)
    ``out_of_ball``  delivered pairs with hop distance > ttl (or self/
                     unreachable)
    ``mistimed``     pairs delivered at a step whose hop != their BFS
                     distance (breaks hop-distance delivery-timing parity
                     with the tick simulators)
    ``wasted_steps`` step indices that neither deliver a new pair nor feed
                     (transitively) a delivering step — pure collective cost
    ``coverage``     delivered_pairs / ball_pairs
    """
    ttl: int
    missing: tuple
    duplicates: tuple
    out_of_ball: tuple
    mistimed: tuple
    wasted_steps: tuple
    ball_pairs: int
    delivered_pairs: int
    coverage: float
    num_collectives: int

    @property
    def ok(self) -> bool:
        return not (self.missing or self.duplicates or self.out_of_ball
                    or self.mistimed or self.wasted_steps)


def audit_schedule(topo: Topology, ttl: int,
                   sched: Optional[GossipSchedule] = None, *,
                   schedule: str = "frontier") -> ScheduleAudit:
    """Check a GossipSchedule against the exact BFS ttl-ball: every in-ball
    (receiver, sender) pair delivered exactly once, nothing else delivered,
    no step wasted. ``sched`` defaults to ``gossip_schedule(topo, ttl,
    schedule=schedule)``."""
    if sched is None:
        sched = gossip_schedule(topo, ttl, schedule=schedule)
    dist = topo.hop_distance()
    ball = (dist >= 1) & (dist <= ttl)
    counts = sched.delivery_counts()
    missing = tuple(map(tuple, np.argwhere(ball & (counts == 0))))
    duplicates = tuple(map(tuple, np.argwhere(counts > 1)))
    out_of_ball = tuple(map(tuple, np.argwhere(~ball & (counts > 0))))
    mistimed = []
    if sched.hops is not None:
        for step, row in enumerate(sched.senders):
            for r in np.flatnonzero(row >= 0):
                if dist[r, row[r]] != sched.hops[step]:
                    mistimed.append((int(r), int(row[r])))
    # a step is useful iff it delivers, or a useful step forwards through it
    useful = [bool((row >= 0).any()) for row in sched.senders]
    for s in range(len(sched.steps)):
        if useful[s]:
            p = sched.steps[s][1]
            while p >= 0 and not useful[p]:
                useful[p] = True
                p = sched.steps[p][1]
    wasted = tuple(s for s, u in enumerate(useful) if not u)
    total = int(ball.sum())
    delivered = int((ball & (counts > 0)).sum())
    return ScheduleAudit(
        ttl=ttl, missing=missing, duplicates=duplicates,
        out_of_ball=out_of_ball, mistimed=tuple(mistimed),
        wasted_steps=wasted, ball_pairs=total, delivered_pairs=delivered,
        coverage=(delivered / total) if total else 1.0,
        num_collectives=sched.num_collectives)
