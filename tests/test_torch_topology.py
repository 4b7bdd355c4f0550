"""The port's topology module held to the JAX package's: every generator's
adjacency bit for bit, and the hop distances, ball and ring sizes, the
vectorized engine's delivery / compaction budgets, the degree views, the
permutation decomposition, the gossip schedules (frontier and chain) and
their audits exactly equal (both are host-side numpy)."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import topology as J                             # noqa: E402
from repro_torch.core import topology as P                       # noqa: E402

KW = {"erdos": {"p": 0.3}, "smallworld": {"degree": 2, "beta": 0.3},
      "kregular": {"degree": 3}}


@pytest.mark.parametrize("n", [6, 13, 40])
@pytest.mark.parametrize("kind", J.KINDS)
def test_adjacency_matches_jax(kind, n):
    assert P.KINDS == J.KINDS
    for seed in (0, 2):
        p = P.make(kind, n, seed=seed, **KW.get(kind, {}))
        j = J.make(kind, n, seed=seed, **KW.get(kind, {}))
        assert p.kind == j.kind
        np.testing.assert_array_equal(p.adj, j.adj)
        assert p.is_connected()


@pytest.mark.parametrize("ttl", [1, 2, 3])
@pytest.mark.parametrize("kind,n", [("ring", 12), ("kregular", 16),
                                    ("erdos", 14), ("smallworld", 15),
                                    ("full", 80)])          # full: the dense BFS
def test_distances_and_budgets_match_jax(kind, n, ttl):
    adj = J.make(kind, n, seed=2, **KW.get(kind, {})).adj.copy()
    adj[3, :] = adj[:, 3] = False                        # a dead-masked node
    for hops in (None, ttl):
        np.testing.assert_array_equal(
            P.hop_distance_from_adj(adj, max_hops=hops),
            J.hop_distance_from_adj(adj, max_hops=hops))
    dist = J.hop_distance_from_adj(adj)
    np.testing.assert_array_equal(P.ttl_ball_sizes(adj, ttl),
                                  J.ttl_ball_sizes(adj, ttl))
    assert P.delivery_budget(adj, ttl) == J.delivery_budget(adj, ttl)
    half = np.arange(n // 2)
    for receivers in (None, half):
        np.testing.assert_array_equal(
            P.ring_sizes(adj, ttl, receivers=receivers),
            J.ring_sizes(adj, ttl, receivers=receivers))
    for intervals, latency in (((1, 1), 1), ((3, 5), 1), ((4, 4), 2),
                               ((ttl + 1, ttl + 4), 1)):
        assert P.compaction_budget(adj, ttl, intervals, latency=latency,
                                   dist=dist) == \
            J.compaction_budget(adj, ttl, intervals, latency=latency)
        assert P.compaction_budget(adj, ttl, intervals, latency=latency,
                                   receivers=half) == \
            J.compaction_budget(adj, ttl, intervals, latency=latency,
                                receivers=half)


def test_batch_budgets_match_jax():
    adj = J.make("smallworld", 20, degree=2, beta=0.3, seed=1).adj
    dead_sets = [(), (4,), (0, 7, 13), tuple(range(20))]
    p = P.batch_budgets(adj, 2, (3, 6), dead_sets, latency=1)
    j = J.batch_budgets(adj, 2, (3, 6), dead_sets, latency=1)
    assert (p.delivery, p.compaction) == (j.delivery, j.compaction)
    assert p.per_federation_delivery == j.per_federation_delivery
    assert p.per_federation_compaction == j.per_federation_compaction
    with pytest.raises(ValueError, match=">= 1 federation"):
        P.batch_budgets(adj, 2, (3, 6), [])


def test_budget_and_generator_validation():
    adj = P.ring(6).adj
    with pytest.raises(ValueError, match="ttl"):
        P.ttl_ball_sizes(adj, 0)
    with pytest.raises(ValueError, match="interval"):
        P.compaction_budget(adj, 1, (0, 2))
    with pytest.raises(ValueError, match="latency"):
        P.compaction_budget(adj, 1, (2, 2), latency=0)
    with pytest.raises(ValueError, match="0 < p <= 1"):
        P.erdos_renyi(8, p=0.0)
    with pytest.raises(ValueError, match="beta"):
        P.small_world(8, beta=1.5)
    with pytest.raises(ValueError, match="unknown topology"):
        P.make("star", 8)


def _schedule_equal(p, j):
    assert p.steps == j.steps
    assert p.num_collectives == j.num_collectives
    np.testing.assert_array_equal(p.senders, j.senders)
    np.testing.assert_array_equal(p.hops, j.hops)
    np.testing.assert_array_equal(p.delivery_counts(), j.delivery_counts())


@pytest.mark.parametrize("ttl", [1, 2, 3])
@pytest.mark.parametrize("kind", J.KINDS)
def test_gossip_schedules_and_audits_match_jax(kind, ttl):
    """All five kinds at ttl 1-3, both lowerings: the same steps, senders,
    hops and delivery counts, and the same audit verdicts (the frontier
    lowering exact, the chain walk's under-coverage on irregular graphs
    reported pair for pair)."""
    for n, seed in ((13, 2), (16, 5)):
        p = P.make(kind, n, seed=seed, **KW.get(kind, {}))
        j = J.make(kind, n, seed=seed, **KW.get(kind, {}))
        assert p.perm_schedule() == j.perm_schedule()
        assert P._circulant_offsets(p.adj) == J._circulant_offsets(j.adj)
        for schedule in P.SCHEDULES:
            ps = P.gossip_schedule(p, ttl, schedule=schedule)
            js = J.gossip_schedule(j, ttl, schedule=schedule)
            _schedule_equal(ps, js)
            pa = P.audit_schedule(p, ttl, schedule=schedule)
            ja = J.audit_schedule(j, ttl, schedule=schedule)
            assert dataclasses.astuple(pa) == dataclasses.astuple(ja)
            assert pa.ok == ja.ok
            if schedule == "frontier":
                assert pa.ok and pa.coverage == 1.0
        assert P.audit_schedule(p, ttl, P.gossip_schedule(p, ttl)).ok


def test_chain_schedule_under_covers_where_jax_does():
    """The legacy chain walk misses in-ball pairs on an irregular graph at
    ttl 2; the audit reports the same pairs in both packages."""
    p = P.make("erdos", 16, p=0.3, seed=1)
    j = J.make("erdos", 16, p=0.3, seed=1)
    pa = P.audit_schedule(p, 2, schedule="chain")
    ja = J.audit_schedule(j, 2, schedule="chain")
    assert pa.missing == ja.missing and pa.coverage == ja.coverage
    assert pa.missing and pa.coverage < 1.0
    with pytest.raises(ValueError, match="ttl"):
        P.gossip_schedule(p, 0)
    with pytest.raises(ValueError, match="unknown schedule"):
        P.gossip_schedule(p, 1, schedule="tree")


@pytest.mark.parametrize("kind", J.KINDS)
def test_degrees_and_edges_match_jax(kind):
    for n in (6, 13, 40):
        p = P.make(kind, n, seed=2, **KW.get(kind, {}))
        j = J.make(kind, n, seed=2, **KW.get(kind, {}))
        assert p.num_edges == j.num_edges
        np.testing.assert_array_equal(p.degrees(), j.degrees())
        assert p.degrees().dtype == np.int32
        assert int(p.degrees().sum()) == 2 * p.num_edges
