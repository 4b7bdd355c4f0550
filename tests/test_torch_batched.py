"""The port's batched runs (``BatchedFederationSpec`` through
``repro_torch.chain.simlax.LaxSimulator``) on the CPU: member by member
bitwise its single run on every delivery engine (heterogeneous attacker
sheets, dead sets, stragglers, countdowns, membership, per-member seeds,
the int8 wire and LeNet), held to the JAX package's batched members on
fixed intervals and deterministic attacks, plus the max-over-batch budgets,
the validation errors and the batched overflow naming its federation
(tests/test_batched.py's contracts, held here on the port)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.chain import attacks as j_attacks                     # noqa: E402
from repro.chain import scenarios as j_scenarios                 # noqa: E402
from repro.chain import simlax as j_simlax                       # noqa: E402
from repro.core import topology as j_topology                    # noqa: E402
from repro.core.reputation import IMPL2 as J_IMPL2               # noqa: E402

from repro_torch import tree                                     # noqa: E402
from repro_torch.chain import attacks as p_attacks               # noqa: E402
from repro_torch.chain import scenarios as p_scenarios           # noqa: E402
from repro_torch.chain import simlax as p_simlax                 # noqa: E402
from repro_torch.core import topology as p_topology              # noqa: E402
from repro_torch.core.reputation import IMPL2 as P_IMPL2         # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches         # noqa: E402

from test_torch_simlax import _assert_same_run                   # noqa: E402

ENGINES = ("compact", "sparse", "dense")


def _hetero_specs(attacks, n, *, deterministic=False):
    """tests/test_batched.py's eight federations, no two alike: mixed
    attacks, a dead node, a straggler, an explicit countdown, honest
    baselines. ``deterministic`` swaps the random attacks for signflip
    (gaussian -> signflip, intermittent's inner gaussian -> signflip)."""
    gauss = "signflip" if deterministic else "gaussian"
    inter = (attacks.make("intermittent", inner="signflip") if deterministic
             else "intermittent")
    build = attacks.FederationSpec.build
    return [
        build(n, malicious=(0,), attack=gauss),
        build(n, malicious={2: "signflip", 5: gauss}, stragglers={7: 2}),
        build(n, malicious=(1, 3), attack="scaled", dead=(n - 1,)),
        build(n),
        build(n, malicious=(4,), attack="freerider"),
        build(n, malicious=(0, 2), attack=inter,
              initial_countdown=[1 + (3 * i) % 7 for i in range(n)]),
        build(n, dead=(2, 5)),
        build(n, malicious=(6,), attack="signflip", stragglers={1: 3}),
    ]


def _cfg(simlax, ticks, seed=0, delivery="compact", interval=(8, 12),
         **kw):
    return simlax.SimLaxConfig(ticks=ticks, train_interval=interval,
                               latency=2, ttl=2, record_every=10, seed=seed,
                               delivery=delivery, **kw)


def _lax(sc, topo, spec, cfg, params0=None):
    return p_simlax.LaxSimulator(sc, topo, spec, P_IMPL2, cfg,
                                 device="cpu").run(params0)


def _assert_member_is_single(batched, single, b, what):
    """tests/test_batched.py's comparison: params, reputation, accuracy
    history, record ticks, sent, the counters and the integer final state,
    all bitwise."""
    ctx = f"federation {b}, {what}"
    for a, c in zip(tree.leaves(batched.params), tree.leaves(single.params)):
        assert np.array_equal(a, c), f"params diverged: {ctx}"
    assert np.array_equal(batched.reputation, single.reputation), ctx
    assert np.array_equal(batched.acc_history, single.acc_history), ctx
    assert np.array_equal(batched.record_ticks, single.record_ticks), ctx
    for a, c in zip(tree.leaves(batched.sent), tree.leaves(single.sent)):
        assert np.array_equal(a, c), f"sent diverged: {ctx}"
    for k in ("broadcasts", "deliveries", "fedavg_rounds",
              "max_tick_deliveries"):
        assert batched.stats[k] == single.stats[k], f"{k}: {ctx}"
    np.testing.assert_array_equal(batched.stats["broadcasts_per_node"],
                                  single.stats["broadcasts_per_node"])
    for k in ("arrive", "w_sum", "buf_cnt", "min_acc", "min_sender",
              "next_train"):
        assert np.array_equal(batched.final_state[k],
                              single.final_state[k]), f"{k}: {ctx}"


def _batch_and_singles(sc, topo, specs, seeds, cfg, params0=None):
    res = _lax(sc, topo, p_attacks.BatchedFederationSpec.build(specs, seeds),
               cfg, params0)
    assert len(res) == len(specs)
    singles = [_lax(sc, topo, spec, dataclasses.replace(cfg, seed=seed), params0)
               for spec, seed in zip(specs, seeds)]
    return res, singles


@pytest.mark.parametrize("engine", ENGINES)
def test_batched_eight_matches_singles_bitwise(engine):
    """The acceptance pin: one batched run over 8 heterogeneous specs with
    per-member seeds == 8 single runs, bit for bit, on every engine (random
    intervals and randomized attacks: the port's own draws)."""
    n, ticks = 16, 48
    specs = _hetero_specs(p_attacks, n)
    seeds = [3 * b + 1 for b in range(len(specs))]
    res, singles = _batch_and_singles(
        p_scenarios.toy_scenario(n, dim=8), p_topology.kregular(n, 2), specs,
        seeds, _cfg(p_simlax, ticks, delivery=engine))
    for b, (bres, single) in enumerate(zip(res, singles)):
        _assert_member_is_single(bres, single, b, engine)
        assert bres.stats["federation_index"] == b
        assert bres.stats["batch_size"] == len(specs)
        assert bres.stats["seed"] == seeds[b]
        assert "federation_index" not in single.stats
    assert sum(r.stats["deliveries"] for r in res) > 0


_JAX_BATCH = {}


def _jax_batch(n, ticks):
    if (n, ticks) not in _JAX_BATCH:
        specs = _hetero_specs(j_attacks, n, deterministic=True)
        _JAX_BATCH[n, ticks] = j_simlax.LaxSimulator(
            j_scenarios.toy_scenario(n, dim=8), j_topology.kregular(n, 2),
            j_attacks.BatchedFederationSpec.build(
                specs, [3 * b + 1 for b in range(len(specs))]),
            J_IMPL2, _cfg(j_simlax, ticks, interval=(8, 8))).run()
    return _JAX_BATCH[n, ticks]


@pytest.mark.parametrize("engine", ENGINES)
def test_batched_members_match_jax_batched(engine):
    """The port's batched members against the JAX package's, fixed
    intervals and deterministic attacks: events, integer state and
    reputations exact, floats within rtol 1e-6 (each port engine sums a
    receiver's receipts in the JAX compact engine's order)."""
    n, ticks = 16, 48
    specs = _hetero_specs(p_attacks, n, deterministic=True)
    res = _lax(p_scenarios.toy_scenario(n, dim=8), p_topology.kregular(n, 2),
               p_attacks.BatchedFederationSpec.build(
                   specs, [3 * b + 1 for b in range(len(specs))]),
               _cfg(p_simlax, ticks, delivery=engine, interval=(8, 8)))
    want = _jax_batch(n, ticks)
    assert len(res) == len(want)
    for b, (p, j) in enumerate(zip(res, want)):
        _assert_same_run(p, j)
        for k in ("federation_index", "batch_size", "seed"):
            assert p.stats[k] == j.stats[k], (b, k)
    assert sum(r.stats["fedavg_rounds"] for r in res) > 0


def test_batched_seeds_actually_differ():
    """Same spec at different seeds must NOT produce identical members:
    the seed axis is not dropped."""
    n = 12
    spec = p_attacks.FederationSpec.build(n, malicious=(0,))
    res = _lax(p_scenarios.toy_scenario(n, dim=8), p_topology.ring(n),
               p_attacks.BatchedFederationSpec.build([spec, spec], [0, 99]),
               _cfg(p_simlax, 40))
    assert any(not np.array_equal(a, c) for a, c in
               zip(tree.leaves(res[0].params), tree.leaves(res[1].params)))
    assert (res[0].stats["seed"], res[1].stats["seed"]) == (0, 99)


def test_batched_spec_validation():
    a, b = p_attacks.FederationSpec.build(8), p_attacks.FederationSpec.build(9)
    with pytest.raises(ValueError, match="num_nodes"):
        p_attacks.BatchedFederationSpec.build([a, b])
    with pytest.raises(ValueError, match="seeds"):
        p_attacks.BatchedFederationSpec.build([a, a], seeds=[1])
    with pytest.raises(ValueError):
        p_attacks.BatchedFederationSpec.build([])


def test_batched_spec_size_mismatch_names_member():
    """Mixed-size members are refused at spec build with the member index;
    a consistent batch against the wrong topology at simulator build, with
    'batch member {b}'."""
    with pytest.raises(ValueError, match="member 1"):
        p_attacks.BatchedFederationSpec.build(
            [p_attacks.FederationSpec.build(8), p_attacks.FederationSpec.build(12)])
    bspec = p_attacks.BatchedFederationSpec.build(
        [p_attacks.FederationSpec.build(12), p_attacks.FederationSpec.build(12)])
    with pytest.raises(ValueError, match="batch member 0"):
        p_simlax.LaxSimulator(p_scenarios.toy_scenario(8, dim=4),
                              p_topology.ring(8), bspec, P_IMPL2,
                              _cfg(p_simlax, 10), device="cpu")


def test_batch_budgets_take_max_over_members():
    """The shared budgets are the max over per-member budgets on each
    member's own dead-masked adjacency, equal to the JAX package's."""
    n, ttl, interval = 12, 2, (8, 12)
    topo = p_topology.kregular(n, 2)
    dead_sets = [(), (1, n - 1)]
    bb = p_topology.batch_budgets(topo.adj, ttl, interval, dead_sets)
    jb = j_topology.batch_budgets(topo.adj, ttl, interval, dead_sets)
    assert dataclasses.astuple(bb) == dataclasses.astuple(jb)
    assert bb.delivery == max(bb.per_federation_delivery)
    assert bb.compaction == max(bb.per_federation_compaction)
    assert bb.per_federation_delivery[1] <= bb.per_federation_delivery[0]
    bspec = p_attacks.BatchedFederationSpec.build(
        [p_attacks.FederationSpec.build(n, dead=d) for d in dead_sets])
    assert bspec.dead_sets() == tuple(tuple(d) for d in dead_sets)
    sim = p_simlax.LaxSimulator(
        p_scenarios.toy_scenario(n, dim=4), topo, bspec, P_IMPL2,
        p_simlax.SimLaxConfig(ticks=10, train_interval=interval, ttl=ttl),
        device="cpu")
    assert sim.delivery_budget == bb.delivery
    assert sim.compact_budget == bb.compaction
    assert sim.batch_size == 2


def test_batched_overflow_names_offending_federation():
    """A compact_budget override too small for ONE member fails with that
    member's index and the batch size (never a silent receipt drop)."""
    n = 10
    specs = [
        # member 0: one live broadcaster -> no deliveries at all
        p_attacks.FederationSpec.build(n, dead=tuple(range(1, n))),
        # member 1: everyone broadcasts on one tick -> n * (n - 1) due
        p_attacks.FederationSpec.build(n, initial_countdown=[2] * n),
    ]
    cfg = p_simlax.SimLaxConfig(ticks=12, train_interval=(8, 8), ttl=1,
                                record_every=4, compact_budget=2)
    sim = p_simlax.LaxSimulator(p_scenarios.toy_scenario(n, dim=4),
                                p_topology.full(n),
                                p_attacks.BatchedFederationSpec.build(specs),
                                P_IMPL2, cfg, device="cpu")
    with pytest.raises(RuntimeError, match=r"compact delivery overflow"
                       r".*federation \[1\] of the batch \(size 2\)"):
        sim.run()


@pytest.mark.parametrize("engine", ["compact", "dense"])
def test_batched_int8_matches_singles(engine):
    """The int8 wire: every member's payloads go through one round trip a
    training tick, and each member stays bitwise its single run; on CPU
    tensors no kernel launches."""
    n = 16
    specs = _hetero_specs(p_attacks, n)[:4]
    seeds = [5, 6, 7, 8]
    reset_launches()
    res, singles = _batch_and_singles(
        p_scenarios.toy_scenario(n, dim=8), p_topology.kregular(n, 2), specs,
        seeds, _cfg(p_simlax, 40, delivery=engine, compress="int8"))
    for b, (bres, single) in enumerate(zip(res, singles)):
        _assert_member_is_single(bres, single, b, f"{engine} int8")
    assert res[0].stats["broadcast_bytes"] == 8 + 2
    assert sum(LAUNCHES.values()) == 0


def test_batched_membership_matches_singles():
    """Members with and without churn in one batch: each member keeps its
    single run's countdown rule (frozen offline with churn, the static
    decrement without) and its rejoin decay."""
    n = 10
    ms = p_attacks.MembershipSchedule.build(
        [(4, (), (3,)), (9, (3,), ()), (12, (), (1,)), (18, (1,), ())])
    specs = [p_attacks.FederationSpec.build(n, malicious=(0,), membership=ms),
             p_attacks.FederationSpec.build(n, dead=(5,)),
             p_attacks.FederationSpec.build(n, malicious=(2,), attack="signflip")]
    res, singles = _batch_and_singles(
        p_scenarios.toy_scenario(n, dim=8), p_topology.kregular(n, 2), specs,
        [1, 2, 3], p_simlax.SimLaxConfig(ticks=40, train_interval=(5, 7),
                                         latency=1, ttl=2, record_every=8))
    for b, (bres, single) in enumerate(zip(res, singles)):
        _assert_member_is_single(bres, single, b, "membership")
    assert (res[0].reputation[:, 3] < 1).any()     # the rejoin decay showed


def test_batched_lenet_matches_singles():
    """LeNet batched == singles, bitwise on params and accuracies
    (tests/test_batched.py:216 at its size: n 4, 12 ticks, one SGD step a
    training action); training, eval and test run one stacked call a
    member."""
    n, ticks = 4, 12
    sc = p_scenarios.lenet_scenario(n, pool=64, eval_size=16, test_size=64,
                                    train_steps=1, batch=8)
    specs = [p_attacks.FederationSpec.build(n, malicious=(0,), attack="gaussian"),
             p_attacks.FederationSpec.build(n)]
    cfg = p_simlax.SimLaxConfig(ticks=ticks, train_interval=(4, 4), ttl=1,
                                record_every=4)
    res, singles = _batch_and_singles(sc, p_topology.full(n), specs, [0, 1], cfg)
    for b, (bres, single) in enumerate(zip(res, singles)):
        _assert_member_is_single(bres, single, b, "lenet")
    assert not np.array_equal(res[0].params["c1"]["w"], res[1].params["c1"]["w"])


def test_batched_hypothesis_matches_singles():
    """Property sweep (tests/test_batched.py's): random role sheets and
    seeds, batched == singles bitwise on the compact engine."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    n, ticks = 10, 30
    topo = p_topology.kregular(n, 2)
    sc = p_scenarios.toy_scenario(n, dim=4)
    names = st.sampled_from(sorted(p_attacks.names()))
    spec_st = st.builds(
        lambda mal, dead: p_attacks.FederationSpec.build(
            n, malicious=mal, dead=tuple(d for d in dead if d not in mal)),
        st.dictionaries(st.integers(0, n - 1), names, max_size=3),
        st.sets(st.integers(0, n - 1), max_size=2))

    @hyp.settings(max_examples=6, deadline=None,
                  suppress_health_check=list(hyp.HealthCheck))
    @hyp.given(st.lists(spec_st, min_size=2, max_size=3),
               st.lists(st.integers(0, 2 ** 16), min_size=3, max_size=3))
    def prop(specs, seeds):
        seeds = seeds[:len(specs)]
        res, singles = _batch_and_singles(sc, topo, specs, seeds,
                                          _cfg(p_simlax, ticks))
        for b, (bres, single) in enumerate(zip(res, singles)):
            _assert_member_is_single(bres, single, b, "hypothesis")

    prop()


# ========================================================= role-sheet accessors
def test_attack_union_matches_jax():
    """attack_union's (attack, (B, N) mask, (B,) folds) triples, member-major
    first-appearance order, and the spec accessors it rests on, equal to
    the JAX package's."""
    n = 16
    pairs = list(zip(_hetero_specs(p_attacks, n), _hetero_specs(j_attacks, n)))
    pb = p_attacks.BatchedFederationSpec.build([p for p, _ in pairs], range(8))
    jb = j_attacks.BatchedFederationSpec.build([j for _, j in pairs], range(8))
    pu, ju = pb.attack_union(), jb.attack_union()
    assert [a.name for a, _, _ in pu] == [a.name for a, _, _ in ju]
    for (_, pm, pf), (_, jm, jf) in zip(pu, ju):
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(pf, jf)
        assert pf.dtype == jf.dtype == np.int32
    assert (pb.batch_size, pb.num_nodes) == (jb.batch_size, jb.num_nodes)
    assert pb.resolved_seeds(7) == jb.resolved_seeds(7)
    unseeded = p_attacks.BatchedFederationSpec.build([pairs[0][0]] * 3)
    assert unseeded.resolved_seeds(7) == (7, 7, 7)
    assert pb.dead_sets() == jb.dead_sets()
    for p, j in pairs:
        assert p.straggler_map() == j.straggler_map()
        for (pa, _), (ja, _) in zip(p.attack_groups(), j.attack_groups()):
            assert p.attack_fold_of(pa) == j.attack_fold_of(ja)
    assert pairs[0][0].attack_fold_of(p_attacks.get("scaled")) is None
    assert p_attacks.FederationSpec.honest(n) == p_attacks.FederationSpec.build(n)
