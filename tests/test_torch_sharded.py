"""delivery="sharded": the port's compact engine with its receivers
partitioned over the ranks of a process group, the counterpart of
tests/test_sharded.py.

In process (no process group) the engine runs one shard, S = 1, with no
exchange: bitwise the compact engine, toy and LeNet. Across ranks (gloo,
started through ``repro_torch.launch.mesh.spawn``) the toy stays bitwise
the compact engine at S = 2, 4 and 8: its stacked calls give each model
the same bits whatever their count. LeNet at S = 2 is held by its event
counts and schedule exactly and its params within ``LENET_ATOL``: a rank's
stacked train and eval calls see its own receivers' models, not the
compact engine's count, and a stacked LeNet step changes its last bits
with the count. Each S runs all its cases in one spawn, shared by the
tests that read it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)

from repro_torch import tree                                       # noqa: E402
from repro_torch.chain import scenarios, simlax                    # noqa: E402
from repro_torch.chain.attacks import (BatchedFederationSpec,      # noqa: E402
                                       FederationSpec, MembershipSchedule)
from repro_torch.core import topology as T                         # noqa: E402
from repro_torch.core.reputation import IMPL2                      # noqa: E402
from repro_torch.launch import mesh as mesh_lib                    # noqa: E402

SPAWN_TIMEOUT = 150
# LeNet at S = 2 against compact: the largest param difference measured on
# the CPU was 9.6e-5 (n 8, 24 ticks); the bound leaves a decade of room
LENET_ATOL = 1e-3


def _cfg(engine, *, ticks=48, interval=6, ttl=2, compress=None, shards=None,
         **kw):
    return simlax.SimLaxConfig(
        ticks=ticks, train_interval=(interval, interval), latency=1, ttl=ttl,
        record_every=8, seed=0, delivery=engine, compress=compress,
        shards=shards, **kw)


def _run(sc, topo, spec, cfg, device="cpu"):
    return simlax.LaxSimulator(sc, topo, spec, IMPL2, cfg, device=device).run()


def _assert_schedule_equal(a, b):
    for k in ("broadcasts", "deliveries", "fedavg_rounds",
              "max_tick_deliveries"):
        assert a.stats[k] == b.stats[k], (k, a.stats[k], b.stats[k])
    np.testing.assert_array_equal(a.stats["broadcasts_per_node"],
                                  b.stats["broadcasts_per_node"])
    for k in ("arrive", "buf_cnt", "next_train"):
        np.testing.assert_array_equal(a.final_state[k], b.final_state[k],
                                      err_msg=k)


def _assert_bitwise(a, b):
    """The whole result, bit for bit (tests/test_sharded.py's pin)."""
    _assert_schedule_equal(a, b)
    for k in a.final_state:
        np.testing.assert_array_equal(a.final_state[k], b.final_state[k],
                                      err_msg=k)
    np.testing.assert_array_equal(a.reputation, b.reputation)
    np.testing.assert_array_equal(a.acc_history, b.acc_history)
    for x, y in zip(tree.leaves(a.params) + tree.leaves(a.sent),
                    tree.leaves(b.params) + tree.leaves(b.sent)):
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------- the cases
def _small_toy(compress=None, membership=False):
    """tests/test_sharded.py's single-device case: n 8, full graph."""
    n, interval = 8, 6
    ms = None
    if membership:
        ms = MembershipSchedule.build(
            [(8, (), (3,)), (20, (3,), ()), (30, (), (5,))], rejoin_decay=0.5)
    spec = FederationSpec.build(
        n, malicious=(0,), membership=ms,
        initial_countdown=[3 + (7 * i) % interval for i in range(n)])
    return (scenarios.toy_scenario(n, dim=8, malicious=(0,)), T.full(n), spec,
            _cfg("compact", compress=compress))


def _toy_cases():
    """tests/test_sharded.py:163's 8-device case: n 16, kregular(16, 3),
    attackers (0, 5), ttl 2, 48 ticks, the wire off and int8, then churn."""
    n, interval = 16, 6
    sc = scenarios.toy_scenario(n, dim=8, malicious=(0, 5))
    topo = T.kregular(n, 3)
    cd = [3 + (7 * i) % interval for i in range(n)]
    cases = [(sc, topo, FederationSpec.build(n, malicious=(0, 5),
                                             initial_countdown=cd),
              _cfg("compact", compress=c)) for c in (None, "int8")]
    ms = MembershipSchedule.build(
        [(7, (), (3, 11)), (19, (3,), ()), (29, (11,), ()), (37, (), (6,))],
        rejoin_decay=0.5, initial_offline=(9,))
    cases.append((sc, topo, FederationSpec.build(
        n, malicious=(0, 5), initial_countdown=cd, membership=ms),
        _cfg("compact")))
    return cases


def _lenet_case():
    """tests/test_sharded.py's LeNet case: n 8, gaussian poisoning of node
    0, kregular(8, 2), 24 ticks, one SGD step of batch 8 a training."""
    n, interval = 8, 6
    sc = scenarios.lenet_scenario(n, malicious=(0,), pool=32, eval_size=8,
                                  test_size=32, train_steps=1, batch=8)
    spec = FederationSpec.build(
        n, malicious=(0,),
        initial_countdown=[3 + (7 * i) % interval for i in range(n)])
    return sc, T.kregular(n, 2), spec, _cfg("compact", ticks=24)


def _sharded(cfg, shards=None):
    return dataclasses.replace(cfg, delivery="sharded", shards=shards)


def _ranks(rank, dev, world):
    out = {"toy": [_run(sc, topo, spec, _sharded(cfg), dev)
                   for sc, topo, spec, cfg in _toy_cases()]}
    if world == 2:
        sc, topo, spec, cfg = _lenet_case()
        out["lenet"] = _run(sc, topo, spec, _sharded(cfg), dev)
    if world == 4:
        # an override below the per-shard bound: every rank raises, after
        # the run's gather, with the same message
        sc, topo, spec, cfg = _toy_cases()[0]
        sim = simlax.LaxSimulator(
            sc, topo, spec, IMPL2,
            _sharded(dataclasses.replace(cfg, compact_budget=3)), device=dev)
        try:
            sim.run()
            msg = None
        except RuntimeError as e:
            msg = str(e)
        msgs = [None] * world
        torch.distributed.all_gather_object(msgs, (msg, sim.shard_budget))
        out["overflow"] = msgs
    return out


_SPAWNED = {}


def _spawned(world):
    if world not in _SPAWNED:
        _SPAWNED[world] = mesh_lib.spawn(_ranks, world, device="cpu",
                                         timeout=SPAWN_TIMEOUT, args=(world,))
    return _SPAWNED[world]


_COMPACT = {}


def _compact(name):
    if name not in _COMPACT:
        if name == "lenet":
            sc, topo, spec, cfg = _lenet_case()
            _COMPACT[name] = _run(sc, topo, spec, cfg)
        else:
            _COMPACT[name] = [_run(*case) for case in _toy_cases()]
    return _COMPACT[name]


# ========================================================= in process, S = 1
@pytest.mark.parametrize("compress", [None, "int8"])
def test_sharded_single_rank_matches_compact_bitwise(compress):
    sc, topo, spec, cfg = _small_toy(compress)
    a, b = _run(sc, topo, spec, cfg), _run(sc, topo, spec, _sharded(cfg))
    assert a.stats["deliveries"] > 0
    assert b.stats["shards"] == 1 and b.stats["delivery"] == "sharded"
    assert b.stats["max_shard_deliveries"] == b.stats["max_tick_deliveries"]
    assert b.stats["shard_budget"] == a.stats["compact_budget"]
    _assert_bitwise(a, b)


def test_sharded_single_rank_churn_matches_compact_bitwise():
    sc, topo, spec, cfg = _small_toy(membership=True)
    a, b = _run(sc, topo, spec, cfg), _run(sc, topo, spec, _sharded(cfg))
    assert a.stats["deliveries"] > 0
    _assert_bitwise(a, b)


def test_sharded_single_rank_lenet_matches_compact_bitwise():
    sc, topo, spec, cfg = _lenet_case()
    _assert_bitwise(_compact("lenet"), _run(sc, topo, spec, _sharded(cfg)))


def test_sharded_config_validation():
    n = 8
    sc = scenarios.toy_scenario(n, dim=4)
    spec = FederationSpec.build(n)

    def make(**kw):
        cfg = simlax.SimLaxConfig(ticks=8, train_interval=(6, 6), latency=1,
                                  ttl=1, record_every=4, **kw)
        return simlax.LaxSimulator(sc, T.full(n), spec, IMPL2, cfg,
                                   device="cpu")

    # shards= only means something on the sharded engine
    with pytest.raises(ValueError, match="shards"):
        make(delivery="compact", shards=2)
    # N must split evenly over the ranks
    with pytest.raises(ValueError, match="divisible"):
        make(delivery="sharded", shards=3)
    # no more shards than ranks: with no process group up, one
    with pytest.raises(ValueError, match="launch.mesh.spawn"):
        make(delivery="sharded", shards=2)
    with pytest.raises(ValueError, match=">= 1"):
        make(delivery="sharded", shards=0)
    assert make(delivery="sharded").shards == 1


def test_sharded_does_not_compose_with_batching():
    n = 8
    sc = scenarios.toy_scenario(n, dim=4)
    batch = BatchedFederationSpec.build(
        [FederationSpec.build(n), FederationSpec.build(n, malicious=(0,))])
    with pytest.raises(ValueError, match="[Bb]atched"):
        simlax.LaxSimulator(sc, T.full(n), batch, IMPL2, _cfg("sharded"),
                            device="cpu")


@pytest.mark.parametrize("compress", [None, "int8"])
def test_sharded_toy_matches_jax_compact(compress):
    """The port's sharded engine (one shard, in process) against the JAX
    package's compact engine, as tests/test_torch_simlax.py holds the
    port's engines: fixed intervals, a deterministic attack, dead and
    straggling nodes."""
    pytest.importorskip("jax")
    from test_torch_simlax import CASES, JAX, PORT, _assert_same_run, _toy_run
    case = CASES[2]          # kregular(14, 3), node 5 dead, a straggler
    port = _toy_run(PORT, case, "sharded", compress=compress)
    assert port.stats["deliveries"] > 0 and port.stats["shards"] == 1
    _assert_same_run(port, _toy_run(JAX, case, "compact", compress=compress))


# ===================================================== across ranks (gloo)
@pytest.mark.parametrize("world", [2, 4, 8])
def test_sharded_ranks_toy_matches_compact_bitwise(world):
    """tests/test_sharded.py:163's case, with attackers, the int8 wire and
    churn, at 2, 4 and 8 ranks: bit for bit the compact engine."""
    for a, b in zip(_compact("toy"), _spawned(world)["toy"]):
        assert a.stats["deliveries"] > 0
        assert b.stats["shards"] == world
        assert b.stats["max_shard_deliveries"] <= b.stats["shard_budget"]
        _assert_bitwise(a, b)


def test_sharded_two_ranks_lenet_counts_and_params():
    a, b = _compact("lenet"), _spawned(2)["lenet"]
    assert b.stats["shards"] == 2 and a.stats["deliveries"] > 0
    _assert_schedule_equal(a, b)
    for x, y in zip(tree.leaves(a.params), tree.leaves(b.params)):
        np.testing.assert_allclose(x, y, rtol=0, atol=LENET_ATOL)
    assert np.isfinite(b.acc_history).all()


def test_sharded_overflow_raises_on_every_rank():
    msgs = _spawned(4)["overflow"]
    for msg, budget in msgs:
        assert budget == 3
        assert msg is not None and "sharded delivery overflow" in msg
        assert "per-shard work buffer holds 3" in msg
    assert len({m for m, _ in msgs}) == 1
