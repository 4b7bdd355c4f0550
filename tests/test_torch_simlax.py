"""The port's vectorized engine (``repro_torch.chain.simlax.LaxSimulator``)
held against the JAX package's, against the port's heap engine, and against
itself across its dense, sparse and compact delivery engines, on the CPU.

Against JAX. Both packages get the same scenario data, role sheet,
topology and config, with fixed train intervals and deterministic attacks
(the two packages' random draws differ). The port's three engines sum each
receiver's receipts in one order, the order of the JAX compact engine's
scatter-add, so each is held bit for bit to JAX's compact engine: stats,
per-node broadcasts, the integer final state and reputations exactly,
params / ``w_sum`` / accuracies within rtol 1e-6. Against JAX's engine of
the same name the event stream (the schedule-determined state) is exact;
XLA's dot sums JAX's sparse and dense engines' receipts in another order,
and on these synchronised schedules the toy's honest models come within an
ulp of each other, so JAX's own engines then disagree on which sender a
round punishes.

The toy step ``w + LR * (target - w)`` is one fused multiply-add in both
packages (XLA contracts it; the port rounds once through float64).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)
jax = pytest.importorskip("jax")

from repro.chain import attacks as j_attacks                     # noqa: E402
from repro.chain import scenarios as j_scenarios                 # noqa: E402
from repro.chain import simlax as j_simlax                       # noqa: E402
from repro.core import topology as j_topology                    # noqa: E402
from repro.core.reputation import IMPL2 as J_IMPL2               # noqa: E402

from repro_torch import convert, tree                            # noqa: E402
from repro_torch.chain import attacks as p_attacks               # noqa: E402
from repro_torch.chain import scenarios as p_scenarios           # noqa: E402
from repro_torch.chain import simlax as p_simlax                 # noqa: E402
from repro_torch.core import topology as p_topology              # noqa: E402
from repro_torch.core.reputation import IMPL2 as P_IMPL2         # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches         # noqa: E402

from test_torch_federation import _assert_params_close, _numpy_init  # noqa: E402

JAX = (j_attacks, j_scenarios, j_simlax, j_topology, J_IMPL2)
PORT = (p_attacks, p_scenarios, p_simlax, p_topology, P_IMPL2)
ENGINES = ("compact", "sparse", "dense")
SCHEDULE_KEYS = ("arrive", "buf_cnt", "next_train")

# tests/test_simlax.py's five engine-parity cases (kind, kw, ttl, latency,
# dead, stragglers, malicious, attack), the random attacks swapped for
# deterministic ones: gaussian -> signflip, intermittent's gaussian inner
# attack -> signflip
CASES = [
    ("full", {}, 2, 1, (), None, (0,), "signflip"),
    ("ring", {}, 3, 2, (), None, (), "signflip"),
    ("kregular", {"degree": 3}, 2, 1, (5,), {1: 4}, (2,), "signflip"),
    ("erdos", {"p": 0.3}, 2, 2, (3,), None, (0, 1),
     ("intermittent", {"inner": "signflip"})),
    ("smallworld", {"degree": 2, "beta": 0.3}, 1, 1, (), {0: 3}, (4,),
     "freerider"),
]


def _toy_run(pkg, case, engine, *, n=14, ticks=90, fixed=True, seed=0,
             compress=None):
    attacks, scenarios, simlax, topology, rep = pkg
    kind, kw, ttl, latency, dead, strag, mal, attack = case
    if isinstance(attack, tuple):
        attack = attacks.make(attack[0], **attack[1])
    lo = ttl * latency + 1          # out of the re-broadcast-overwrite regime
    spec = attacks.FederationSpec.build(
        n, malicious=mal, attack=attack, dead=dead, stragglers=strag,
        initial_countdown=[1 + (3 * i) % lo for i in range(n)])
    cfg = simlax.SimLaxConfig(
        ticks=ticks, train_interval=(lo, lo if fixed else lo + 4),
        latency=latency, ttl=ttl, record_every=max(1, ticks // 5), seed=seed,
        delivery=engine, compress=compress)
    kwargs = {"device": "cpu"} if simlax is p_simlax else {}
    return simlax.LaxSimulator(
        scenarios.toy_scenario(n, dim=8, malicious=mal),
        topology.make(kind, n, seed=2, **kw), spec, rep, cfg, **kwargs).run()


def _assert_schedule_equal(a, b):
    for k in ("broadcasts", "deliveries", "max_tick_deliveries"):
        assert a.stats[k] == b.stats[k], (k, a.stats[k], b.stats[k])
    np.testing.assert_array_equal(a.stats["broadcasts_per_node"],
                                  b.stats["broadcasts_per_node"])
    for k in SCHEDULE_KEYS:
        np.testing.assert_array_equal(a.final_state[k], b.final_state[k],
                                      err_msg=k)


def _assert_same_run(a, b, *, rtol=1e-6):
    """Integers and reputations exact, floats within ``rtol``."""
    _assert_schedule_equal(a, b)
    assert a.stats["fedavg_rounds"] == b.stats["fedavg_rounds"]
    np.testing.assert_array_equal(a.final_state["min_sender"],
                                  b.final_state["min_sender"])
    np.testing.assert_array_equal(a.reputation, b.reputation)
    for k in ("w_sum", "min_acc"):
        np.testing.assert_allclose(a.final_state[k], b.final_state[k],
                                   rtol=rtol, atol=0, err_msg=k)
    np.testing.assert_allclose(a.acc_history, b.acc_history, rtol=rtol, atol=0)
    for x, y in zip(jax.tree.leaves(a.params), jax.tree.leaves(b.params)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol,
                                   atol=0)


def _assert_bitwise(a, b):
    _assert_same_run(a, b, rtol=0)
    for x, y in zip(jax.tree.leaves(a.sent), jax.tree.leaves(b.sent)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


_JAX_RUNS = {}


def _jax_toy(ci, engine):
    if (ci, engine) not in _JAX_RUNS:
        _JAX_RUNS[ci, engine] = _toy_run(JAX, CASES[ci], engine)
    return _JAX_RUNS[ci, engine]


# ======================================================== port vs JAX lax
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("ci", range(len(CASES)), ids=[c[0] for c in CASES])
def test_toy_lax_matches_jax(ci, engine):
    port = _toy_run(PORT, CASES[ci], engine)
    assert port.stats["deliveries"] > 0
    _assert_same_run(port, _jax_toy(ci, "compact"))
    _assert_schedule_equal(port, _jax_toy(ci, engine))
    assert port.stats["delivery"] == engine
    for k in ("delivery_budget", "compact_budget", "broadcast_bytes",
              "wire_bytes"):
        assert port.stats[k] == _jax_toy(ci, engine).stats[k], k


def _lenet_pair(n=5, *, ticks=14, interval=3, membership=None):
    kw = dict(malicious=(0,), train_steps=0, pool=16, eval_size=16,
              test_size=32, batch=8)
    j_sc = j_scenarios.lenet_scenario(n, **kw)
    stacked = _numpy_init(j_sc)
    j_sc.init_params_stacked = lambda: stacked
    runs = []
    for pkg, sc in ((JAX, j_sc), (PORT, p_scenarios.lenet_scenario(n, **kw))):
        attacks, _, simlax, topology, rep = pkg
        ms = None if membership is None else \
            attacks.MembershipSchedule.build(membership)
        spec = attacks.FederationSpec.build(
            n, malicious=(0,), attack="signflip", membership=ms,
            initial_countdown=[1 + i % interval for i in range(n)])
        cfg = simlax.SimLaxConfig(
            ticks=ticks, train_interval=(interval, interval), latency=1,
            ttl=2, record_every=4, compress="int8")
        if simlax is p_simlax:
            sim = simlax.LaxSimulator(sc, topology.kregular(n, 2), spec, rep,
                                      cfg, device="cpu")
            params0 = convert.params_from_jax(
                jax.tree.map(np.asarray, stacked), "cpu")
            runs.append(sim.run(params0))
        else:
            runs.append(simlax.LaxSimulator(
                sc, topology.kregular(n, 2), spec, rep, cfg).run())
    return runs


def test_lenet_compact_int8_matches_jax():
    """LeNet-5 at small width, no training (no random draw left), signflip,
    int8 wire, compact engine: the event stream and reputations exact,
    params under the int8 boundary-flip rule of
    tests/test_torch_federation.py; on CPU tensors no kernel launches."""
    reset_launches()
    j_res, p_res = _lenet_pair()
    assert p_res.stats["fedavg_rounds"] > 0
    _assert_schedule_equal(p_res, j_res)
    assert p_res.stats["fedavg_rounds"] == j_res.stats["fedavg_rounds"]
    np.testing.assert_array_equal(p_res.final_state["min_sender"],
                                  j_res.final_state["min_sender"])
    np.testing.assert_array_equal(p_res.reputation, j_res.reputation)
    np.testing.assert_array_equal(p_res.acc_history, j_res.acc_history)
    np.testing.assert_allclose(p_res.final_state["w_sum"],
                               j_res.final_state["w_sum"], rtol=1e-6)
    _assert_params_close(j_res.params, tree.map(torch.as_tensor, p_res.params))
    # the attacker never commits: its quantized payload is bitwise JAX's
    for k in ("c1", "f1", "out"):
        np.testing.assert_array_equal(p_res.sent[k]["w"][0],
                                      np.asarray(j_res.sent[k]["w"])[0])
    assert p_res.stats["broadcast_bytes"] == j_res.stats["broadcast_bytes"]
    assert sum(LAUNCHES.values()) == 0


def test_membership_compact_matches_jax():
    """A join / leave / rejoin schedule through the compact engine: offline
    receivers lose their deliveries, countdowns freeze, the rejoiner's
    reputation column decays — exactly as in the JAX engine."""
    j_res, p_res = _lenet_pair(
        6, ticks=24, membership=[(4, (), (3,)), (9, (3,), ()),
                                 (12, (), (1,)), (18, (1,), ())])
    _assert_schedule_equal(p_res, j_res)
    np.testing.assert_array_equal(p_res.reputation, j_res.reputation)
    assert p_res.stats["fedavg_rounds"] == j_res.stats["fedavg_rounds"]
    _assert_params_close(j_res.params, tree.map(torch.as_tensor, p_res.params))
    assert (p_res.reputation[:, 3] < 1).any()     # the rejoin decay showed


# ================================================== port engines agree
@pytest.mark.parametrize("attack", [None, "gaussian", "intermittent"])
@pytest.mark.parametrize("ci", range(len(CASES)), ids=[c[0] for c in CASES])
def test_port_engines_agree_bitwise(ci, attack):
    """compact == sparse == dense on the port, bit for bit, with random
    train intervals and randomized attacks."""
    case = CASES[ci] if attack is None else CASES[ci][:-1] + (attack,)
    runs = [_toy_run(PORT, case, e, fixed=False, seed=ci) for e in ENGINES]
    assert runs[0].stats["deliveries"] > 0
    _assert_bitwise(runs[0], runs[1])
    _assert_bitwise(runs[1], runs[2])


@pytest.mark.parametrize("attack", ["gaussian", "signflip"])
def test_port_engines_agree_bitwise_int8(attack):
    runs = [_toy_run(PORT, CASES[2][:-1] + (attack,), e, fixed=False,
                     compress="int8") for e in ENGINES]
    _assert_bitwise(runs[0], runs[1])
    _assert_bitwise(runs[1], runs[2])
    raw = _toy_run(PORT, CASES[2][:-1] + (attack,), "compact", fixed=False)
    assert not np.array_equal(raw.sent["w"], runs[0].sent["w"])
    # dim 8: 8 int8 values + one bf16 scale, against 8 fp32 values
    assert (runs[0].stats["broadcast_bytes"], raw.stats["broadcast_bytes"]) \
        == (8 + 2, 8 * 4)


def test_port_engines_agree_property():
    """Hypothesis sweep (tests/test_simlax.py's): random topology / ttl /
    latency / dead / straggler / attack combinations never separate the
    port's compact, sparse and dense engines."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=8, deadline=None,
                  suppress_health_check=list(hyp.HealthCheck))
    @hyp.given(data=st.data())
    def run(data):
        n = data.draw(st.integers(6, 12), label="n")
        kind = data.draw(st.sampled_from(
            ["full", "ring", "kregular", "erdos", "smallworld"]), label="kind")
        ttl = data.draw(st.integers(1, 3), label="ttl")
        latency = data.draw(st.integers(1, 2), label="latency")
        seed = data.draw(st.integers(0, 5), label="seed")
        dead = data.draw(st.sets(st.integers(0, n - 1), max_size=2),
                         label="dead")
        mal = data.draw(st.sets(st.integers(0, n - 1), max_size=2),
                        label="malicious")
        attack = data.draw(st.sampled_from(sorted(p_attacks.names())),
                           label="attack")
        strag = data.draw(st.dictionaries(
            st.integers(0, n - 1), st.integers(2, 4), max_size=2),
            label="stragglers")
        topo = p_topology.make(kind, n, degree=2, p=0.4, seed=seed)
        lo = ttl * latency + 1
        spec = p_attacks.FederationSpec.build(
            n, malicious=tuple(mal), attack=attack, dead=tuple(dead),
            stragglers=strag,
            initial_countdown=[1 + (3 * i) % (lo + 2) for i in range(n)])
        runs = []
        for engine in ENGINES:
            cfg = p_simlax.SimLaxConfig(
                ticks=50, train_interval=(lo, lo + 3), latency=latency,
                ttl=ttl, record_every=10, seed=seed, delivery=engine)
            runs.append(p_simlax.LaxSimulator(
                p_scenarios.toy_scenario(n, dim=4, malicious=tuple(mal),
                                         seed=seed),
                topo, spec, P_IMPL2, cfg, device="cpu").run())
        _assert_bitwise(runs[0], runs[1])
        _assert_bitwise(runs[1], runs[2])

    run()


# ====================================================== stacked LeNet
def test_stacked_lenet_matches_per_node(monkeypatch):
    """train_stacked / eval_stacked / test_stacked against the per-node
    functions at rtol 1e-5, with the stacked evaluation cut into chunks."""
    monkeypatch.setattr(p_scenarios, "EVAL_PAIRS", 24)
    n = 4
    sc = p_scenarios.lenet_scenario(n, pool=16, eval_size=8, test_size=12,
                                    train_steps=2, batch=4)
    params = sc.init_params_stacked("cpu")
    data, ed = sc.train_data("cpu"), sc.eval_data("cpu")
    rows = torch.tensor([0, 2, 3])
    trained = sc.train_stacked(params, torch.Generator().manual_seed(7), data,
                               rows)
    idx = torch.randint(0, 16, (n, 2, 4),
                        generator=torch.Generator().manual_seed(7))
    row = lambda t, i: tree.map(lambda x: x[i], t)          # noqa: E731
    for m, r in enumerate(rows.tolist()):
        want = sc.sgd(row(params, r), row(data, r), idx[r])
        for a, b in zip(tree.leaves(row(trained, m)), tree.leaves(want)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    src = torch.tensor([3, 0, 1, 1, 2])
    rcv = torch.tensor([0, 0, 1, 2, 3])
    got = sc.eval_stacked(row(params, src), row(ed, rcv))
    want = torch.stack([sc.eval_fn(row(params, s), row(ed, r))
                        for s, r in zip(src.tolist(), rcv.tolist())])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    torch.testing.assert_close(
        sc.test_stacked(params),
        torch.stack([sc.test_fn(row(params, i)) for i in range(n)]),
        rtol=1e-5, atol=0)


# ===================================================== edge cases, errors
def _toy_sim(n=8, *, countdown, ticks, interval, latency=1, ttl=1,
             dead=(), **cfg):
    sc = p_scenarios.toy_scenario(n)
    spec = p_attacks.FederationSpec.build(n, initial_countdown=countdown,
                                          dead=dead)
    c = p_simlax.SimLaxConfig(ticks=ticks, train_interval=(interval, interval),
                              latency=latency, ttl=ttl, record_every=2,
                              seed=0, **cfg)
    return sc, p_simlax.LaxSimulator(sc, p_topology.full(n), spec, P_IMPL2,
                                     c, device="cpu")


def test_compact_budget_override_raises():
    _, sim = _toy_sim(countdown=[3] * 8, ticks=20, interval=5,
                      compact_budget=5)
    assert sim.compact_budget == 5
    with pytest.raises(RuntimeError, match="compact delivery overflow"):
        sim.run()
    with pytest.raises(ValueError, match="compact_budget"):
        _toy_sim(countdown=[3] * 8, ticks=2, interval=5, compact_budget=0)


def test_compact_buffer_exactly_full():
    """Every (dst, src) pair of a full graph due on one tick: the due count
    hits the exact bound n * (n - 1) and the engines still agree."""
    runs = []
    for engine in ENGINES:
        _, sim = _toy_sim(countdown=[3] * 8, ticks=40, interval=5,
                          delivery=engine)
        runs.append(sim.run())
    assert runs[0].stats["compact_budget"] == 8 * 7
    assert runs[0].stats["max_tick_deliveries"] == 8 * 7
    _assert_bitwise(runs[0], runs[1])
    _assert_bitwise(runs[1], runs[2])


def test_zero_delivery_ticks_and_all_dead():
    _, sim = _toy_sim(countdown=[2] * 8, ticks=4, interval=12, latency=10)
    res = sim.run()
    assert res.stats["deliveries"] == 0 and res.stats["broadcasts"] == 8
    assert np.isfinite(res.acc_history).all()
    assert (res.final_state["w_sum"] == 0).all()
    sc, sim = _toy_sim(6, countdown=None, ticks=30, interval=4, ttl=2,
                       dead=tuple(range(6)))
    assert sim.compact_budget == 1
    res = sim.run()
    assert res.stats["broadcasts"] == 0 and res.stats["deliveries"] == 0
    np.testing.assert_array_equal(res.params["w"], sc.init_w)


@pytest.mark.parametrize("what", ["sharded", "batched"])
def test_unported_paths_raise(what):
    """The sharded engine needs one rank a shard: more shards than ranks is
    refused, naming the launcher; a batch on it is refused with the JAX
    package's ValueError (batches run on the other engines)."""
    sc = p_scenarios.toy_scenario(4)
    spec = p_attacks.FederationSpec.build(4)
    cfg = dataclasses.replace(p_simlax.SimLaxConfig(ticks=2), delivery="sharded")
    if what == "sharded":
        cfg = dataclasses.replace(cfg, shards=2)
        error, match = ValueError, "launch.mesh.spawn"
    else:
        spec = p_attacks.BatchedFederationSpec.build([spec, spec])
        error, match = ValueError, "BatchedFederationSpec"
    with pytest.raises(error, match=match):
        p_simlax.LaxSimulator(sc, p_topology.full(4), spec, P_IMPL2, cfg,
                              device="cpu")


def test_validation_and_cuda_default():
    sc = p_scenarios.toy_scenario(4)
    spec = p_attacks.FederationSpec.build(4)
    topo = p_topology.full(4)
    for bad in (dict(compress="fp8"), dict(delivery="nope"), dict(latency=0),
                dict(shards=2)):
        with pytest.raises(ValueError):
            p_simlax.LaxSimulator(sc, topo, spec, P_IMPL2,
                                  p_simlax.SimLaxConfig(**bad), device="cpu")
    with pytest.warns(UserWarning, match="re-broadcast"):
        p_simlax.LaxSimulator(sc, topo, spec, P_IMPL2,
                              p_simlax.SimLaxConfig(train_interval=(1, 1)),
                              device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            p_simlax.LaxSimulator(sc, topo, spec, P_IMPL2,
                                  p_simlax.SimLaxConfig())
