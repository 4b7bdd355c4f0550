"""The port's heap federation held against the JAX package's, end to end.

Both packages build ``make_heap_simulator`` from the same scenario data,
role sheet, topology and config; the port's nodes start from the JAX
nodes' params (carried across with ``repro_torch.convert``). With
``train_steps=0`` and a deterministic attack no random draw is left, so the
event streams must agree exactly: stats, receipt accuracies, test-accuracy
records and reputations. The JAX nodes run Eq. 3 through the Pallas wfedavg
kernel in interpret mode; the port nodes through its wfedavg wrapper (the
plain version, on CPU tensors).

Params: Eq. 3 sums in another order than XLA, so they agree to ~1e-8, and
the int8 wire can turn that into one quantization step where an element
sits on a .5 boundary of its block's grid. Such a flip, averaged in by a
later FedAvg, is allowed on at most 1e-4 of a leaf's elements and at most
one step of that leaf's coarsest grid; everything else is held at 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.chain import attacks as j_attacks                     # noqa: E402
from repro.chain import scenarios as j_scenarios                 # noqa: E402
from repro.chain import simlax as j_simlax                       # noqa: E402
from repro.core import topology as j_topology                    # noqa: E402
from repro.core.reputation import IMPL2 as J_IMPL2               # noqa: E402

from repro_torch import convert                                  # noqa: E402
from repro_torch.chain import attacks as p_attacks               # noqa: E402
from repro_torch.chain import scenarios as p_scenarios           # noqa: E402
from repro_torch.chain import simlax as p_simlax                 # noqa: E402
from repro_torch.core import topology as p_topology              # noqa: E402
from repro_torch.core.reputation import IMPL2 as P_IMPL2         # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches         # noqa: E402

ATOL = 1e-5
FLIP_FRACTION = 1e-4


def _build_pair(j_sc, p_sc, n, *, attack, ticks, interval, compress):
    countdown = [1 + i % interval for i in range(n)]
    j_spec = j_attacks.FederationSpec.build(
        n, malicious=(0,), attack=attack, initial_countdown=countdown)
    p_spec = p_attacks.FederationSpec.build(
        n, malicious=(0,), attack=attack, initial_countdown=countdown)
    cfg = dict(ticks=ticks, train_interval=(interval, interval), latency=1,
               ttl=2, record_every=5, compress=compress)
    j_sim = j_scenarios.make_heap_simulator(
        j_sc, j_topology.kregular(n, 2), j_spec, J_IMPL2,
        j_simlax.SimLaxConfig(**cfg))
    p_sim = p_scenarios.make_heap_simulator(
        p_sc, p_topology.kregular(n, 2), p_spec, P_IMPL2,
        p_simlax.SimLaxConfig(**cfg), use_kernel=True, device="cpu")
    for j_node, p_node in zip(j_sim.nodes.values(), p_sim.nodes.values()):
        j_node.use_kernel = True      # Pallas wfedavg, interpret mode on CPU
        p_node.params = convert.params_from_jax(
            jax.tree.map(np.asarray, j_node.params), "cpu")
    return j_sim, p_sim


def _receipts(sim, node):
    """(creator, accuracy, received_at_ttl) of every receipt on the node's
    chain, creators by name (addresses come from per-run RSA keys)."""
    return [(sim._addr_to_name(r.creator.address), r.accuracy,
             r.received_at_ttl)
            for b in node.ledger.blocks for t in b.transactions
            for r in t.receipts]


def _by_name(sim, rep):
    return {sim._addr_to_name(a): v for a, v in rep.items()}


def _assert_same_events(j_sim, p_sim, *, acc_rtol=0.0):
    assert p_sim.stats == j_sim.stats
    for j_node, p_node in zip(j_sim.nodes.values(), p_sim.nodes.values()):
        assert p_node.name == j_node.name
        j_hist = np.asarray([a for _, a in j_node.accuracy_history])
        p_hist = np.asarray([a for _, a in p_node.accuracy_history])
        assert [t for t, _ in p_node.accuracy_history] == \
            [t for t, _ in j_node.accuracy_history]
        np.testing.assert_allclose(p_hist, j_hist, rtol=acc_rtol, atol=0)
        j_rc, p_rc = _receipts(j_sim, j_node), _receipts(p_sim, p_node)
        assert [(c, t) for c, _, t in p_rc] == [(c, t) for c, _, t in j_rc]
        np.testing.assert_allclose([a for _, a, _ in p_rc],
                                   [a for _, a, _ in j_rc], rtol=acc_rtol, atol=0)
        assert _by_name(p_sim, p_node.reputation) == \
            _by_name(j_sim, j_node.reputation)
        assert p_node.ledger.verify_chain(1)


def _assert_params_close(j_params, p_params):
    j_np = jax.tree.map(np.asarray, j_params)
    p_np = convert.params_to_numpy(p_params)
    for j_leaf, p_leaf in zip(jax.tree.leaves(j_np), jax.tree.leaves(p_np)):
        assert j_leaf.shape == p_leaf.shape
        diff = np.abs(j_leaf - p_leaf)
        off = diff > ATOL
        if off.any():
            step = np.abs(j_leaf).max() / 127.0   # coarsest int8 grid step
            assert off.mean() <= FLIP_FRACTION, off.mean()
            assert diff.max() <= step, (diff.max(), step)


def _numpy_init(j_sc, seed=0):
    """Stacked LeNet params drawn with numpy (fan-in-scaled, clipped normal
    weights, small random biases) in the JAX layouts; handed to the JAX
    scenario in place of its vmapped ``jax.random`` init, whose compile
    alone costs seconds on a CPU."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(j_sc.init_params_stacked)

    def draw(s):
        fan_in = int(np.prod(s.shape[1:-1])) if len(s.shape) > 2 else 1
        x = rng.standard_normal(s.shape).clip(-2, 2) / np.sqrt(fan_in)
        return jax.numpy.asarray(x.astype(np.float32) if len(s.shape) > 2
                                 else 0.1 * x.astype(np.float32))

    return jax.tree.map(draw, shapes)


def test_lenet_heap_federation_matches_jax():
    n = 5
    kw = dict(malicious=(0,), train_steps=0, pool=16, eval_size=16,
              test_size=32, batch=8)
    j_sc = j_scenarios.lenet_scenario(n, **kw)
    stacked = _numpy_init(j_sc)
    j_sc.init_params_stacked = lambda: stacked
    j_sim, p_sim = _build_pair(
        j_sc, p_scenarios.lenet_scenario(n, **kw),
        n, attack="signflip", ticks=16, interval=2, compress="int8")
    reset_launches()
    j_sim.run()
    p_sim.run()
    assert p_sim.stats["fedavg_rounds"] > 0
    _assert_same_events(j_sim, p_sim)
    for j_node, p_node in zip(j_sim.nodes.values(), p_sim.nodes.values()):
        _assert_params_close(j_node.params, p_node.params)
    # the attacker never commits, so its quantized payload is bitwise equal
    for k in ("c1", "f1", "out"):
        np.testing.assert_array_equal(
            np.asarray(j_sim.nodes["n0"].last_broadcast[k]["w"]),
            p_sim.nodes["n0"].last_broadcast[k]["w"].numpy())
    assert sum(LAUNCHES.values()) == 0    # CPU tensors never launch a kernel


def test_toy_heap_federation_matches_jax():
    """The toy scenario trains (deterministically), so params may drift by
    float epsilon between XLA and PyTorch: receipts and test accuracies are
    held at rtol 1e-6, stats and reputations exactly."""
    n = 5
    j_sim, p_sim = _build_pair(
        j_scenarios.toy_scenario(n, malicious=(0,)),
        p_scenarios.toy_scenario(n, malicious=(0,)),
        n, attack="scaled", ticks=16, interval=2, compress="int8")
    j_sim.run()
    p_sim.run()
    assert p_sim.stats["fedavg_rounds"] > 0
    _assert_same_events(j_sim, p_sim, acc_rtol=1e-6)
    for j_node, p_node in zip(j_sim.nodes.values(), p_sim.nodes.values()):
        _assert_params_close(j_node.params, p_node.params)
