"""The port's vectorized engine against the port's heap engine, on the CPU:
every attack's broadcasts bit for bit (the per-(seed, tick, fold, node)
attack generators are shared), and the aggregate dynamics of a poisoned
federation under the int8 wire (tests/test_simlax.py's heap-vs-lax
contracts, held here on the port)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)

from repro_torch.chain import attacks as p_attacks               # noqa: E402
from repro_torch.chain import scenarios as p_scenarios           # noqa: E402
from repro_torch.chain import simlax as p_simlax                 # noqa: E402
from repro_torch.chain.network import mean_reputation            # noqa: E402
from repro_torch.core import topology as p_topology              # noqa: E402
from repro_torch.core.reputation import IMPL2 as P_IMPL2         # noqa: E402


def _heap_and_lax(attack, *, compress, rep=P_IMPL2, n=8, ticks=60,
                  interval=8, malicious=(0, 3), countdown=None):
    sc = p_scenarios.toy_scenario(n, malicious=malicious)
    spec = p_attacks.FederationSpec.build(
        n, malicious=malicious, attack=attack,
        initial_countdown=countdown or [1 + (3 * i) % interval
                                        for i in range(n)])
    cfg = p_simlax.SimLaxConfig(ticks=ticks, train_interval=(interval, interval),
                                latency=1, ttl=2, record_every=10, seed=0,
                                compress=compress)
    topo = p_topology.full(n)
    heap = p_scenarios.make_heap_simulator(sc, topo, spec, rep, cfg,
                                           device="cpu")
    heap.run()
    res = p_simlax.LaxSimulator(sc, topo, spec, rep, cfg, device="cpu").run()
    return heap, res


@pytest.mark.parametrize("compress", [None, "int8"])
@pytest.mark.parametrize("attack", sorted(p_attacks.names()))
def test_attack_stream_matches_heap_bitwise(attack, compress):
    """tests/test_simlax.py:116's contract on the port: with FedAvg off (so
    committed params cannot drift between the engines' buffer windows),
    every node's last broadcast is the heap node's, bit for bit — the
    attackers' from the same per-(seed, tick, fold, node) generators."""
    rep = dataclasses.replace(P_IMPL2, buffer_size=10 ** 6)
    heap, res = _heap_and_lax(attack, compress=compress, rep=rep)
    assert res.stats["broadcasts"] == heap.stats["tx_sent"]
    assert res.stats["deliveries"] == heap.stats["tx_delivered"]
    for i, node in enumerate(heap.nodes.values()):
        np.testing.assert_array_equal(node.last_broadcast["w"].numpy(),
                                      res.sent["w"][i])


def test_heap_lax_aggregate_parity_int8():
    """tests/test_simlax.py:842 on the port: FedAvg on, int8 wire; event
    streams identical, aggregate accuracy / reputation within the JAX
    test's tolerances, the attacker isolated."""
    n, interval = 12, 12
    heap, res = _heap_and_lax(
        "gaussian", compress="int8", n=n, ticks=160, interval=interval,
        malicious=(0,), countdown=[3 + (7 * i) % interval for i in range(n)])
    nodes = list(heap.nodes.values())
    honest = nodes[1:]
    heap_acc = np.mean([nd.accuracy_history[-1][1] for nd in honest])
    heap_mal = mean_reputation(honest, nodes[0].info.address)
    assert res.stats["broadcasts"] == heap.stats["tx_sent"]
    assert res.stats["deliveries"] == heap.stats["tx_delivered"]
    assert abs(heap_acc - res.acc_history[-1][1:].mean()) < 0.02
    assert abs(heap_mal - res.mean_reputation(0)) < 0.1
    assert res.mean_reputation(0) < 0.9 and heap_mal < 0.9
