"""The port's sweep orchestrator (``repro_torch.chain.sweeps``) held to the
JAX package's on the CPU: grid expansion and batch planning equal, and a
toy grid run end to end whose frontier tables match the JAX package's on a
deterministic grid (fixed intervals, deterministic attacks: the two
packages' random draws differ)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.chain import simlax as j_simlax                       # noqa: E402
from repro.chain import sweeps as j_sweeps                       # noqa: E402

from repro_torch.chain import scenarios as p_scenarios           # noqa: E402
from repro_torch.chain import simlax as p_simlax                 # noqa: E402
from repro_torch.chain import sweeps as p_sweeps                 # noqa: E402
from repro_torch.core import topology as p_topology              # noqa: E402
from repro_torch.core.reputation import IMPL2 as P_IMPL2         # noqa: E402

GRID = dict(sizes=[8, 16], attacks=[None, "gaussian"], topology_seeds=[0, 1],
            seeds=[0, 1, 2])


def test_expand_grid_matches_jax():
    p, j = p_sweeps.expand_grid(**GRID), j_sweeps.expand_grid(**GRID)
    assert [dataclasses.astuple(c) for c in p] == [dataclasses.astuple(c) for c in j]
    assert len(p) == 2 * 2 * 2 * 3 and len(set(p)) == len(p)
    assert [c.num_malicious() for c in p] == [c.num_malicious() for c in j]
    assert [c.batch_key() for c in p] == [c.batch_key() for c in j]
    for pc, jc in zip(p, j):
        assert pc.spec().malicious == jc.spec().malicious
        assert [a.name for _, a in pc.spec().attackers] == \
            [a.name for _, a in jc.spec().attackers]


@pytest.mark.parametrize("max_batch", [0, 4, 5])
def test_plan_batches_matches_jax(max_batch):
    p = p_sweeps.plan_batches(p_sweeps.expand_grid(**GRID), max_batch=max_batch)
    j = j_sweeps.plan_batches(j_sweeps.expand_grid(**GRID), max_batch=max_batch)
    assert [[dataclasses.astuple(c) for c in b] for b in p] == \
        [[dataclasses.astuple(c) for c in b] for b in j]
    for batch in p:
        assert len({c.batch_key() for c in batch}) == 1
        assert max_batch == 0 or len(batch) <= max_batch
    if max_batch == 0:
        assert [len(b) for b in p] == [6, 6, 6, 6]


# fixed intervals and deterministic attacks: no random draw is left
CFG = dict(ticks=30, train_interval=(6, 6), ttl=2, record_every=6)
DET = dict(sizes=[12], attacks=[None, "signflip", "freerider"], seeds=[0, 1],
           topology_seeds=[0, 3])


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-5
    return a == b


def test_run_sweep_frontier_tables_match_jax():
    cells = p_sweeps.expand_grid(**DET)
    got = p_sweeps.run_sweep(cells, cfg=p_simlax.SimLaxConfig(**CFG),
                             topology_kind="erdos", target_acc=0.4,
                             devices=["cpu"])
    want = j_sweeps.run_sweep(j_sweeps.expand_grid(**DET),
                              cfg=j_simlax.SimLaxConfig(**CFG),
                              topology_kind="erdos", target_acc=0.4)
    assert len(got) == len(want) == len(cells)
    for o, w in zip(got, want):
        po, jo = o.row(), w.row()
        assert po.keys() == jo.keys()
        assert all(_close(po[k], jo[k]) for k in po), (po, jo)
        assert o.stats["batch_size"] == 6
    p_tab = p_sweeps.frontier_tables(got, target_acc=0.4)
    j_tab = j_sweeps.frontier_tables(want, target_acc=0.4)
    assert p_tab.keys() == j_tab.keys()
    for name in p_tab:
        assert len(p_tab[name]) == len(j_tab[name]) == 3
        for pr, jr in zip(p_tab[name], j_tab[name]):
            assert pr.keys() == jr.keys()
            assert all(_close(pr[k], jr[k]) for k in pr), (name, pr, jr)
    none = [r for r in p_tab["accuracy_under_attack"] if r["attack"] == "none"]
    assert none[0]["mean_attacker_reputation"] is None
    assert any(r["reached_frac"] > 0 for r in p_tab["time_to_accuracy"])


def test_run_sweep_outcome_is_the_single_run():
    """The orchestrator adds no simulation semantics: a swept cell's metrics
    equal a hand-built single run's of the same cell, at its seed."""
    cells = p_sweeps.expand_grid(sizes=[10], attacks=["gaussian"], seeds=[7, 8])
    cfg = p_simlax.SimLaxConfig(ticks=24, train_interval=(6, 8), ttl=2,
                                record_every=6)
    outcomes = p_sweeps.run_sweep(cells, cfg=cfg, target_acc=0.4,
                                  devices=["cpu"])
    for cell, outcome in zip(cells, outcomes):
        res = p_simlax.LaxSimulator(
            p_scenarios.toy_scenario(10), p_topology.kregular(10, 2),
            cell.spec(), P_IMPL2, dataclasses.replace(cfg, seed=cell.seed),
            device="cpu").run()
        mal = range(cell.num_malicious())
        honest = [i for i in range(10) if i not in mal]
        assert outcome.final_honest_acc == float(res.acc_history[-1][honest].mean())
        assert outcome.attacker_reputation == float(
            np.mean([res.mean_reputation(i) for i in mal]))
        assert outcome.stats["seed"] == cell.seed


def test_run_sweep_devices():
    """Batches round-robin over the given devices; without ``devices`` the
    sweep runs on every visible CUDA device and raises when there is none."""
    cells = p_sweeps.expand_grid(sizes=[8, 10], seeds=[0])
    cfg = p_simlax.SimLaxConfig(ticks=6, train_interval=(3, 3), ttl=1,
                                record_every=3)
    out = p_sweeps.run_sweep(cells, cfg=cfg, devices=[torch.device("cpu"), "cpu"])
    assert [o.cell.size for o in out] == [8, 10]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
            p_sweeps.run_sweep(cells, cfg=cfg)
