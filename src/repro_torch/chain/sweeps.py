"""Batched federation sweeps: whole what-if grids, one batched run per
shape-compatible batch.

Port of the JAX package's ``repro.chain.sweeps``. The paper's evaluation
(§VI) is a grid — attack type × topology × network size × seed — but a
single ``LaxSimulator.run()`` answers ONE federation. This module turns a
grid into the fewest batched runs:

1. ``expand_grid`` enumerates the attack × topology-seed × size × rng-seed
   product into ``SweepCell``s (one cell = one federation).
2. ``plan_batches`` groups cells into *shape-compatible* batches: members
   of a batch share the node count, the topology (kind + generator seed)
   and the scenario, while attacker sheets, dead sets and rng seeds may
   differ per member (``repro_torch.chain.attacks.BatchedFederationSpec``).
3. ``run_sweep`` builds one ``BatchedFederationSpec`` per batch, runs it
   through the vectorized engine on a device of ``devices`` (round robin;
   by default every visible CUDA device), and reduces each member's
   ``SimLaxResult`` to the frontier metrics: time-to-accuracy (the first
   recorded tick where the honest-node mean clears a target) and
   accuracy / reputation under attack.
4. ``frontier_tables`` pivots the outcomes into two JSON-ready tables.

Everything here is host-side orchestration; each batch is one
``LaxSimulator`` run, whose members are bitwise their single runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.chain import scenarios as scenarios_lib
from repro_torch.chain import simlax
from repro_torch.chain.attacks import BatchedFederationSpec, FederationSpec
from repro_torch.core import topology as topology_lib
from repro_torch.core.reputation import get as get_rep


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One grid point = one federation: who attacks, on which sampled
    topology, at what size, under which engine seed."""

    size: int
    attack: Optional[str]        # attack registry name; None = honest run
    malicious_frac: float        # fraction of nodes assigned the attack
    topology_seed: int           # generator seed (erdos/smallworld sampling)
    seed: int                    # engine seed (SimLaxConfig.seed role)

    def num_malicious(self) -> int:
        if self.attack is None:
            return 0
        return max(1, int(self.malicious_frac * self.size))

    def spec(self) -> FederationSpec:
        """The cell's role sheet: the first ``num_malicious`` node ids run
        ``attack`` (deterministic and size-comparable across the grid)."""
        mal = tuple(range(self.num_malicious()))
        return FederationSpec.build(self.size, malicious=mal,
                                    attack=self.attack or None)

    def batch_key(self) -> tuple:
        """Cells sharing this key can ride in ONE batched run: the node
        count and topology are shared; roles and seeds may differ."""
        return (self.size, self.topology_seed)


def expand_grid(*, sizes: Sequence[int],
                attacks: Sequence[Optional[str]] = (None,),
                topology_seeds: Sequence[int] = (0,),
                seeds: Sequence[int] = (0,),
                malicious_frac: float = 0.125) -> List[SweepCell]:
    """The full attack × topology-seed × size × rng-seed product, ordered
    so ``plan_batches`` finds maximal shape-compatible runs contiguously."""
    return [SweepCell(size=int(n), attack=a,
                      malicious_frac=float(malicious_frac),
                      topology_seed=int(ts), seed=int(s))
            for n in sizes for ts in topology_seeds
            for a in attacks for s in seeds]


def plan_batches(cells: Sequence[SweepCell], *,
                 max_batch: int = 0) -> List[List[SweepCell]]:
    """Group cells into shape-compatible batches (same ``batch_key``),
    preserving grid order; ``max_batch > 0`` additionally splits batches
    so no single run holds more than that many federations (memory
    control: a batch's state is B times one federation's)."""
    by_key: Dict[tuple, List[SweepCell]] = {}
    order: List[tuple] = []
    for c in cells:
        k = c.batch_key()
        if k not in by_key:
            by_key[k] = []
            order.append(k)
        by_key[k].append(c)
    batches: List[List[SweepCell]] = []
    for k in order:
        group = by_key[k]
        step = max_batch if max_batch > 0 else len(group)
        for i in range(0, len(group), step):
            batches.append(group[i:i + step])
    return batches


@dataclasses.dataclass
class SweepOutcome:
    """One federation's reduced frontier metrics."""

    cell: SweepCell
    final_honest_acc: float      # honest-node mean test acc, last record
    time_to_acc: Optional[int]   # first recorded tick clearing target_acc
    attacker_reputation: float   # mean over attackers of mean_reputation
    honest_reputation: float
    stats: dict

    def row(self) -> dict:
        return {
            "size": self.cell.size, "attack": self.cell.attack or "none",
            "malicious_frac": (self.cell.malicious_frac
                               if self.cell.attack else 0.0),
            "topology_seed": self.cell.topology_seed, "seed": self.cell.seed,
            "final_honest_acc": round(self.final_honest_acc, 6),
            "time_to_acc": self.time_to_acc,
            "attacker_reputation": round(self.attacker_reputation, 6),
            "honest_reputation": round(self.honest_reputation, 6),
        }


def _reduce(cell: SweepCell, res: simlax.SimLaxResult,
            target_acc: float) -> SweepOutcome:
    mal = set(range(cell.num_malicious()))
    honest = [i for i in range(cell.size) if i not in mal]
    honest_curve = res.acc_history[:, honest].mean(axis=1)   # (records,)
    reached = np.flatnonzero(honest_curve >= target_acc)
    return SweepOutcome(
        cell=cell,
        final_honest_acc=float(honest_curve[-1]),
        time_to_acc=(int(res.record_ticks[reached[0]]) if len(reached)
                     else None),
        attacker_reputation=(float(np.mean(
            [res.mean_reputation(i) for i in sorted(mal)])) if mal
            else float("nan")),
        honest_reputation=float(np.mean(
            [res.mean_reputation(i) for i in honest])),
        stats=res.stats)


def _cuda_devices() -> List[torch.device]:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not count:
        raise RuntimeError(
            "run_sweep: no CUDA device is visible; pass devices=['cpu'] to "
            "run the sweep on the CPU")
    return [torch.device("cuda", i) for i in range(count)]


def run_sweep(cells: Sequence[SweepCell], *,
              cfg: simlax.SimLaxConfig,
              scenario: str = "toy",
              scenario_kw: Optional[dict] = None,
              topology_kind: str = "kregular",
              degree: int = 2, p: float = 0.3,
              rep_impl: str = "impl2",
              target_acc: float = 0.5,
              max_batch: int = 0,
              devices: Optional[Sequence] = None) -> List[SweepOutcome]:
    """Run a planned grid: one batched ``LaxSimulator`` run per
    shape-compatible batch, built on ``devices[i % len(devices)]``
    (``torch.device``s or their names; default: every visible CUDA device,
    and a ``RuntimeError`` when there is none). Scenario data is built once
    per size and shared by every batch member; each member runs at its OWN
    cell seed, so outcomes are bitwise those of single runs of the same
    cells."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else _cuda_devices())
    rep = get_rep(rep_impl)
    builder = scenarios_lib.get(scenario)
    sc_cache: Dict[int, object] = {}
    topo_cache: Dict[tuple, topology_lib.Topology] = {}
    outcomes: List[SweepOutcome] = []
    for i, batch in enumerate(plan_batches(cells, max_batch=max_batch)):
        n, topo_seed = batch[0].batch_key()
        if n not in sc_cache:
            sc_cache[n] = builder(n, **(scenario_kw or {}))
        if (n, topo_seed) not in topo_cache:
            topo_cache[(n, topo_seed)] = topology_lib.make(
                topology_kind, n, degree=degree, p=p, seed=topo_seed)
        bspec = BatchedFederationSpec.build(
            [c.spec() for c in batch], [c.seed for c in batch])
        sim = simlax.LaxSimulator(sc_cache[n], topo_cache[(n, topo_seed)],
                                  bspec, rep, cfg,
                                  device=devices[i % len(devices)])
        outcomes.extend(_reduce(c, r, target_acc)
                        for c, r in zip(batch, sim.run(), strict=True))
    return outcomes


def frontier_tables(outcomes: Sequence[SweepOutcome], *,
                    target_acc: float) -> dict:
    """Pivot outcomes into the two frontier tables (JSON-ready rows):

    ``time_to_accuracy`` — per (attack, size): how fast the honest mean
    clears ``target_acc`` across topology-seed × seed replicates (median
    over the replicates that reached it + the reached fraction).
    ``accuracy_under_attack`` — per (attack, size): final honest accuracy
    and the attacker / honest reputation split the defense achieved.
    """
    groups: Dict[Tuple[str, int], List[SweepOutcome]] = {}
    for o in outcomes:
        groups.setdefault((o.cell.attack or "none", o.cell.size),
                          []).append(o)
    tta, aua = [], []
    for (attack, size), grp in sorted(groups.items()):
        times = [o.time_to_acc for o in grp if o.time_to_acc is not None]
        tta.append({
            "attack": attack, "size": size, "replicates": len(grp),
            "target_acc": target_acc,
            "reached_frac": round(len(times) / len(grp), 4),
            "median_ticks_to_acc": (float(np.median(times)) if times
                                    else None),
        })
        att_reps = [o.attacker_reputation for o in grp
                    if not np.isnan(o.attacker_reputation)]
        aua.append({
            "attack": attack, "size": size, "replicates": len(grp),
            "mean_final_honest_acc": round(
                float(np.mean([o.final_honest_acc for o in grp])), 6),
            "mean_attacker_reputation": (round(float(np.mean(att_reps)), 6)
                                         if att_reps else None),
            "mean_honest_reputation": round(
                float(np.mean([o.honest_reputation for o in grp])), 6),
        })
    return {"time_to_accuracy": tta, "accuracy_under_attack": aua}
