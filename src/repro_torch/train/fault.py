"""Fault tolerance & elasticity for the DFL federation (host code, copied
from the JAX package's ``repro.train.fault``).

DFL's partial consensus means node failure needs NO global recovery protocol:
a dead replica simply stops gossiping; its ring neighbors renumber. This
module provides the host-side control plane:

* ``HeartbeatMonitor`` — failure detection from per-replica step heartbeats.
* ``FedRing`` — live-membership ring; on change, gossip round functions are
  rebuilt (recompile) for the new fed size while surviving replicas keep
  their params/opt state untouched (bounded loss: at most H local steps of
  the dead node's contribution).
* ``StragglerPolicy`` — the paper's expire_time applied to gossip: a replica
  whose heartbeat lags more than `stale_after` rounds is treated as expired
  and skipped by the ring (bounded staleness), instead of stalling the world
  as a synchronous all-reduce would.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 300.0
    _last: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, replica: int, now: Optional[float] = None):
        self._last[replica] = time.time() if now is None else now

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        return [r for r, t in self._last.items() if now - t > self.timeout_s]

    def alive(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        return [r for r, t in self._last.items() if now - t <= self.timeout_s]


@dataclasses.dataclass
class StragglerPolicy:
    stale_after: int = 2  # rounds (the paper's expire_time, in gossip rounds)
    _round_of: Dict[int, int] = dataclasses.field(default_factory=dict)

    def report(self, replica: int, round_idx: int):
        self._round_of[replica] = round_idx

    def fresh(self, replica: int, current_round: int) -> bool:
        seen = self._round_of.get(replica)
        return seen is not None and current_round - seen <= self.stale_after


class FedRing:
    """Live federation membership; rebuilds ring permutations on change."""

    def __init__(self, replicas: List[int]):
        self.members = list(replicas)
        self.epoch = 0  # bumps on every membership change -> recompile key

    def fail(self, replica: int):
        if replica in self.members:
            self.members.remove(replica)
            self.epoch += 1

    def join(self, replica: int):
        if replica not in self.members:
            self.members.append(replica)
            self.epoch += 1

    @property
    def size(self) -> int:
        return len(self.members)

    def perms(self):
        """(fwd, bwd) ring permutations over CURRENT members, expressed in
        dense rank space 0..size-1 (callers re-map params to dense ranks)."""
        n = self.size
        fwd = [(i, (i + 1) % n) for i in range(n)]
        bwd = [(i, (i - 1) % n) for i in range(n)]
        return fwd, bwd

    def dense_rank(self, replica: int) -> int:
        return self.members.index(replica)


def elastic_gossip_builder(make_round_fn: Callable[[int], Callable]):
    """Memoize gossip-round builds per fed size: membership changes reuse
    compiled rounds for sizes seen before (recompile happens at most once
    per distinct live count)."""
    cache: Dict[int, Callable] = {}

    def get(fed_size: int) -> Callable:
        if fed_size not in cache:
            cache[fed_size] = make_round_fn(fed_size)
        return cache[fed_size]

    return get
