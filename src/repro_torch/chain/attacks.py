"""Pluggable model-poisoning attacks + the FederationSpec role sheet.

Port of the JAX package's ``repro.chain.attacks``: the same five attacks,
registry, membership schedule and role sheet. Attacks are plug-ins::

    attacks.get("signflip")                  # default-parameterized instance
    attacks.make("gaussian", sigma=3.0)      # parameterized variant
    attacks.register(MyAttack())             # custom adversaries

An attack is a frozen dataclass with one method::

    apply(generator, params, committed, tick) -> outgoing params (same tree)

* ``generator`` — a ``torch.Generator`` for randomized attacks
* ``params``    — the model the node WOULD honestly broadcast this action
                  (its honestly-trained candidate; attackers never commit it)
* ``committed`` — the node's persistent (pre-train) state; doubles as the
                  shape/dtype template for replacement attacks
* ``tick``      — the current simulator tick, for schedule-driven attacks

Shipped attacks (all §VI-E-style model poisoning at broadcast time):

``signflip``      broadcast the sign-flipped (optionally scaled) model
``gaussian``      replace the model with ``sigma * N(0, 1)`` noise — the
                  paper's "arbitrary random model" attack at sigma=1
``scaled``        boosting: ``committed + factor * (trained - committed)``
``freerider``     stale-replay: re-broadcast the committed model unchanged
``intermittent``  run ``inner`` during the first ``duty`` ticks of every
                  ``period``, act honest otherwise

Randomness: JAX's ``fold_in(tick)`` key stream has no PyTorch counterpart,
so ``attack_key_at`` seeds one ``torch.Generator`` per (seed, tick, fold,
node) from a hash of the four. The draws differ from the JAX package's;
the structure (which node draws from which stream on which tick, and the
fold constants of ``attack_fold``) is the same. ``stream_key_at`` seeds
the vectorized engine's other per-tick streams the same way.
``BatchedFederationSpec`` is the batched engine's role sheet: B same-N
members, one seed each, run together by ``LaxSimulator``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree


def _map_floats(fn, params):
    """Apply fn to floating leaves only (step counters etc. pass through)."""
    return tree.map(lambda x: fn(x) if x.is_floating_point() else x, params)


@dataclasses.dataclass(frozen=True)
class SignFlip:
    """Constant sign-flip poisoning: broadcast ``-scale *`` the honestly
    trained model. scale>1 additionally boosts the magnitude."""
    scale: float = 1.0
    name: str = "signflip"

    def apply(self, generator, params, committed, tick):
        del generator, committed, tick
        return _map_floats(lambda x: (-self.scale) * x, params)


@dataclasses.dataclass(frozen=True)
class GaussianNoise:
    """Replace the model with ``sigma * N(0, 1)`` noise — the paper's §VI-E
    "broadcast an arbitrary random model" attack at sigma=1 (non-float
    leaves pass through untouched). Leaves draw in sorted-key order from
    the one generator, on the generator's device."""
    sigma: float = 1.0
    name: str = "gaussian"

    def apply(self, generator, params, committed, tick):
        del params, tick

        def noise(leaf):
            z = torch.randn(leaf.shape, generator=generator, dtype=leaf.dtype,
                            device=generator.device)
            return (self.sigma * z).to(leaf.device)

        return _map_floats(noise, committed)


@dataclasses.dataclass(frozen=True)
class ScaledPoison:
    """Boosting / scaled poisoning: exaggerate the local update by
    ``factor`` — ``committed + factor * (trained - committed)``."""
    factor: float = 10.0
    name: str = "scaled"

    def apply(self, generator, params, committed, tick):
        del generator, tick
        return tree.map(
            lambda tr, cm: (cm + self.factor * (tr - cm)).to(tr.dtype)
            if tr.is_floating_point() else tr,
            params, committed)


@dataclasses.dataclass(frozen=True)
class FreeRider:
    """Stale-replay free-riding: broadcast the committed model unchanged."""
    name: str = "freerider"

    def apply(self, generator, params, committed, tick):
        del generator, params, tick
        return committed


@dataclasses.dataclass(frozen=True)
class Intermittent:
    """Tick-scheduled on/off attacker: run the ``inner`` attack during the
    first ``duty`` ticks of every ``period``-tick window, broadcast the
    honest candidate otherwise. The heap engine's tick is a Python int, so
    the schedule is a branch and an idle tick draws nothing."""
    period: int = 8
    duty: int = 4
    inner: str = "gaussian"
    name: str = "intermittent"

    def apply(self, generator, params, committed, tick):
        if int(tick) % self.period < self.duty:
            return get(self.inner).apply(generator, params, committed, tick)
        return params


_REGISTRY: Dict[str, object] = {}


def register(attack) -> object:
    """Register a default-parameterized attack instance under its name."""
    _REGISTRY[attack.name] = attack
    return attack


def get(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown attack {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def make(name: str, **params):
    """A parameterized variant of a registered attack:
    ``make("gaussian", sigma=3.0)``."""
    return dataclasses.replace(get(name), **params) if params else get(name)


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


SIGNFLIP = register(SignFlip())
GAUSSIAN = register(GaussianNoise())
SCALED = register(ScaledPoison())
FREERIDER = register(FreeRider())
INTERMITTENT = register(Intermittent())


# ======================================================== shared PRNG streams
def attack_fold(group_index: int) -> int:
    """The fold constant keying attack group ``group_index``'s stream: 0 is
    the train stream, 1 attack group 0, 2 the train-interval redraw, so
    later groups start at 3 to keep every stream disjoint."""
    return 1 if group_index == 0 else group_index + 2


def _seeded(text: str, device) -> torch.Generator:
    digest = hashlib.sha256(text.encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "big") & (2 ** 63 - 1))
    return g


def attack_key_at(seed: int, tick: int, fold: int, node: int,
                  device="cpu") -> torch.Generator:
    """Node ``node``'s attack generator at ``tick``: a fresh
    ``torch.Generator`` on ``device`` seeded from (seed, tick, fold, node)."""
    return _seeded(f"attack:{int(seed)}:{int(tick)}:{int(fold)}:{int(node)}",
                   device)


def stream_key_at(seed: int, tick: Optional[int], fold: int,
                  device="cpu") -> torch.Generator:
    """The vectorized engine's per-tick stream ``fold`` at ``tick``: a fresh
    ``torch.Generator`` on ``device`` seeded from (seed, tick, fold), the
    counterpart of the JAX engine's ``fold_in(fold_in(PRNGKey(seed), t),
    fold)``. Folds: 0 keys the tick's train draws, 2 the train-interval
    redraw; ``tick=None`` is the base key, whose fold 12345 draws the
    initial countdowns. Attack draws use ``attack_key_at`` instead, one
    generator an attacker, as the heap engine does."""
    where = "base" if tick is None else int(tick)
    return _seeded(f"stream:{int(seed)}:{where}:{int(fold)}", device)


# ================================================================= role sheet
def _resolve(attack) -> object:
    return get(attack) if isinstance(attack, str) else attack


# ============================================================ churn schedule
@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One tick's worth of churn: ``joins`` come online and ``leaves`` go
    offline at the TOP of ``tick``, before any queue drain or training —
    a node leaving at tick t neither receives nor trains on tick t, and a
    node joining at tick t participates from tick t onward."""
    tick: int
    joins: Tuple[int, ...] = ()
    leaves: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "tick", int(self.tick))
        object.__setattr__(self, "joins",
                           tuple(int(i) for i in self.joins))
        object.__setattr__(self, "leaves",
                           tuple(int(i) for i in self.leaves))
        if self.tick < 0:
            raise ValueError(f"event tick must be >= 0, got {self.tick}")
        overlap = set(self.joins) & set(self.leaves)
        if overlap:
            raise ValueError(
                f"nodes {sorted(overlap)} both join and leave at tick "
                f"{self.tick}")


@dataclasses.dataclass(frozen=True)
class MembershipSchedule:
    """Dynamic membership for one federation run: which nodes are offline
    from tick 0 (``initial_offline``) and the per-tick join/leave/rejoin
    event stream. Both simulator engines consume the SAME schedule, so churn
    scenarios stay single-source like every other role in the spec.

    Semantics (the contract docs/SCALING.md pins):

    * Offline nodes keep their committed params and receive nothing; models
      in flight toward them when they drop are lost (both engines).
    * A REJOIN (a node that was online earlier — or started online — coming
      back) resumes from its committed params with every peer's reputation
      of it decayed: ``rep <- clip(rejoin_decay * rep, floor, initial)``.
      First-time joins of ``initial_offline`` nodes get no decay.
    * Routing/budgets stay the static all-alive worst case: an offline node
      can only SHRINK the set of deliveries due on a tick, never grow it.

    ``dead`` nodes (the spec's permanent failures) may not appear in any
    event or in ``initial_offline`` — they never participate.
    """
    events: Tuple[MembershipEvent, ...] = ()
    rejoin_decay: float = 0.5
    initial_offline: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "initial_offline",
                           tuple(sorted(set(int(i)
                                            for i in self.initial_offline))))
        object.__setattr__(self, "rejoin_decay", float(self.rejoin_decay))
        if not 0.0 <= self.rejoin_decay <= 1.0:
            raise ValueError(
                f"rejoin_decay must be in [0, 1], got {self.rejoin_decay}")
        ticks = [e.tick for e in self.events]
        if ticks != sorted(ticks):
            raise ValueError("events must be sorted by tick")
        if len(set(ticks)) != len(ticks):
            raise ValueError("at most one MembershipEvent per tick "
                             "(merge joins/leaves into one event)")

    @classmethod
    def build(cls, events=(), *, rejoin_decay: float = 0.5,
              initial_offline: Sequence[int] = ()) -> "MembershipSchedule":
        """``events`` entries are ``MembershipEvent``s or
        ``(tick, joins, leaves)`` tuples; they are sorted by tick here."""
        evs = []
        for e in events:
            if not isinstance(e, MembershipEvent):
                t, joins, leaves = e
                e = MembershipEvent(tick=t, joins=tuple(joins),
                                    leaves=tuple(leaves))
            evs.append(e)
        evs.sort(key=lambda e: e.tick)
        return cls(events=tuple(evs), rejoin_decay=rejoin_decay,
                   initial_offline=tuple(initial_offline))

    def validate(self, num_nodes: int, dead: Sequence[int] = ()) -> None:
        """Replay the schedule against ``num_nodes``/``dead`` and reject
        impossible streams: out-of-range ids, events touching dead nodes,
        joining while online, leaving while offline."""
        horizon = (max(e.tick for e in self.events) + 1) if self.events \
            else 1
        self.timeline(num_nodes, horizon, dead=dead)

    def timeline(self, num_nodes: int, ticks: int,
                 dead: Sequence[int] = ()) -> Tuple[np.ndarray, np.ndarray]:
        """Expand to dense per-tick masks: ``(alive_t, rejoin_t)`` both
        ``(ticks, num_nodes)`` bool. ``alive_t[t, i]`` — node i participates
        on tick t (events applied at the top of their tick, dead nodes
        always False); ``rejoin_t[t, i]`` — node i REJOINS at the top of
        tick t (triggers the reputation decay; first-time joins of
        ``initial_offline`` nodes don't)."""
        dead_set = set(int(i) for i in dead)
        for i in self.initial_offline:
            if not 0 <= i < num_nodes:
                raise ValueError(
                    f"initial_offline id {i} outside [0, {num_nodes})")
            if i in dead_set:
                raise ValueError(f"node {i} is dead; it cannot churn")
        participating = np.ones((num_nodes,), np.bool_)
        participating[list(dead_set)] = False
        participating[list(self.initial_offline)] = False
        ever_online = participating.copy()
        alive_t = np.zeros((ticks, num_nodes), np.bool_)
        rejoin_t = np.zeros((ticks, num_nodes), np.bool_)
        by_tick = {e.tick: e for e in self.events}
        for t in range(ticks):
            ev = by_tick.get(t)
            if ev is not None:
                for i in ev.leaves:
                    if not 0 <= i < num_nodes:
                        raise ValueError(
                            f"leave id {i} outside [0, {num_nodes})")
                    if i in dead_set:
                        raise ValueError(
                            f"node {i} is dead; it cannot churn")
                    if not participating[i]:
                        raise ValueError(
                            f"node {i} leaves at tick {t} but is already "
                            "offline")
                    participating[i] = False
                for i in ev.joins:
                    if not 0 <= i < num_nodes:
                        raise ValueError(
                            f"join id {i} outside [0, {num_nodes})")
                    if i in dead_set:
                        raise ValueError(
                            f"node {i} is dead; it cannot churn")
                    if participating[i]:
                        raise ValueError(
                            f"node {i} joins at tick {t} but is already "
                            "online")
                    participating[i] = True
                    if ever_online[i]:
                        rejoin_t[t, i] = True
                    ever_online[i] = True
            alive_t[t] = participating
        return alive_t, rejoin_t


@dataclasses.dataclass(frozen=True)
class FederationSpec:
    """Per-node roles for one federation run — the single source both
    simulator engines are constructed from.

    attackers: ((node_id, attack_instance), ...) sorted by node id
    dead:      node ids that never act (failure/elasticity tests)
    stragglers: ((node_id, factor), ...) train-interval multipliers
    initial_countdown: per-node ticks until the first train action (length
        num_nodes), or None for the engine's seeded random draw
    membership: optional MembershipSchedule of join/leave/rejoin churn
        (None = everyone but ``dead`` participates for the whole run)
    """
    num_nodes: int
    attackers: Tuple[Tuple[int, object], ...] = ()
    dead: Tuple[int, ...] = ()
    stragglers: Tuple[Tuple[int, int], ...] = ()
    initial_countdown: Optional[Tuple[int, ...]] = None
    membership: Optional[MembershipSchedule] = None

    def __post_init__(self):
        for i, _ in self.attackers:
            if not 0 <= i < self.num_nodes:
                raise ValueError(f"attacker id {i} outside [0, {self.num_nodes})")
        for i in self.dead:
            if not 0 <= i < self.num_nodes:
                raise ValueError(f"dead id {i} outside [0, {self.num_nodes})")
        for i, f in self.stragglers:
            if not 0 <= i < self.num_nodes:
                raise ValueError(f"straggler id {i} outside [0, {self.num_nodes})")
            if f < 1:
                raise ValueError(f"straggler factor must be >= 1, got {f}")
        if (self.initial_countdown is not None
                and len(self.initial_countdown) != self.num_nodes):
            raise ValueError(
                f"initial_countdown has {len(self.initial_countdown)} entries "
                f"for {self.num_nodes} nodes")
        if self.membership is not None:
            self.membership.validate(self.num_nodes, dead=self.dead)

    @classmethod
    def build(cls, num_nodes: int, *, malicious=(), attack=None,
              dead: Sequence[int] = (), stragglers: Optional[dict] = None,
              initial_countdown=None,
              membership: Optional[MembershipSchedule] = None
              ) -> "FederationSpec":
        """The convenient constructor. ``malicious`` is either a sequence of
        node ids (all assigned ``attack``, name or instance; default
        ``gaussian``) or a dict ``{node_id: attack}`` for heterogeneous
        adversaries (in which case ``attack`` must be omitted)."""
        if isinstance(malicious, dict):
            if attack is not None:
                raise ValueError(
                    "malicious={node: attack} already assigns per-node "
                    "attacks; drop the separate attack= argument")
            attackers = tuple(sorted(
                (int(i), _resolve(a)) for i, a in malicious.items()))
        else:
            atk = _resolve(attack if attack is not None else "gaussian")
            attackers = tuple((int(i), atk) for i in sorted(set(malicious)))
        return cls(
            num_nodes=num_nodes, attackers=attackers,
            dead=tuple(sorted(set(int(i) for i in dead))),
            stragglers=tuple(sorted(
                (int(k), int(v)) for k, v in (stragglers or {}).items())),
            initial_countdown=(None if initial_countdown is None
                               else tuple(int(c) for c in initial_countdown)),
            membership=membership)

    @classmethod
    def honest(cls, num_nodes: int) -> "FederationSpec":
        return cls(num_nodes=num_nodes)

    # ------------------------------------------------------------- accessors
    @property
    def malicious(self) -> Tuple[int, ...]:
        return tuple(i for i, _ in self.attackers)

    def attack_for(self, node_id: int):
        for i, a in self.attackers:
            if i == node_id:
                return a
        return None

    def straggler_map(self) -> Dict[int, int]:
        return dict(self.stragglers)

    def attack_groups(self) -> List[Tuple[object, np.ndarray]]:
        """Attackers grouped by attack instance, as (attack, (N,) bool mask)
        in first-appearance order over ascending node ids — the vectorized
        engine runs one vmap per group over just that group's node ids, and
        the group order keys its PRNG folds (group 0 of a single-gaussian
        spec reproduces the legacy ``malicious=`` stream bit-for-bit)."""
        groups: List[Tuple[object, np.ndarray]] = []
        index: Dict[object, int] = {}
        for i, a in self.attackers:   # attackers are sorted by node id
            if a not in index:
                index[a] = len(groups)
                groups.append((a, np.zeros((self.num_nodes,), np.bool_)))
            groups[index[a]][1][i] = True
        return groups

    def attack_fold_of(self, attack) -> Optional[int]:
        """The fold constant THIS spec assigns ``attack`` (its position in
        ``attack_groups()`` order through ``attack_fold``), or None if no
        node of the spec runs it. Batched runs use it to give every member
        its own single-run attack streams."""
        for gi, (a, _) in enumerate(self.attack_groups()):
            if a == attack:
                return attack_fold(gi)
        return None

    def attack_key_fns(self, seed: int, device="cpu") -> Dict[int, Callable]:
        """Per-attacker ``tick -> torch.Generator`` streams for the heap
        engine (group order over ``attack_groups()``, fold constants from
        ``attack_fold``); generators live on ``device``."""
        fns: Dict[int, Callable] = {}
        for gi, (_, mask) in enumerate(self.attack_groups()):
            fold_const = attack_fold(gi)
            for i in np.flatnonzero(mask):
                node = int(i)

                def key_at(tick, _fold=fold_const, _i=node):
                    return attack_key_at(seed, tick, _fold, _i, device)
                fns[node] = key_at
        return fns


@dataclasses.dataclass(frozen=True)
class BatchedFederationSpec:
    """A stack of same-N ``FederationSpec`` role sheets, one seed each: the
    unit the batched vectorized engine runs together (the JAX package's
    ``BatchedFederationSpec``). Topology, scenario and ``SimLaxConfig`` are
    shared by the simulator; attacker sheets, dead sets, stragglers,
    countdowns, membership and seeds may differ per member.

    specs: (B,) FederationSpec members
    seeds: (B,) per-member engine seeds (member b's run is bitwise the
        single run of ``specs[b]`` under ``SimLaxConfig(seed=seeds[b])``),
        or None to run every member at the config's seed
    """
    specs: Tuple[FederationSpec, ...]
    seeds: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if not self.specs:
            raise ValueError("BatchedFederationSpec needs >= 1 spec")
        n = self.specs[0].num_nodes
        for b, s in enumerate(self.specs):
            if s.num_nodes != n:
                raise ValueError(
                    f"batch members must share num_nodes: member {b} has "
                    f"{s.num_nodes}, member 0 has {n}")
        if self.seeds is not None and len(self.seeds) != len(self.specs):
            raise ValueError(
                f"{len(self.seeds)} seeds for {len(self.specs)} specs")

    @classmethod
    def build(cls, specs: Sequence[FederationSpec],
              seeds: Optional[Sequence[int]] = None
              ) -> "BatchedFederationSpec":
        return cls(specs=tuple(specs),
                   seeds=None if seeds is None
                   else tuple(int(s) for s in seeds))

    # ------------------------------------------------------------- accessors
    @property
    def batch_size(self) -> int:
        return len(self.specs)

    @property
    def num_nodes(self) -> int:
        return self.specs[0].num_nodes

    def resolved_seeds(self, default_seed: int) -> Tuple[int, ...]:
        return (self.seeds if self.seeds is not None
                else (int(default_seed),) * len(self.specs))

    def dead_sets(self) -> Tuple[Tuple[int, ...], ...]:
        """(B,) dead-node tuples, the ``topology.batch_budgets`` input."""
        return tuple(s.dead for s in self.specs)

    def attack_union(self) -> List[Tuple[object, np.ndarray, np.ndarray]]:
        """Distinct attack instances across the batch, in first-appearance
        order (member-major), as ``(attack, (B, N) bool mask, (B,) int32
        folds)`` triples. ``mask[b]`` marks member b's nodes running the
        attack; ``folds[b]`` is the fold constant member b's OWN
        ``attack_groups()`` order assigns it (``attack_fold``), so each
        member draws its single run's attack streams. Members without the
        attack get an all-False mask (their fold entry is unused)."""
        b_n = (len(self.specs), self.num_nodes)
        union: List[Tuple[object, np.ndarray, np.ndarray]] = []
        index: Dict[object, int] = {}
        for b, s in enumerate(self.specs):
            for gi, (a, mask) in enumerate(s.attack_groups()):
                if a not in index:
                    index[a] = len(union)
                    union.append((a, np.zeros(b_n, np.bool_),
                                  np.zeros((b_n[0],), np.int32)))
                _, masks, folds = union[index[a]]
                masks[b] = mask
                folds[b] = attack_fold(gi)
        return union
