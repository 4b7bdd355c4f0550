"""Tick-based p2p network simulator (paper §VI-D: "we introduce the tick
time-keeping concept, a virtual time scale ... each node takes its actions in
a random number of ticks").

Simulates: topology (any adjacency; the paper uses fully-connected), per-edge
latency, ttl-bounded transaction forwarding, receipt backflow, block
generation with neighbor confirmations, malicious nodes, stragglers
(slow-train nodes), and node failure/join (elasticity tests). Messages ride a
heap-based event queue keyed by delivery tick.

Port of the JAX package's ``repro.chain.network``: pure Python over
nodes, so with the same ``SimConfig.seed`` the event order drawn from
``random.Random`` is the JAX package's, event for event. ``run`` holds cuDNN
to deterministic algorithms (``device.deterministic``), so a seeded run
gives the same bits on the card every time.

Dynamic membership (``set_membership``): a ``repro_torch.chain.attacks.
MembershipSchedule`` drives per-tick join/leave/rejoin events. Offline nodes
freeze their train countdowns, are skipped by recording, and never process a
transaction — but they still *relay*: routing is static, so a flood passes
through an offline node unchanged (ttl decremented via an unsigned relay
receipt, no evaluation, no buffering) exactly as the vectorized engines'
precomputed delivery schedules assume. A model in flight to an offline node
is lost for good (it is marked seen during the relay). Rejoining nodes resume
from their committed params; every peer's local reputation entry for the
rejoiner is decayed by ``rejoin_decay`` (clipped to [floor, initial]).
"""
from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch import device as device_lib
from repro_torch.chain.node import DFLNode
from repro_torch.chain.types import Receipt


@dataclasses.dataclass
class SimConfig:
    ticks: int = 1000
    train_interval: tuple = (8, 16)     # uniform random ticks between trains
    latency: tuple = (1, 3)             # per-edge delivery delay (ticks)
    record_every: int = 10
    seed: int = 0


@dataclasses.dataclass(order=True)
class _Msg:
    tick: int
    seq: int
    kind: str = dataclasses.field(compare=False)    # "tx" | "receipt"
    dest: str = dataclasses.field(compare=False)
    src: str = dataclasses.field(compare=False)
    tx: object = dataclasses.field(compare=False)   # Transaction | Receipt
    params: object = dataclasses.field(compare=False)


class Simulator:
    """Drives DFLNodes over a virtual-time network."""

    def __init__(self, nodes: Sequence[DFLNode], topology: Dict[str, List[str]],
                 test_fn: Callable, cfg: SimConfig):
        self.nodes = {n.name: n for n in nodes}
        self.topology = topology
        self.test_fn = test_fn            # params -> accuracy on global test set
        self.cfg = cfg
        self.rand = random.Random(cfg.seed)
        self.queue: list[_Msg] = []
        self._seq = 0
        self.next_train = {
            n: self.rand.randint(*cfg.train_interval) for n in self.nodes}
        self.straggler_factor: Dict[str, int] = {}
        self.dead: set[str] = set()
        self.membership = None                  # MembershipSchedule | None
        self.offline: set[str] = set()          # churned-out (distinct from dead)
        self.stats = {"tx_sent": 0, "tx_delivered": 0, "tx_dropped_dup": 0,
                      "tx_dropped_expired": 0, "blocks": 0, "fedavg_rounds": 0}

    # --------------------------------------------------------------- plumbing
    def _push(self, tick: int, kind: str, dest: str, src: str, tx, params):
        self._seq += 1
        payload = tx.copy() if kind == "tx" else tx   # wire snapshot
        heapq.heappush(self.queue,
                       _Msg(tick, self._seq, kind, dest, src, payload, params))

    def _addr_to_name(self, address: str):
        for name, node in self.nodes.items():
            if node.info.address == address:
                return name
        return None

    def _latency(self) -> int:
        return self.rand.randint(*self.cfg.latency)

    def neighbors(self, name: str) -> List[str]:
        return [p for p in self.topology.get(name, []) if p not in self.dead]

    # ------------------------------------------------------------- lifecycle
    def kill_node(self, name: str):
        """Node failure: drops off the network; DFL needs no global action."""
        self.dead.add(name)

    def revive_node(self, name: str):
        self.dead.discard(name)

    def set_straggler(self, name: str, factor: int):
        self.straggler_factor[name] = factor

    def set_membership(self, schedule, *, names: Optional[Sequence[str]] = None):
        """Attach a ``MembershipSchedule``. ``names`` maps node index ->
        node name (defaults to insertion order, which matches the lax
        engines' index order when nodes were built in order)."""
        names = list(names) if names is not None else list(self.nodes)
        if len(names) != len(self.nodes):
            raise ValueError(
                f"names covers {len(names)} nodes, simulator has {len(self.nodes)}")
        dead_idx = [i for i, nm in enumerate(names) if nm in self.dead]
        schedule.validate(len(names), dead=dead_idx)
        self.membership = schedule
        self._member_names = names
        self._events_by_tick = {ev.tick: ev for ev in schedule.events}
        self._rejoin_decay = float(schedule.rejoin_decay)
        init_off = set(schedule.initial_offline)
        self.offline = {names[i] for i in init_off}
        # rejoin decay applies only to nodes that were online before — a
        # first join of an initially-offline node decays nothing
        self._ever_online = {nm for i, nm in enumerate(names) if i not in init_off}

    def _apply_membership_events(self, tick: int):
        ev = self._events_by_tick.get(tick)
        if ev is None:
            return
        for i in ev.leaves:
            self.offline.add(self._member_names[i])
        for i in ev.joins:
            nm = self._member_names[i]
            self.offline.discard(nm)
            if nm in self._ever_online:
                # rejoin: every peer decays its local view of the rejoiner
                addr = self.nodes[nm].info.address
                for nd in self.nodes.values():
                    impl = nd.rep_impl
                    cur = nd.reputation.get(addr, impl.initial)
                    nd.reputation[addr] = min(
                        impl.initial, max(impl.floor, self._rejoin_decay * cur))
            self._ever_online.add(nm)

    # ------------------------------------------------------------------ steps
    def _broadcast_tx(self, node: DFLNode, tick: int):
        params, _ = node.train_local(tick)
        tx = node.create_transaction(params, tick)
        node.stash_for_block(tx)
        self.stats["tx_sent"] += 1
        for peer in self.neighbors(node.name):
            self._push(tick + self._latency(), "tx", peer, node.name, tx, params)

    def _relay_tx(self, node: DFLNode, msg: _Msg, tick: int):
        """Offline pass-through: the node is churned out, so the model is
        lost to it (marked seen — a later rejoin never delivers it late) but
        the flood keeps moving. The ttl decrement rides an UNSIGNED relay
        receipt: Eq. (1) still counts the hop, and ``confirm_block`` only
        co-signs receipts it can ``verify()``, so the stub never becomes a
        confirmation."""
        if msg.tx.d in node.seen_tx:
            self.stats["tx_dropped_dup"] += 1
            return
        node.seen_tx.add(msg.tx.d)
        if not msg.tx.verify(now=tick):
            self.stats["tx_dropped_expired"] += 1
            return
        nxt = msg.tx.next_received_at_ttl()
        if nxt <= 0:
            return
        msg.tx.receipts.append(Receipt(
            creator=node.info, transaction_digest=msg.tx.d,
            received_at_ttl=nxt, accuracy=0.0, create_time=tick))
        for peer in self.neighbors(node.name):
            if peer != msg.src:
                self._push(tick + self._latency(), "tx", peer, node.name,
                           msg.tx, msg.params)

    def _deliver_tx(self, msg: _Msg, tick: int):
        node = self.nodes[msg.dest]
        if msg.dest in self.dead:
            return
        if msg.dest in self.offline:
            self._relay_tx(node, msg, tick)
            return
        receipt, forward = node.receive_transaction(msg.tx, msg.params, tick)
        if receipt is None:
            key = ("tx_dropped_expired" if not msg.tx.verify(now=tick)
                   else "tx_dropped_dup")
            self.stats[key] += 1
            return
        self.stats["tx_delivered"] += 1
        # receipt flows back to the generator (Fig 1) for block assembly
        gen_name = self._addr_to_name(msg.tx.generator.address)
        if gen_name and gen_name not in self.dead and gen_name not in self.offline:
            self._push(tick + self._latency(), "receipt", gen_name,
                       node.name, receipt, None)
        if node.maybe_update_model(tick):
            self.stats["fedavg_rounds"] += 1
        if forward:   # partial consensus: keep flooding while ttl remains
            for peer in self.neighbors(node.name):
                if peer != msg.src:
                    self._push(tick + self._latency(), "tx", peer, node.name,
                               msg.tx, msg.params)

    def _maybe_block(self, node: DFLNode, tick: int):
        if not node.ready_for_block():
            return
        draft = node.draft_block(tick)
        confirmations = []
        for peer in self.neighbors(node.name):
            if peer in self.offline:
                continue            # churned-out neighbors cannot witness
            confirmations.extend(self.nodes[peer].confirm_block(draft))
        if node.finalize_block(draft, confirmations):
            self.stats["blocks"] += 1

    # -------------------------------------------------------------------- run
    def run(self, progress: Optional[Callable] = None):
        with device_lib.deterministic():
            self._run(progress)
        return self

    def _run(self, progress):
        for tick in range(self.cfg.ticks):
            if self.membership is not None:
                # top of tick, BEFORE delivery — same order as the lax
                # engines' membership step (leave/join gates this tick's
                # arrivals and this tick's countdown decrement)
                self._apply_membership_events(tick)
            while self.queue and self.queue[0].tick <= tick:
                msg = heapq.heappop(self.queue)
                if msg.kind == "tx":
                    self._deliver_tx(msg, tick)
                elif (msg.kind == "receipt" and msg.dest not in self.dead
                      and msg.dest not in self.offline):
                    self.nodes[msg.dest].attach_receipt(msg.tx)
            for name, node in self.nodes.items():
                if name in self.dead or name in self.offline:
                    continue
                self.next_train[name] -= 1
                if self.next_train[name] <= 0:
                    self._broadcast_tx(node, tick)
                    self._maybe_block(node, tick)
                    base = self.rand.randint(*self.cfg.train_interval)
                    self.next_train[name] = base * self.straggler_factor.get(name, 1)
            if tick % self.cfg.record_every == 0:
                for name, node in self.nodes.items():
                    if name not in self.dead and name not in self.offline:
                        node.record(tick, float(self.test_fn(node.params)))
                if progress:
                    progress(tick, self)


def fully_connected(names: Sequence[str]) -> Dict[str, List[str]]:
    return {a: [b for b in names if b != a] for a in names}


def ring(names: Sequence[str]) -> Dict[str, List[str]]:
    n = len(names)
    return {names[i]: [names[(i - 1) % n], names[(i + 1) % n]] for i in range(n)}


def mean_reputation(nodes: Sequence[DFLNode], target_address: str) -> float:
    """A node's reputation averaged over all other nodes' local views
    (paper Fig 15/17 metric)."""
    vals = [n.reputation.get(target_address) for n in nodes
            if n.reputation.get(target_address) is not None]
    return sum(vals) / len(vals) if vals else 1.0
