"""Vectorized tick simulator: the paper's §VI-D network experiments at
thousand-node scale, on one device.

Port of the JAX package's ``repro.chain.simlax`` single-run engine in eager
PyTorch. The heap ``Simulator`` (``repro_torch.chain.network``) walks an
event queue one message at a time; this engine runs the same tick process
with every per-node action batched over the federation:

* the tick loop is a Python loop (the JAX engine's ``lax.scan``); the state
  lives on ``device`` (CUDA unless the caller asks for the CPU);
* node training is one stacked call (``Scenario.train_stacked``) over the
  nodes that train this tick, receipt evaluation one stacked call
  (``Scenario.eval_stacked``) over the tick's work items;
* message delivery is a masked gather/scatter over the topology:
  ``arrive[dst, src]`` holds the delivery tick of the in-flight model from
  ``src`` (INT32_MAX when none; the ``compact`` engine carries the same
  information in ``(N, budget)`` receiver slots), set at broadcast time to
  ``t + hop_distance * latency`` for every node within ``ttl`` hops;
* the FedAvg buffer is the streaming form of Eq. 3 (weighted sum + weight
  total + count) plus a running (min accuracy, argmin sender) pair for the
  reputation punishment.

Receipt evaluation has three interchangeable engines
(``SimLaxConfig.delivery``), each held to the others by the tests:

``compact`` (default)
    Arrival state in per-receiver slots, broadcasts scattered through a
    static inverse map; the tick's due (receiver, slot) pairs are gathered
    into one work buffer (ascending, so each receiver's items form one
    segment, in ascending-src order), evaluated in one stacked call, and
    reduced back per receiver by ``torch.segment_reduce``, which sums each
    segment in order: two runs of one seed give the same bits on the card,
    where ``index_add_``'s atomics would not. The buffer holds the tick's
    due count; ``topology.compaction_budget`` bounds it (the JAX engine's
    static width W), and ``SimLaxConfig.compact_budget`` overrides the
    bound. A tick with more due deliveries than the bound raises
    ``RuntimeError`` from ``run()``: receipts are never dropped.
``sparse``
    Evaluates all ``N * budget`` static ball slots on a tick with at least
    one delivery, masked by dueness.
``dense``
    Evaluates all N² (dst, src) pairs, masked by dueness: the oracle.

``sharded`` (ROADMAP queue 1 item 12) and batched runs over a
``BatchedFederationSpec`` (item 10) are not ported and raise
``NotImplementedError``.

Host synchronisations: two a tick, both reads of integer state the next
step branches on — the tick's due count (whether any delivery is due, and
the work buffer's length) and the set of nodes that train. The JAX
engine's ``lax.cond`` over the whole federation becomes a Python ``if``;
only the training nodes train, and only the training attackers run their
attack (the JAX engine computes every node and masks; the results are the
same).

Randomness (``repro_torch.chain.attacks``): the JAX engine's
``fold_in(PRNGKey(seed), t)`` streams become generators on ``device``
seeded from (seed, tick, fold) by ``attacks.stream_key_at`` — fold 0 draws
the tick's train batches, fold 2 the train-interval redraw, fold 12345 of
the base key the initial countdowns — and each attacker draws from its own
``attacks.attack_key_at(seed, tick, attack_fold(group), node)``, the
generator the heap engine's ``DFLNode`` uses, so randomized attacks agree
bit for bit across the two engines. A fixed interval (``lo == hi``) draws
nothing. The draws differ from the JAX package's, as every port draw does.

Determinism on the card: every reduction is ordered (segment sums, matrix
products, ``amin``), scatters write each real target once, and cuDNN is
held to deterministic algorithms for the run.

Dynamic membership (``FederationSpec.membership``) follows the JAX engine:
events apply at the top of the tick, offline nodes freeze their train
countdowns and receive nothing (models in flight toward them are lost),
and a rejoiner's reputation column is decayed in every peer's view.

Deliberate approximations vs the heap reference (the JAX engine's): a
FedAvg round consumes the whole pending buffer at the end of the tick;
exactly one worst sender is punished a round; a node re-broadcasting
before its previous model finished propagating overwrites the in-flight
snapshot (``__init__`` warns when ``min train interval < ttl * latency``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch import device as device_lib
from repro_torch import tree
from repro_torch.chain import attacks as attacks_lib
from repro_torch.chain.attacks import BatchedFederationSpec
from repro_torch.core import compression
from repro_torch.core import topology as topology_lib

_NEVER = np.iinfo(np.int32).max
_EPS = 1e-12
_TRAIN_FOLD, _INTERVAL_FOLD, _COUNTDOWN_FOLD = 0, 2, 12345

DELIVERY_ENGINES = ("compact", "sparse", "dense", "sharded")
COMPRESS_MODES = (None, "int8")


@dataclasses.dataclass
class SimLaxConfig:
    ticks: int = 200
    train_interval: tuple = (8, 16)   # uniform random ticks between trains
    latency: int = 2                  # per-hop delivery delay (ticks)
    ttl: int = 2                      # flood radius (hops)
    record_every: int = 10
    seed: int = 0
    delivery: str = "compact"         # receipt engine: see DELIVERY_ENGINES
    shards: Optional[int] = None      # sharded engine: device count
    compact_budget: Optional[int] = None
    # ^ overrides the compact engine's bound on one tick's due deliveries
    #   (default: the exact topology.compaction_budget); a tick above it
    #   makes run() raise.
    compress: Optional[str] = None    # None | "int8" wire quantization
    # ^ "int8": every broadcast payload is quantize->dequantize round-
    #   tripped ONCE at the sender (repro_torch.core.compression), so all
    #   receivers of that broadcast see the identical reconstruction.
    #   Attacks apply BEFORE quantization; committed params stay full
    #   precision — only the wire payload is lossy.


@dataclasses.dataclass
class SimLaxResult:
    params: object                    # numpy tree, leaves (N, ...)
    reputation: np.ndarray            # (N, N) row i = node i's local view
    acc_history: np.ndarray           # (num_records, N) test accuracy
    record_ticks: np.ndarray          # (num_records,)
    stats: dict                       # broadcasts / deliveries / fedavg_rounds
    final_state: dict = dataclasses.field(default_factory=dict)
    # ^ end-of-run arrive/w_sum/buf_cnt/min_acc/min_sender/next_train as
    #   numpy, arrive in the (N, N) layout whatever the engine
    sent: object = None               # numpy tree (N, ...): each node's LAST
    # broadcast payload (post-attack, post-wire)

    def mean_reputation(self, target: int) -> float:
        """target's reputation averaged over other nodes' local views
        (paper Fig 15/17 metric)."""
        n = self.reputation.shape[0]
        others = [i for i in range(n) if i != target]
        return float(self.reputation[others, target].mean())


def _col(v, like):
    """(N,) ``v`` shaped to broadcast over the leading axis of ``like``."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


class LaxSimulator:
    """Drives a vectorized federation over a virtual-time network::

        LaxSimulator(scenario, topology, spec, rep_impl, cfg, device="cuda")

    * ``scenario`` — a ``repro_torch.chain.scenarios.Scenario`` (its stacked
      ``train_stacked`` / ``eval_stacked`` / ``test_stacked``);
    * ``spec`` — a ``FederationSpec`` role sheet, the one the heap
      simulator is built from (``scenarios.make_heap_simulator``);
    * ``device`` — where the state and the work live; ``"cuda"`` raises
      without a CUDA device.
    """

    def __init__(self, scenario, topology: topology_lib.Topology, spec,
                 rep_impl, cfg: SimLaxConfig, *, device="cuda"):
        if isinstance(spec, BatchedFederationSpec):
            raise NotImplementedError(
                "batched runs (BatchedFederationSpec) are not ported yet: "
                "ROADMAP queue 1 item 10")
        self.device = dev = device_lib.resolve(device)
        n = topology.num_nodes
        if spec.num_nodes != n:
            raise ValueError(
                f"spec is for {spec.num_nodes} nodes, topology has {n}")
        if cfg.latency < 1:
            raise ValueError(
                "latency must be >= 1 tick (0 would schedule arrivals at "
                "the already-processed current tick and drop every message)")
        if cfg.delivery not in DELIVERY_ENGINES:
            raise ValueError(
                f"unknown delivery engine {cfg.delivery!r}; "
                f"choose from {DELIVERY_ENGINES}")
        if cfg.compress not in COMPRESS_MODES:
            raise ValueError(
                f"unknown compress mode {cfg.compress!r}; "
                f"choose from {COMPRESS_MODES}")
        if cfg.shards is not None and cfg.delivery != "sharded":
            raise ValueError(
                f"SimLaxConfig.shards only applies to delivery='sharded' "
                f"(got delivery={cfg.delivery!r})")
        if cfg.delivery == "sharded":
            raise NotImplementedError(
                "delivery='sharded' is not ported yet: ROADMAP queue 1 "
                "item 12")
        if cfg.train_interval[0] < cfg.ttl * cfg.latency:
            warnings.warn(
                f"min train interval ({cfg.train_interval[0]}) < ttl * "
                f"latency ({cfg.ttl * cfg.latency}): a node can re-broadcast "
                "before its previous model finished propagating, and this "
                "engine's single in-flight snapshot per (dst, src) pair "
                "overwrites the old delivery — event counts will fall below "
                "the heap reference's. Raise train_interval or lower "
                "ttl/latency for exact parity.",
                stacklevel=2)
        if cfg.compact_budget is not None and cfg.compact_budget < 1:
            raise ValueError(
                f"compact_budget must be >= 1, got {cfg.compact_budget}")
        self.scenario, self.topology, self.spec = scenario, topology, spec
        self.rep_impl, self.cfg = rep_impl, cfg

        # flooding routes only through alive nodes; the engine consumes
        # distances <= ttl only, so the BFS stops there
        alive = np.ones((n,), np.bool_)
        alive[list(spec.dead)] = False
        adj = topology.adj & alive[None, :] & alive[:, None]
        dist = topology_lib.hop_distance_from_adj(adj, max_hops=cfg.ttl)
        reach = (dist >= 1) & (dist <= cfg.ttl)
        delay = np.where(reach, dist * cfg.latency, 0).astype(np.int32)
        budgets = topology_lib.batch_budgets(
            topology.adj, cfg.ttl, cfg.train_interval, [spec.dead],
            latency=cfg.latency, dists=[dist])
        # slot width: the largest ttl-ball; slot k of dst is its k-th
        # in-ball sender in ascending src order (padding slots map to
        # non-reach senders, never due)
        self.delivery_budget = budget = budgets.delivery
        self.compact_budget = min(
            budgets.compaction if cfg.compact_budget is None
            else int(cfg.compact_budget), n * budget)
        slot_src = np.argsort(~reach, axis=1, kind="stable")[:, :budget]
        self._slot_src_np = slot_src.astype(np.int32)

        def on_dev(a, dtype=None):
            return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

        self._consts = {"alive": on_dev(alive),
                        "slot_src": on_dev(slot_src, torch.int64)}
        if cfg.delivery == "compact":
            # the inverse slot map: for each sender, the (dst, slot, delay)
            # triples it lands in; padding rows point at the dropped row n
            slot_of = np.full((n, n), -1, np.int64)
            slot_of[np.arange(n)[:, None], slot_src] = np.arange(budget)[None, :]
            slot_of[~reach] = -1
            inv_dst = np.full((n, budget), n, np.int64)
            inv_slot = np.zeros((n, budget), np.int64)
            inv_delay = np.zeros((n, budget), np.int32)
            for src in range(n):
                dsts = np.flatnonzero(reach[:, src])
                inv_dst[src, :len(dsts)] = dsts
                inv_slot[src, :len(dsts)] = slot_of[dsts, src]
                inv_delay[src, :len(dsts)] = delay[dsts, src]
            self._consts.update(inv_dst=on_dev(inv_dst),
                                inv_slot=on_dev(inv_slot),
                                inv_delay=on_dev(inv_delay))
        else:
            self._consts.update(reach=on_dev(reach), delay=on_dev(delay))

        # attacks: one group per distinct instance, run over its static
        # attacker ids; group order keys the attack folds
        groups = spec.attack_groups()
        self._attacks = tuple(
            (attacks_lib.attack_fold(g), attack, np.flatnonzero(mask))
            for g, (attack, mask) in enumerate(groups))
        self._malicious = np.zeros((n,), np.bool_)
        self._malicious[list(spec.malicious)] = True
        strag = np.ones((n,), np.int32)
        for k, v in spec.stragglers:
            strag[k] = v
        self._consts["straggler"] = on_dev(strag)

        # membership: dense per-tick masks, expanded once on the host
        self._membership = spec.membership is not None
        if self._membership:
            alive_t, rejoin_t = spec.membership.timeline(n, cfg.ticks,
                                                         dead=spec.dead)
            self._rejoin_np = rejoin_t
            self._consts.update(
                alive_t=on_dev(alive_t), rejoin_t=on_dev(rejoin_t),
                rejoin_decay=on_dev(np.float32(spec.membership.rejoin_decay)))

        self._eval_data = scenario.eval_data(dev)
        self._train_data = scenario.train_data(dev)

    # ------------------------------------------------------------- pieces
    def _intervals(self, generator, count):
        lo, hi = self.cfg.train_interval
        if lo == hi:
            return torch.full((count,), lo, dtype=torch.int32, device=self.device)
        return torch.randint(lo, hi + 1, (count,), generator=generator,
                             device=self.device, dtype=torch.int32)

    def _initial_countdown(self):
        n = self.topology.num_nodes
        if self.spec.initial_countdown is not None:
            return torch.as_tensor(self.spec.initial_countdown,
                                   dtype=torch.int32, device=self.device)
        # heap parity: the FIRST countdown is not straggler-scaled
        return self._intervals(attacks_lib.stream_key_at(
            self.cfg.seed, None, _COUNTDOWN_FOLD, self.device), n)

    # ------------------------------------------------------------- delivery
    # The three engines differ only in which (receiver, sender) items they
    # evaluate: dense all N² pairs, sparse all N * budget ball slots,
    # compact the tick's due slots. Items come grouped by receiver, in
    # ascending sender order, and ``_reduce`` folds them back the same way
    # for all three, so the engines agree bit for bit.
    def _items_dense(self, due):
        n = due.shape[0]
        ar = torch.arange(n, device=self.device)
        return (ar.repeat_interleave(n), ar.repeat(n), due.reshape(-1),
                torch.full_like(ar, n))

    def _items_sparse(self, due):
        n, budget = due.shape[0], self.delivery_budget
        slot_src = self._consts["slot_src"]
        ar = torch.arange(n, device=self.device)
        return (ar.repeat_interleave(budget), slot_src.reshape(-1),
                torch.gather(due, 1, slot_src).reshape(-1),
                torch.full_like(ar, budget))

    def _items_compact(self, due, count):
        """The ``count`` due (receiver, slot) pairs of the (N, budget)
        slot-layout dueness, gathered into one work buffer without a host
        sync: due item k goes to buffer slot cumsum - 1 (ascending, so
        receivers stay grouped and slots stay in ascending-src order), the
        rest to the spare slot ``count``, which is dropped."""
        n, budget = due.shape
        flat_ok = due.reshape(-1)
        pos = torch.cumsum(flat_ok, 0) - 1
        buf = torch.empty((count + 1,), dtype=torch.int64, device=self.device)
        buf.scatter_(0, torch.where(flat_ok, pos, count),
                     torch.arange(n * budget, device=self.device))
        flat_idx = buf[:count]
        src = self._consts["slot_src"].reshape(-1)[flat_idx]
        return (flat_idx // budget, src, torch.ones_like(src, dtype=torch.bool),
                due.sum(1))

    def _reduce(self, s, due, rcv, src, ok, lengths):
        """Evaluate each item (sender ``src``'s in-flight model on receiver
        ``rcv``'s data), weight it by Eq. 2, and fold the receivers' items
        into the streaming Eq. 3 buffer and the running (min accuracy,
        lowest-src argmin) pair. ``ok`` masks items that are not due;
        ``lengths`` counts each receiver's items."""
        n = due.shape[0]
        count = rcv.shape[0]
        accs = torch.where(ok, self._eval(s["sent"], src, rcv), 0.0)
        w = torch.where(ok, s["rep"][rcv, src] * accs, 0.0)   # Eq. 2 per item
        # segment r = receiver r's running sum, then its items: each sum
        # runs carry + x0 + x1 + ... in item order, one rounding an
        # addition, as the JAX compact engine's scatter-add does.
        # segment_reduce sums each element of 2-D data in one sequential
        # loop, on the CPU and on the card
        seg = lengths + 1
        carry_at = torch.cumsum(seg, 0) - seg
        item_at = torch.arange(count, device=self.device) + rcv + 1

        def add(carry, items):
            buf = torch.empty((n + count,) + carry.shape[1:], dtype=carry.dtype,
                              device=self.device)
            buf[carry_at] = carry
            buf[item_at] = items
            flat = buf.reshape(n + count, -1)
            return torch.segment_reduce(flat, "sum", lengths=seg,
                                        axis=0).reshape(carry.shape)

        acc_sum = tree.map(lambda a, m: add(a, _col(w, m) * m[src].float()),
                           s["acc_sum"], s["sent"])
        masked = torch.where(ok, accs, torch.inf)
        batch_min = torch.full((n,), torch.inf, device=self.device).scatter_reduce(
            0, rcv, masked, "amin")
        # lowest-src tie-break: among the items at the receiver's min,
        # scatter-min the sender index (n = none)
        tie = ok & (masked == batch_min[rcv])
        batch_sender = torch.full((n,), n, dtype=torch.int64,
                                  device=self.device).scatter_reduce(
            0, rcv, torch.where(tie, src, n), "amin")
        batch_sender = torch.where(batch_sender == n, 0, batch_sender)
        return (acc_sum, add(s["w_sum"], w), s["buf_cnt"] + due.sum(1),
                batch_min, batch_sender)

    def _eval(self, sent, src, rcv):
        """Accuracies of ``sent[src[k]]`` on receiver ``rcv[k]``'s eval data."""
        models = tree.map(lambda x: x[src], sent)
        data = tree.map(lambda x: x[rcv], self._eval_data)
        return self.scenario.eval_stacked(models, data).to(torch.float32)

    # -------------------------------------------------------------- training
    def _train_and_send(self, params, sent, rows_np, t):
        """Train nodes ``rows_np``, commit the honest ones' results, run
        each training attacker's attack on its candidate, put the payloads
        through the wire, and write them to ``sent`` (in place)."""
        dev, seed = self.device, self.cfg.seed
        rows = torch.as_tensor(rows_np, device=dev)
        committed = tree.map(lambda x: x[rows], params)
        trained = self.scenario.train_stacked(
            params, attacks_lib.stream_key_at(seed, t, _TRAIN_FOLD, dev),
            self._train_data, rows)
        # attackers never COMMIT local training; their honestly trained
        # candidate is still handed to the attack
        honest = np.flatnonzero(~self._malicious[rows_np])
        if honest.size:
            pick = torch.as_tensor(honest, device=dev)
            for p, tr in zip(tree.leaves(params), tree.leaves(trained)):
                p.index_copy_(0, rows[pick], tr[pick].to(p.dtype))
        outgoing = trained
        for fold, attack, ids in self._attacks:
            pos = np.flatnonzero(np.isin(rows_np, ids))
            if not pos.size:
                continue
            bad = [attack.apply(
                attacks_lib.attack_key_at(seed, t, fold, int(rows_np[j]), dev),
                tree.map(lambda x, j=j: x[j], trained),
                tree.map(lambda x, j=j: x[j], committed), t) for j in pos]
            at = torch.as_tensor(pos, device=dev)
            outgoing = tree.map(
                lambda o, *b: o.index_copy(0, at, torch.stack(b).to(o.dtype)),
                outgoing, *bad)
        if self.cfg.compress == "int8":
            # the sender quantizes its (post-attack) broadcast ONCE: one
            # quantize and one dequantize launch for the stacked tree,
            # bitwise the per-node round trips (blocks run along the last
            # axis only)
            outgoing = compression.roundtrip_tree(outgoing)
        for s, o in zip(tree.leaves(sent), tree.leaves(outgoing)):
            s.index_copy_(0, rows, o)

    # -------------------------------------------------------------------- run
    def run(self, params0=None) -> SimLaxResult:
        """params0: tree with leading N dim (default: the scenario's
        stacked init), copied onto ``device``. Raises ``RuntimeError`` when
        a tick's due deliveries exceed the compact engine's bound."""
        dev = self.device
        if params0 is None:
            params0 = self.scenario.init_params_stacked(dev)
        params = tree.map(lambda x: torch.as_tensor(x).to(dev).clone(), params0)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return self._run(params)
        finally:
            torch.backends.cudnn.deterministic = deterministic

    def _run(self, params):
        cfg, rep_impl, c, dev = self.cfg, self.rep_impl, self._consts, self.device
        n = self.topology.num_nodes
        compact = cfg.delivery == "compact"
        items_of = {"dense": self._items_dense,
                    "sparse": self._items_sparse}.get(cfg.delivery)
        s = {
            "sent": tree.map(torch.zeros_like, params),
            "rep": torch.full((n, n), rep_impl.initial, device=dev),
            "acc_sum": tree.map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=dev), params),
            "w_sum": torch.zeros((n,), device=dev),
            "buf_cnt": torch.zeros((n,), dtype=torch.int64, device=dev),
        }
        # compact keeps the in-flight state in (N, budget) receiver slots
        # plus a dropped row n for padding scatters; the oracles (N, N)
        arrive = torch.full(
            (n + 1, self.delivery_budget) if compact else (n, n), _NEVER,
            dtype=torch.int32, device=dev)
        live = arrive[:n]
        min_acc = torch.full((n,), torch.inf, device=dev)
        min_sender = torch.zeros((n,), dtype=torch.int64, device=dev)
        next_train = self._initial_countdown()
        fedavg_rounds = torch.zeros((), dtype=torch.int64, device=dev)
        broadcasts = np.zeros((n,), np.int64)
        deliveries = max_due = 0
        rows_n = torch.arange(n, device=dev)
        acc_rows = []

        for t in range(cfg.ticks):
            # ---- 0. membership: events apply at the TOP of the tick;
            # rejoiners get every peer's reputation COLUMN decayed
            if self._membership:
                a_t = c["alive_t"][t]
                if self._rejoin_np[t].any():
                    decayed = torch.clamp(s["rep"] * c["rejoin_decay"],
                                          rep_impl.floor, rep_impl.initial)
                    s["rep"] = torch.where(c["rejoin_t"][t][None, :], decayed,
                                           s["rep"])
            else:
                a_t = c["alive"]

            # ---- 1. deliveries due at t; an arrival at an offline
            # receiver expires without delivering
            expired = live == t
            due = expired & a_t[:, None]
            count = int(due.sum())                       # host sync 1 of 2
            if count:
                if compact and count > self.compact_budget:
                    raise RuntimeError(
                        f"compact delivery overflow: tick {t} had {count} due "
                        f"deliveries but the bound is {self.compact_budget} "
                        "(SimLaxConfig.compact_budget override; the exact "
                        "topology.compaction_budget bound for this "
                        "topology/ttl/interval cannot overflow)")
                items = (self._items_compact(due, count) if compact
                         else items_of(due))
                s["acc_sum"], s["w_sum"], s["buf_cnt"], batch_min, batch_sender = \
                    self._reduce(s, due, *items)
                better = batch_min < min_acc
                min_acc = torch.where(better, batch_min, min_acc)
                min_sender = torch.where(better, batch_sender, min_sender)
            live.masked_fill_(expired, _NEVER)
            deliveries += count
            max_due = max(max_due, count)

            # ---- 2. weighted FedAvg (Eq. 3) where the buffer filled up
            fire = s["buf_cnt"] >= rep_impl.buffer_size
            apply = fire & (s["w_sum"] > _EPS)
            denom = torch.clamp_min(s["w_sum"], _EPS)

            def leaf(acc, p):
                p32 = p.to(torch.float32)
                avg = acc / _col(denom, acc)
                return torch.where(_col(apply, acc), 0.5 * (avg + p32),
                                   p32).to(p.dtype)

            params = tree.map(leaf, s["acc_sum"], params)
            # punish the worst sender of each fired buffer (§IV-D1)
            hit = fire & (min_acc < torch.inf)
            cur = s["rep"][rows_n, min_sender]
            s["rep"][rows_n, min_sender] = torch.where(
                hit, torch.clamp(cur - rep_impl.penalty, rep_impl.floor,
                                 rep_impl.initial), cur)
            keep = (~fire).to(torch.float32)
            s["acc_sum"] = tree.map(lambda a: a * _col(keep, a), s["acc_sum"])
            s["w_sum"] = s["w_sum"] * keep
            s["buf_cnt"] = torch.where(fire, 0, s["buf_cnt"])
            min_acc = torch.where(fire, torch.inf, min_acc)
            min_sender = torch.where(fire, 0, min_sender)
            fedavg_rounds += apply.sum()

            # ---- 3. train + broadcast where the countdown expired;
            # offline nodes' countdowns freeze
            next_train = next_train - (a_t.to(torch.int32)
                                       if self._membership else 1)
            trains = (next_train <= 0) & a_t
            rows_np = np.flatnonzero(trains.cpu().numpy())   # host sync 2 of 2
            if rows_np.size:
                self._train_and_send(params, s["sent"], rows_np, t)
                rows = torch.as_tensor(rows_np, device=dev)
                if compact:
                    arrive[c["inv_dst"][rows], c["inv_slot"][rows]] = \
                        t + c["inv_delay"][rows]
                else:
                    sched = trains[None, :] & c["reach"]
                    live.copy_(torch.where(sched, t + c["delay"], live))
                fresh = self._intervals(attacks_lib.stream_key_at(
                    cfg.seed, t, _INTERVAL_FOLD, dev), n)[rows]
                next_train[rows] = fresh * c["straggler"][rows]
                broadcasts[rows_np] += 1
            # the global test eval runs on record ticks only
            if t % cfg.record_every == 0:
                acc_rows.append(self.scenario.test_stacked(params).to(torch.float32))

        final = dict(params=params, sent=s["sent"], rep=s["rep"],
                     arrive=live, w_sum=s["w_sum"], buf_cnt=s["buf_cnt"],
                     min_acc=min_acc, min_sender=min_sender,
                     next_train=next_train)
        counters = dict(broadcasts=broadcasts, deliveries=deliveries,
                        max_due=max_due, fedavg_rounds=int(fedavg_rounds))
        acc = (torch.stack(acc_rows).cpu().numpy() if acc_rows
               else np.zeros((0, n), np.float32))
        return self._package(final, counters, acc)

    def _package(self, final, counters, acc_history):
        """Host-side result assembly: expand the compact slot state back to
        the (N, N) oracle layout and fold the counters into the stats."""
        cfg = self.cfg
        n = self.topology.num_nodes
        final_arrive = final["arrive"].cpu().numpy()
        if cfg.delivery == "compact":
            dense = np.full((n, n), _NEVER, np.int32)
            dense[np.arange(n)[:, None], self._slot_src_np] = final_arrive
            final_arrive = dense
        # one broadcast's bytes under the configured compression; each
        # delivery moves one copy
        broadcast_bytes = compression.payload_bytes(
            tree.map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype,
                                           device="meta"), final["sent"]),
            cfg.compress)
        deliveries = counters["deliveries"]
        as_np = {k: final[k].cpu().numpy()
                 for k in ("w_sum", "min_acc")}
        as_np.update({k: final[k].cpu().numpy().astype(np.int32)
                      for k in ("buf_cnt", "min_sender", "next_train")})
        return SimLaxResult(
            params=convert.params_to_numpy(final["params"]),
            reputation=final["rep"].cpu().numpy(),
            acc_history=acc_history,
            record_ticks=np.arange(0, cfg.ticks, cfg.record_every),
            stats={
                "broadcasts": int(counters["broadcasts"].sum()),
                "broadcasts_per_node": counters["broadcasts"].astype(np.int32),
                "deliveries": deliveries,
                "fedavg_rounds": counters["fedavg_rounds"],
                "delivery": cfg.delivery,
                "delivery_budget": self.delivery_budget,
                "compact_budget": self.compact_budget,
                "max_tick_deliveries": counters["max_due"],
                "compress": cfg.compress,
                "broadcast_bytes": broadcast_bytes,
                "wire_bytes": broadcast_bytes * deliveries,
            },
            final_state={"arrive": final_arrive, **as_np},
            sent=convert.params_to_numpy(final["sent"]),
        )
