"""Vectorized tick simulator: the paper's §VI-D network experiments at
thousand-node scale, on one device.

Port of the JAX package's ``repro.chain.simlax`` engine in eager PyTorch.
The heap ``Simulator`` (``repro_torch.chain.network``) walks an event queue
one message at a time; this engine runs the same tick process with every
per-node action batched over the federation:

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

``sharded``
    The compact engine's receivers partitioned over the S ranks of a
    process group (``SimLaxConfig.shards``; start the ranks with
    ``repro_torch.launch.mesh.spawn`` and build the simulator on each).
    Rank p holds receiver rows ``[p * m, (p + 1) * m)``, m = N / S: their
    params, in-flight ``sent`` models, arrival slots, reputation rows and
    data. The ``sent`` blocks a rank's receivers need cross between ranks
    through ``core.gossip.tree_ppermute``, one exchange per occupied shard
    offset (the production gossip round's transport), after every tick on
    which a node trained: that set (the full-N ``trains`` vector) is the
    same on every rank, so every rank issues the same exchanges. The
    countdown and interval draws, the train indices (drawn for all N nodes
    and kept per node) and each attacker's generator (keyed by its global
    id) are computed for the whole federation on every rank, which keeps
    the ranks in step with no other collective. Arrivals are scheduled
    receiver-side (slot k of a receiver waits on its k-th in-ball sender).
    Each rank's work buffer is bounded by ``topology.compaction_budget`` on
    its own receivers (``compact_budget`` overrides it a shard); a run
    whose shard went over raises ``RuntimeError`` at its end. ``run()``
    gathers the blocks, so every rank returns the full result. ``shards=
    None`` takes the group's size, 1 with no process group (no exchange,
    in process). Bitwise ``compact`` wherever the scenario's stacked calls
    give a model the same bits whatever the number of models a call (the
    toy at every S; LeNet at S = 1).

Batched runs (compact, sparse and dense engines): constructed from a
``BatchedFederationSpec`` (B same-N role sheets, one seed each; one shared
scenario, topology and config), the engine runs the B federations
together and ``run()`` returns a list of B ``SimLaxResult``s. A single run
is the batch of one. Every state tensor and
per-member constant carries a leading batch axis; the slot width and the
compaction bound take the max over the members
(``topology.batch_budgets``). Member b is bitwise the single run of
``specs[b]`` at ``SimLaxConfig(seed=seeds[b])``, on every engine:

* each member draws from its own generators (below);
* the compact work buffer holds the batch's due items member-major, and
  one ``segment_reduce`` over (member, receiver) segments sums each
  receiver's receipts in its single run's order;
* the stacked train, eval and test calls run once per member, so each call
  has its single run's shape: one call over every member's models changes
  a model's bits (on the CPU a LeNet SGD step over 24 stacked models
  differs from the same step over 2 in the last bits, as the convolution
  and matrix-product kernels block the work by the whole shape);
* everything else (delivery bookkeeping, the reduction, FedAvg, the
  punishment, the int8 wire) runs once for the whole batch: one
  ``compression.roundtrip_tree`` a training tick over all members'
  outgoing rows, whose blocks run along the last axis only.

Host synchronisations: two a tick for the whole batch, both reads of
integer state the next step branches on — the (B,) due counts (whether any
delivery is due, and the work buffer's length) and the (B, N) set of nodes
that train. The JAX engine's ``lax.cond`` over the whole federation becomes
a Python ``if``; only the training nodes train, and only the training
attackers run their attack (the JAX engine computes every node and masks;
the results are the same).

Randomness (``repro_torch.chain.attacks``): the JAX engine's
``fold_in(PRNGKey(seed), t)`` streams become generators on ``device``
seeded from (seed, tick, fold) by ``attacks.stream_key_at`` — fold 0 draws
the tick's train batches (all N nodes' indices, so a node's batch does not
depend on who trains), fold 2 the train-interval redraw, fold 12345 of the
base key the initial countdowns — and each attacker draws from its own
``attacks.attack_key_at(seed, tick, fold, node)``, where ``fold`` is the
member's own ``attack_fold(group)``: the generator the heap engine's
``DFLNode`` uses, so randomized attacks agree bit for bit across the two
engines. A fixed interval (``lo == hi``) draws nothing. The draws differ
from the JAX package's, as every port draw does.

Determinism on the card: every reduction is ordered (segment sums, matrix
products, ``amin``), scatters write each real target once, and cuDNN is
held to deterministic algorithms for the run (``device.deterministic``).

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
import torch.distributed as dist

from repro_torch import convert
from repro_torch import device as device_lib
from repro_torch import tree
from repro_torch.chain import attacks as attacks_lib
from repro_torch.chain.attacks import BatchedFederationSpec
from repro_torch.core import compression, gossip
from repro_torch.core import topology as topology_lib
from repro_torch.launch import mesh as mesh_lib

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
    shards: Optional[int] = None      # sharded engine: rank count
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
    """``v`` shaped to broadcast over the leading axes of ``like`` that it
    covers ((B, N) against (B, N, ...), (M,) against (M, ...))."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


class LaxSimulator:
    """Drives a vectorized federation, or a batch of them, over a
    virtual-time network::

        LaxSimulator(scenario, topology, spec, rep_impl, cfg, device="cuda")

    * ``scenario`` — a ``repro_torch.chain.scenarios.Scenario`` (its stacked
      ``train_stacked`` / ``eval_stacked`` / ``test_stacked``);
    * ``spec`` — a ``FederationSpec`` role sheet, the one the heap
      simulator is built from (``scenarios.make_heap_simulator``), or a
      ``BatchedFederationSpec`` of B of them; ``run()`` then returns B
      results;
    * ``device`` — where the state and the work live; ``"cuda"`` raises
      without a CUDA device.

    ``delivery="sharded"`` takes its shards from the default process group
    (``launch.mesh.fed_group()``), or runs in process when none is up.
    """

    def __init__(self, scenario, topology: topology_lib.Topology, spec,
                 rep_impl, cfg: SimLaxConfig, *, device="cuda"):
        self.device = dev = device_lib.resolve(device)
        n = topology.num_nodes
        batched = isinstance(spec, BatchedFederationSpec)
        specs = spec.specs if batched else (spec,)
        for b, s in enumerate(specs):
            if s.num_nodes != n:
                raise ValueError(
                    (f"batch member {b}'s spec" if batched else "spec")
                    + f" is for {s.num_nodes} nodes, topology has {n}")
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
        if cfg.delivery == "sharded" and batched:
            raise ValueError(
                "delivery='sharded' does not compose with "
                "BatchedFederationSpec: run sharded federations one at a "
                "time, or batch with the compact engine")
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
        self._batched = batched
        self._specs = specs
        self.batch_size = len(specs) if batched else None
        self._seeds = spec.resolved_seeds(cfg.seed) if batched else (cfg.seed,)

        # per member: flooding routes only through alive nodes; the engine
        # consumes distances <= ttl only, so the BFS stops there
        alives, dists, reaches, delays = [], [], [], []
        for s in specs:
            alive = np.ones((n,), np.bool_)
            alive[list(s.dead)] = False
            adj = topology.adj & alive[None, :] & alive[:, None]
            dist = topology_lib.hop_distance_from_adj(adj, max_hops=cfg.ttl)
            reach = (dist >= 1) & (dist <= cfg.ttl)
            alives.append(alive)
            dists.append(dist)
            reaches.append(reach)
            delays.append(np.where(reach, dist * cfg.latency, 0).astype(np.int32))
        # one slot width and one work-buffer bound serve every member: the
        # max over the batch
        self.budgets = topology_lib.batch_budgets(
            topology.adj, cfg.ttl, cfg.train_interval, [s.dead for s in specs],
            latency=cfg.latency, dists=dists)
        # slot k of dst is its k-th in-ball sender in ascending src order
        # (padding slots map to non-reach senders, never due)
        self.delivery_budget = budget = self.budgets.delivery
        self.compact_budget = min(
            self.budgets.compaction if cfg.compact_budget is None
            else int(cfg.compact_budget), n * budget)
        slot_srcs = [np.argsort(~reach, axis=1, kind="stable")[:, :budget]
                     for reach in reaches]
        self._slot_src_np = np.stack(slot_srcs).astype(np.int32)  # (B, N, budget)

        def on_dev(arrays, dtype=None):
            return torch.as_tensor(np.stack(arrays), device=dev, dtype=dtype)

        self._consts = {"alive": on_dev(alives),
                        "slot_src": on_dev(slot_srcs, torch.int64)}
        self._block = (0, n)       # this process's receivers: [lo, lo + m)
        self.shards = self.shard_budget = None
        if cfg.delivery == "sharded":
            self._shard_layout(reaches[0], delays[0], dists[0],
                               alives[0], slot_srcs[0])
        elif cfg.delivery == "compact":
            # the inverse slot map: for each sender, the (dst, slot, delay)
            # triples it lands in; padding rows point at the dropped row n
            inv_dsts, inv_slots, inv_delays = [], [], []
            for reach, delay, slot_src in zip(reaches, delays, slot_srcs):
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
                inv_dsts.append(inv_dst)
                inv_slots.append(inv_slot)
                inv_delays.append(inv_delay)
            self._consts.update(inv_dst=on_dev(inv_dsts),
                                inv_slot=on_dev(inv_slots),
                                inv_delay=on_dev(inv_delays))
        else:
            self._consts.update(reach=on_dev(reaches), delay=on_dev(delays))

        # attacks: one entry per distinct instance over the batch, with the
        # (B, N) mask of its attackers and each member's own fold constant
        self._attacks = tuple(BatchedFederationSpec.build(specs).attack_union())
        self._malicious = np.zeros((len(specs), n), np.bool_)
        strag = np.ones((len(specs), n), np.int32)
        for b, s in enumerate(specs):
            self._malicious[b, list(s.malicious)] = True
            for k, v in s.straggler_map().items():
                strag[b, k] = v
        self._consts["straggler"] = torch.as_tensor(strag, device=dev)

        # membership: dense per-tick masks, expanded once on the host; a
        # member without churn keeps its static alive mask and decrements
        # every countdown each tick, as its single run does
        self._membership = any(s.membership is not None for s in specs)
        if self._membership:
            alive_ts, rejoin_ts, decays = [], [], []
            for s, alive in zip(specs, alives):
                if s.membership is None:
                    alive_ts.append(np.tile(alive, (cfg.ticks, 1)))
                    rejoin_ts.append(np.zeros((cfg.ticks, n), np.bool_))
                    decays.append(np.float32(1.0))
                else:
                    a_t, r_t = s.membership.timeline(n, cfg.ticks, dead=s.dead)
                    alive_ts.append(a_t)
                    rejoin_ts.append(r_t)
                    decays.append(np.float32(s.membership.rejoin_decay))
            self._rejoin_any = np.stack(rejoin_ts).any(axis=(0, 2))   # (ticks,)
            self._consts.update(
                alive_t=on_dev(alive_ts),
                rejoin_t=on_dev(rejoin_ts), rejoin_decay=on_dev(decays),
                churn=on_dev([s.membership is not None for s in specs]))

        lo, m = self._block

        def block(data):      # this process's rows of a scenario's data
            if data is None or m == n:
                return data
            return tree.map(lambda x: x[lo:lo + m].clone(), data)

        self._eval_data = block(scenario.eval_data(dev))
        self._train_data = block(scenario.train_data(dev))

    def _shard_layout(self, reach, delay, dist_, alive, slot_src):
        """delivery="sharded": this rank's receiver block, its work-buffer
        bound, the exchange's shard offsets and the receiver-side arrival
        tables (the JAX engine's layout, from its single member)."""
        cfg, n, dev = self.cfg, self.topology.num_nodes, self.device
        group = mesh_lib.fed_group()
        ranks = 1 if group is None else dist.get_world_size(group)
        shards = ranks if cfg.shards is None else int(cfg.shards)
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if n % shards:
            raise ValueError(
                f"delivery='sharded' needs num_nodes ({n}) divisible by "
                f"shards ({shards})")
        if shards > ranks:
            raise ValueError(
                f"shards={shards} but the fed process group has {ranks} "
                "rank(s): start one process a shard with "
                "repro_torch.launch.mesh.spawn and build the simulator on "
                "every rank")
        if 1 < shards < ranks:
            raise ValueError(
                f"shards={shards} needs a fed process group of {shards} "
                f"ranks, this one has {ranks}")
        m = n // shards
        p = dist.get_rank(group) if shards > 1 else 0
        lo = p * m
        # each shard compacts only the deliveries landing on its receivers
        adj = self.topology.adj & alive[None, :] & alive[:, None]
        per_shard = [topology_lib.compaction_budget(
            adj, cfg.ttl, cfg.train_interval, latency=cfg.latency, dist=dist_,
            receivers=np.arange(q * m, (q + 1) * m)) for q in range(shards)]
        want = (max(1, max(per_shard)) if cfg.compact_budget is None
                else int(cfg.compact_budget))
        self.shard_budget = min(want, m * self.delivery_budget)
        # shard p needs shard q's sent block iff some in-ball pair crosses
        # q -> p; offset d = (p - q) mod S: one exchange an occupied offset.
        # The pool is this rank's block, then one m-row block an offset;
        # row_of_src maps a global sender to its pool row (senders in no
        # exchanged block map to the last row, and are never due here)
        blk = np.arange(n) // m
        pairs = np.argwhere(reach)
        offsets = sorted(set(((blk[pairs[:, 0]] - blk[pairs[:, 1]]) % shards)
                             .tolist()) - {0})
        self._exchange_perms = [[(q, (q + d) % shards) for q in range(shards)]
                                for d in offsets]
        row_of_src = np.full((n,), (1 + len(offsets)) * m - 1, np.int64)
        row_of_src[lo:lo + m] = np.arange(m)
        for j, d in enumerate(offsets):
            q = (p - d) % shards
            row_of_src[q * m:(q + 1) * m] = (1 + j) * m + np.arange(m)
        rows = slice(lo, lo + m)
        self._consts.update(
            slot_src=torch.as_tensor(slot_src[rows][None], dtype=torch.int64,
                                     device=dev),
            slot_delay=torch.as_tensor(np.take_along_axis(
                delay, slot_src, axis=1)[rows][None], device=dev),
            slot_valid=torch.as_tensor(np.take_along_axis(
                reach, slot_src, axis=1)[rows][None], device=dev),
            row_of_src=torch.as_tensor(row_of_src, device=dev))
        self.shards, self._group, self._block = shards, group, (lo, m)

    # ------------------------------------------------------------- pieces
    def _intervals(self, generator, count):
        lo, hi = self.cfg.train_interval
        if lo == hi:
            return torch.full((count,), lo, dtype=torch.int32, device=self.device)
        return torch.randint(lo, hi + 1, (count,), generator=generator,
                             device=self.device, dtype=torch.int32)

    def _initial_countdown(self):
        """(B, N): each member's sheet, else its seeded draw (heap parity:
        the FIRST countdown is not straggler-scaled)."""
        n = self.topology.num_nodes
        rows = []
        for s, seed in zip(self._specs, self._seeds):
            if s.initial_countdown is not None:
                rows.append(torch.as_tensor(s.initial_countdown,
                                            dtype=torch.int32, device=self.device))
            else:
                rows.append(self._intervals(attacks_lib.stream_key_at(
                    seed, None, _COUNTDOWN_FOLD, self.device), n))
        return torch.stack(rows)

    def _fresh_intervals(self, t, members):
        """(B, N) train intervals drawn at tick ``t`` for the members that
        train (rows of the others are never read)."""
        b_n = self._consts["alive"].shape
        lo, hi = self.cfg.train_interval
        if lo == hi:
            return torch.full(b_n, lo, dtype=torch.int32, device=self.device)
        fresh = torch.zeros(b_n, dtype=torch.int32, device=self.device)
        for b in members.tolist():
            fresh[b] = self._intervals(attacks_lib.stream_key_at(
                self._seeds[b], t, _INTERVAL_FOLD, self.device), b_n[1])
        return fresh

    # ------------------------------------------------------------- delivery
    # The three engines differ only in which (receiver, sender) items they
    # evaluate: dense all N² pairs, sparse all N * budget ball slots,
    # compact the tick's due slots. Items come grouped by (member,
    # receiver), in ascending sender order; receivers are numbered over the
    # flattened (B * N) batch (the sharded engine: this rank's m receivers)
    # and senders within their member. ``_reduce`` folds them back the same
    # way for all of them, so the engines agree bit for bit. Each returns
    # (rcv, src, ok, lengths, spans): ``spans[b]`` counts member b's items.
    def _items_dense(self, due, counts):
        bsz, n, _ = due.shape
        ar = torch.arange(bsz * n, device=self.device)
        return (ar.repeat_interleave(n), ar[:n].repeat(bsz * n),
                due.reshape(-1), torch.full_like(ar, n), [n * n] * bsz)

    def _items_sparse(self, due, counts):
        bsz, n, budget = due.shape[0], due.shape[1], self.delivery_budget
        slot_src = self._consts["slot_src"]
        ar = torch.arange(bsz * n, device=self.device)
        return (ar.repeat_interleave(budget), slot_src.reshape(-1),
                torch.gather(due, 2, slot_src).reshape(-1),
                torch.full_like(ar, budget), [n * budget] * bsz)

    def _items_compact(self, due, counts):
        """The due (receiver, slot) pairs of the (B, N, budget) slot-layout
        dueness, gathered into one work buffer of the batch's total count
        without a host sync: due item k goes to buffer slot cumsum - 1
        (ascending, so members and receivers stay grouped and slots stay in
        ascending-src order), the rest to the spare slot, which is
        dropped."""
        budget = due.shape[2]
        count = int(counts.sum())
        flat_ok = due.reshape(-1)
        pos = torch.cumsum(flat_ok, 0) - 1
        buf = torch.empty((count + 1,), dtype=torch.int64, device=self.device)
        buf.scatter_(0, torch.where(flat_ok, pos, count),
                     torch.arange(flat_ok.shape[0], device=self.device))
        flat_idx = buf[:count]
        src = self._consts["slot_src"].reshape(-1)[flat_idx]
        return (flat_idx // budget, src, torch.ones_like(src, dtype=torch.bool),
                due.sum(2).reshape(-1), counts.tolist())

    def _reduce(self, s, counts, pool, row, rcv, src, ok, lengths, spans):
        """Evaluate each item (sender ``src``'s in-flight model, row
        ``row`` of the ``pool`` of sent models, on receiver ``rcv``'s data),
        weight it by Eq. 2, and fold each (member, receiver)'s items into
        the streaming Eq. 3 buffer and the running (min accuracy, lowest-src
        argmin) pair. ``ok`` masks items that are not due; ``lengths``
        counts each receiver's items, ``counts`` each member's due ones.
        Returns the new (B, M, ...) ``acc_sum`` and the (B, M) ``w_sum``,
        batch min and batch sender, M the receivers this process holds."""
        bsz, m = s["w_sum"].shape
        n = self.topology.num_nodes
        count = rcv.shape[0]
        accs = torch.where(ok, self._eval(pool, row, rcv, spans, counts), 0.0)
        w = torch.where(ok, s["rep"].flatten(0, 1)[rcv, src] * accs, 0.0)
        # segment r = receiver r's running sum, then its items: each sum
        # runs carry + x0 + x1 + ... in item order, one rounding an
        # addition, as the JAX compact engine's scatter-add does.
        # segment_reduce sums each element of 2-D data in one sequential
        # loop, on the CPU and on the card
        seg = lengths + 1
        carry_at = torch.cumsum(seg, 0) - seg
        item_at = torch.arange(count, device=self.device) + rcv + 1

        def add(carry, items):
            flat_carry = carry.flatten(0, 1)
            buf = torch.empty((bsz * m + count,) + carry.shape[2:],
                              dtype=carry.dtype, device=self.device)
            buf[carry_at] = flat_carry
            buf[item_at] = items
            return torch.segment_reduce(
                buf.reshape(bsz * m + count, -1), "sum", lengths=seg,
                axis=0).reshape(carry.shape)

        def weighted(p):
            models = p[row].float()
            return _col(w, models) * models

        acc_sum = tree.map(lambda a, p: add(a, weighted(p)), s["acc_sum"],
                           pool)
        masked = torch.where(ok, accs, torch.inf)
        batch_min = torch.full((bsz * m,), torch.inf,
                               device=self.device).scatter_reduce(
            0, rcv, masked, "amin")
        # lowest-src tie-break: among the items at the receiver's min,
        # scatter-min the sender index (n = none)
        tie = ok & (masked == batch_min[rcv])
        batch_sender = torch.full((bsz * m,), n, dtype=torch.int64,
                                  device=self.device).scatter_reduce(
            0, rcv, torch.where(tie, src, n), "amin")
        batch_sender = torch.where(batch_sender == n, 0, batch_sender)
        return (acc_sum, add(s["w_sum"], w), batch_min.reshape(bsz, m),
                batch_sender.reshape(bsz, m))

    def _eval(self, pool, row, rcv, spans, counts):
        """Accuracies of each item's model (``pool[row]``) on its
        receiver's eval data: one stacked call a member with due items, at
        its single run's shape; zeros for the items of a member with none
        (masked out by the caller)."""
        m = self._block[1]
        out, lo = [], 0
        for b, span in enumerate(spans):
            hi = lo + span
            if counts[b]:
                models = tree.map(lambda x: x[row[lo:hi]], pool)
                rows = rcv[lo:hi] - b * m if b else rcv[lo:hi]
                data = tree.map(lambda x: x[rows], self._eval_data)
                out.append(self.scenario.eval_stacked(models, data)
                           .to(torch.float32))
            elif span:
                out.append(torch.zeros((span,), device=self.device))
            lo = hi
        return out[0] if len(out) == 1 else torch.cat(out)

    # -------------------------------------------------------------- training
    def _train_and_send(self, params, sent, trains_np, t):
        """Train the nodes of ``trains_np`` ((B, M) bool over this
        process's receivers), one stacked call a member; commit the honest
        ones' results, run each training attacker's attack on its
        candidate, put every member's payloads through the wire together,
        and write them to ``sent`` (in place). Returns the flattened (B * M)
        rows that trained."""
        dev = self.device
        lo, m = self._block
        rows_np = np.flatnonzero(trains_np)           # b * M + row, ascending
        member_np = rows_np // m
        rows = torch.as_tensor(rows_np, device=dev)
        if not rows_np.size:       # a shard whose nodes do not train
            return rows
        local = rows % m
        flat = tree.map(lambda x: x.flatten(0, 1), params)
        committed = tree.map(lambda x: x[rows], flat)
        bounds = np.searchsorted(member_np, np.arange(len(self._seeds) + 1))
        parts = []
        for b in np.unique(member_np).tolist():
            sel = local[bounds[b]:bounds[b + 1]]
            parts.append(self.scenario.train_stacked(
                tree.map(lambda x: x[b], params),
                attacks_lib.stream_key_at(self._seeds[b], t, _TRAIN_FOLD, dev),
                self._train_data, sel, ids=sel + lo))
        trained = parts[0] if len(parts) == 1 else tree.map(
            lambda *xs: torch.cat(xs), *parts)
        # attackers never COMMIT local training; their honestly trained
        # candidate is still handed to the attack
        honest = np.flatnonzero(
            ~self._malicious[:, lo:lo + m].reshape(-1)[rows_np])
        if honest.size:
            pick = torch.as_tensor(honest, device=dev)
            for p, tr in zip(tree.leaves(flat), tree.leaves(trained)):
                p.index_copy_(0, rows[pick], tr[pick].to(p.dtype))
        outgoing = trained
        for attack, mask, folds in self._attacks:
            pos = np.flatnonzero(mask[:, lo:lo + m].reshape(-1)[rows_np])
            if not pos.size:
                continue
            bad = [attack.apply(
                attacks_lib.attack_key_at(
                    self._seeds[member_np[j]], t, int(folds[member_np[j]]),
                    int(rows_np[j] % m) + lo, dev),
                tree.map(lambda x, j=j: x[j], trained),
                tree.map(lambda x, j=j: x[j], committed), t) for j in pos]
            at = torch.as_tensor(pos, device=dev)
            outgoing = tree.map(
                lambda o, *bd: o.index_copy(0, at, torch.stack(bd).to(o.dtype)),
                outgoing, *bad)
        if self.cfg.compress == "int8":
            # every sender quantizes its (post-attack) broadcast ONCE: one
            # quantize and one dequantize launch for all members' stacked
            # rows, bitwise the per-node round trips (blocks run along the
            # last axis only)
            outgoing = compression.roundtrip_tree(outgoing)
        for s_, o in zip(tree.leaves(sent), tree.leaves(outgoing)):
            s_.flatten(0, 1).index_copy_(0, rows, o)
        return rows

    # -------------------------------------------------------------------- run
    def run(self, params0=None):
        """params0: tree with leading N dim (default: the scenario's
        stacked init), copied onto ``device`` (batched runs start every
        member from it). Returns a ``SimLaxResult``, or for a
        ``BatchedFederationSpec`` a list of B of them, member b bitwise the
        single run of ``specs[b]`` at ``seeds[b]``. Raises ``RuntimeError``
        when a tick's due deliveries exceed the compact engine's bound (the
        sharded engine: a shard's bound, at the end of the run). A sharded
        run is collective: every rank of the group calls it, and each
        returns the whole federation's result."""
        dev = self.device
        if params0 is None:
            params0 = self.scenario.init_params_stacked(dev)
        bsz = len(self._seeds)
        lo, m = self._block
        params = tree.map(lambda x: torch.as_tensor(x)[lo:lo + m].to(dev)
                          .expand((bsz, m) + tuple(x.shape[1:])).clone(),
                          params0)
        with device_lib.deterministic():
            results = self._run(params)
        return results if self._batched else results[0]

    def _overflow(self, t, counts):
        over = np.flatnonzero(counts > self.compact_budget)
        if not self._batched:
            raise RuntimeError(
                f"compact delivery overflow: tick {t} had {int(counts[0])} due "
                f"deliveries but the bound is {self.compact_budget} "
                "(SimLaxConfig.compact_budget override; the exact "
                "topology.compaction_budget bound for this "
                "topology/ttl/interval cannot overflow)")
        raise RuntimeError(
            "compact delivery overflow in batched run: federation "
            f"{[int(b) for b in over]} of the batch (size {self.batch_size}) "
            f"had {[int(counts[b]) for b in over]} due deliveries on tick {t} "
            f"but the shared work buffer holds {self.compact_budget} "
            "(SimLaxConfig.compact_budget override below the batch's max "
            "exact topology.compaction_budget bound)")

    def _run(self, params):
        cfg, rep_impl, c, dev = self.cfg, self.rep_impl, self._consts, self.device
        n = self.topology.num_nodes
        lo, m = self._block
        bsz = len(self._seeds)
        compact = cfg.delivery == "compact"
        sharded = cfg.delivery == "sharded"
        items_of = {"dense": self._items_dense, "sparse": self._items_sparse,
                    "compact": self._items_compact,
                    "sharded": self._items_compact}[cfg.delivery]
        s = {
            "sent": tree.map(torch.zeros_like, params),
            "rep": torch.full((bsz, m, n), rep_impl.initial, device=dev),
            "acc_sum": tree.map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=dev), params),
            "w_sum": torch.zeros((bsz, m), device=dev),
            "buf_cnt": torch.zeros((bsz, m), dtype=torch.int64, device=dev),
        }
        # compact keeps the in-flight state in (N, budget) receiver slots
        # plus a dropped row n for padding scatters, sharded its (m, budget)
        # block of them; the oracles (N, N)
        arrive = torch.full(
            (bsz, n + 1, self.delivery_budget) if compact
            else (bsz, m, self.delivery_budget) if sharded else (bsz, n, n),
            _NEVER, dtype=torch.int32, device=dev)
        live = arrive[:, :m]
        min_acc = torch.full((bsz, m), torch.inf, device=dev)
        min_sender = torch.zeros((bsz, m), dtype=torch.int64, device=dev)
        next_train = self._initial_countdown()
        fedavg_rounds = torch.zeros((bsz,), dtype=torch.int64, device=dev)
        broadcasts = np.zeros((bsz, n), np.int64)
        deliveries = np.zeros((bsz,), np.int64)
        due_ticks = np.zeros((cfg.ticks, bsz), np.int64)
        acc_rows = []
        # the sharded engine's pool of sent models (its own block, then the
        # exchanged ones), exchanged again after every tick on which a node
        # trained; nothing is due before the first one
        pool = None
        trained = False

        for t in range(cfg.ticks):
            # ---- 0. membership: events apply at the TOP of the tick;
            # rejoiners get every peer's reputation COLUMN decayed
            if self._membership:
                a_t = c["alive_t"][:, t]
                if self._rejoin_any[t]:
                    decayed = torch.clamp(
                        s["rep"] * c["rejoin_decay"][:, None, None],
                        rep_impl.floor, rep_impl.initial)
                    s["rep"] = torch.where(c["rejoin_t"][:, t][:, None, :],
                                           decayed, s["rep"])
            else:
                a_t = c["alive"]
            if sharded and trained:
                pool = self._exchange(s["sent"])

            # ---- 1. deliveries due at t; an arrival at an offline
            # receiver expires without delivering
            expired = live == t
            due = expired & a_t[:, lo:lo + m, None]
            counts = due.sum((1, 2)).cpu().numpy()        # host sync 1 of 2
            if counts.any():
                if compact and counts.max() > self.compact_budget:
                    self._overflow(t, counts)
                rcv, src, ok, lengths, spans = items_of(due, counts)
                if sharded:
                    row = c["row_of_src"][src]
                else:
                    # every engine but sharded reads the (B * N) sent rows
                    row = src + rcv // n * n
                    pool = tree.map(lambda x: x.flatten(0, 1), s["sent"])
                acc_sum, w_sum, batch_min, batch_sender = self._reduce(
                    s, counts, pool, row, rcv, src, ok, lengths, spans)
                if not counts.all():
                    # a member with nothing due this tick keeps its buffer
                    # untouched, as its single run does
                    idle = torch.as_tensor(counts == 0, device=dev)
                    acc_sum = tree.map(
                        lambda new, old: torch.where(_col(idle, old), old, new),
                        acc_sum, s["acc_sum"])
                    w_sum = torch.where(idle[:, None], s["w_sum"], w_sum)
                s["acc_sum"], s["w_sum"] = acc_sum, w_sum
                s["buf_cnt"] = s["buf_cnt"] + due.sum(2)
                better = batch_min < min_acc
                min_acc = torch.where(better, batch_min, min_acc)
                min_sender = torch.where(better, batch_sender, min_sender)
            live.masked_fill_(expired, _NEVER)
            deliveries += counts
            due_ticks[t] = counts

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
            worst = min_sender[:, :, None]
            cur = s["rep"].gather(2, worst)[:, :, 0]
            s["rep"].scatter_(2, worst, torch.where(
                hit, torch.clamp(cur - rep_impl.penalty, rep_impl.floor,
                                 rep_impl.initial), cur)[:, :, None])
            keep = (~fire).to(torch.float32)
            s["acc_sum"] = tree.map(lambda a: a * _col(keep, a), s["acc_sum"])
            s["w_sum"] = s["w_sum"] * keep
            s["buf_cnt"] = torch.where(fire, 0, s["buf_cnt"])
            min_acc = torch.where(fire, torch.inf, min_acc)
            min_sender = torch.where(fire, 0, min_sender)
            fedavg_rounds += apply.sum(1)

            # ---- 3. train + broadcast where the countdown expired;
            # offline nodes' countdowns freeze. The countdowns and the set
            # of trainers cover all N nodes on every rank
            if self._membership:
                next_train = next_train - torch.where(
                    c["churn"][:, None], a_t, True).to(torch.int32)
            else:
                next_train = next_train - 1
            trains = (next_train <= 0) & a_t
            trains_np = trains.cpu().numpy()              # host sync 2 of 2
            trained = bool(trains_np.any())
            if trained:
                rows = self._train_and_send(params, s["sent"],
                                            trains_np[:, lo:lo + m], t)
                if compact:
                    b, r = rows // n, rows % n
                    arrive[b[:, None], c["inv_dst"][b, r], c["inv_slot"][b, r]] = \
                        t + c["inv_delay"][b, r]
                elif sharded:
                    # receiver-driven: slot k of a receiver is due delay
                    # ticks after its k-th in-ball sender trains
                    sched = trains[0][c["slot_src"]] & c["slot_valid"]
                    live.copy_(torch.where(sched, t + c["slot_delay"], live))
                else:
                    sched = trains[:, None, :] & c["reach"]
                    live.copy_(torch.where(sched, t + c["delay"], live))
                fresh = self._fresh_intervals(
                    t, np.flatnonzero(trains_np.any(axis=1)))
                next_train = torch.where(trains, fresh * c["straggler"],
                                         next_train)
                broadcasts += trains_np
            # the global test eval runs on record ticks only, one call a
            # member
            if t % cfg.record_every == 0:
                acc_rows.append(torch.stack([
                    self.scenario.test_stacked(tree.map(lambda x: x[b], params))
                    .to(torch.float32) for b in range(bsz)]))

        final = dict(params=params, sent=s["sent"], rep=s["rep"],
                     arrive=live, w_sum=s["w_sum"], buf_cnt=s["buf_cnt"],
                     min_acc=min_acc, min_sender=min_sender)
        final = {k: tree.map(lambda x: x.cpu(), v) for k, v in final.items()}
        final["next_train"] = next_train.cpu()
        final["fedavg_rounds"] = fedavg_rounds.cpu()
        acc = (torch.stack(acc_rows, 1).cpu() if acc_rows
               else torch.zeros((bsz, 0, m)))
        extra = {}
        if sharded:
            final, acc, deliveries, due_ticks, extra = self._gather(
                final, acc, deliveries, due_ticks)
        acc = acc.numpy()
        max_due = due_ticks.max(0) if cfg.ticks else np.zeros((bsz,), np.int64)
        return [self._package(b, tree.map(lambda x: x[b], final),
                              dict(broadcasts=broadcasts[b],
                                   deliveries=int(deliveries[b]),
                                   max_due=int(max_due[b])), acc[b], extra)
                for b in range(bsz)]

    def _exchange(self, sent):
        """The sharded engine's pool of sent models: this rank's block,
        then the block of each shard offset, received through
        ``tree_ppermute`` (every rank issues the same exchanges)."""
        own = tree.map(lambda x: x[0], sent)
        blocks = [own] + [gossip.tree_ppermute(own, self._group, perm)
                          for perm in self._exchange_perms]
        if len(blocks) == 1:
            return own
        return tree.map(lambda *xs: torch.cat(xs), *blocks)

    def _gather(self, final, acc, deliveries, due_ticks):
        """Every rank's blocks joined in rank order, on every rank: the full
        final state and accuracy records, the summed counters, and the
        per-tick due counts summed over the shards. Raises on every rank
        when a shard's tick went over its work-buffer bound."""
        local = (final, acc, deliveries, due_ticks)
        parts = [local]
        if self.shards > 1:
            parts = [None] * self.shards
            dist.all_gather_object(parts, local, group=self._group)
        shard_max = [int(p[3].max()) if p[3].size else 0 for p in parts]
        over = [q for q, d in enumerate(shard_max) if d > self.shard_budget]
        if over:
            raise RuntimeError(
                f"sharded delivery overflow: shard {over} had "
                f"{[shard_max[q] for q in over]} due deliveries on one tick "
                f"but the per-shard work buffer holds {self.shard_budget} "
                "(SimLaxConfig.compact_budget override; the exact per-shard "
                "topology.compaction_budget bound cannot overflow)")
        blocks = [p[0] for p in parts]
        joined = {k: tree.map(lambda *xs: torch.cat(xs, 1),
                              *[f[k] for f in blocks])
                  for k in ("params", "sent", "rep", "arrive", "w_sum",
                            "buf_cnt", "min_acc", "min_sender")}
        joined["next_train"] = final["next_train"]      # the same everywhere
        joined["fedavg_rounds"] = sum(f["fedavg_rounds"] for f in blocks)
        extra = {"shards": self.shards, "shard_budget": self.shard_budget,
                 "max_shard_deliveries": max(shard_max)}
        return (joined, torch.cat([p[1] for p in parts], 2),
                sum(p[2] for p in parts), sum(p[3] for p in parts), extra)

    def _package(self, b, final, counters, acc_history, extra):
        """Host-side result assembly for member ``b``: expand the compact
        slot state back to the (N, N) oracle layout and fold the counters
        into the stats."""
        cfg = self.cfg
        n = self.topology.num_nodes
        final_arrive = final["arrive"].numpy()
        if cfg.delivery in ("compact", "sharded"):
            dense = np.full((n, n), _NEVER, np.int32)
            dense[np.arange(n)[:, None], self._slot_src_np[b]] = final_arrive
            final_arrive = dense
        # one broadcast's bytes under the configured compression; each
        # delivery moves one copy
        broadcast_bytes = compression.payload_bytes(
            tree.map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype,
                                           device="meta"), final["sent"]),
            cfg.compress)
        deliveries = counters["deliveries"]
        if self._batched:
            extra = {"federation_index": b, "batch_size": self.batch_size,
                     "seed": int(self._seeds[b])}
        as_np = {k: final[k].numpy() for k in ("w_sum", "min_acc")}
        as_np.update({k: final[k].numpy().astype(np.int32)
                      for k in ("buf_cnt", "min_sender", "next_train")})
        return SimLaxResult(
            params=convert.params_to_numpy(final["params"]),
            reputation=final["rep"].numpy(),
            acc_history=acc_history,
            record_ticks=np.arange(0, cfg.ticks, cfg.record_every),
            stats={
                "broadcasts": int(counters["broadcasts"].sum()),
                "broadcasts_per_node": counters["broadcasts"].astype(np.int32),
                "deliveries": deliveries,
                "fedavg_rounds": int(final["fedavg_rounds"]),
                "delivery": cfg.delivery,
                "delivery_budget": self.delivery_budget,
                "compact_budget": self.compact_budget,
                "max_tick_deliveries": counters["max_due"],
                "compress": cfg.compress,
                "broadcast_bytes": broadcast_bytes,
                "wire_bytes": broadcast_bytes * deliveries,
                **extra,
            },
            final_state={"arrive": final_arrive, **as_np},
            sent=convert.params_to_numpy(final["sent"]),
        )
