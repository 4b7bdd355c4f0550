"""Partial consensus over ``torch.distributed``: ttl-bounded gossip (paper
§III-B) over an arbitrary static topology, one federation node a rank.

Port of the JAX package's ``repro.core.gossip``. There the round is one
jitted program over a device mesh; here each rank runs the round for its
own node, and every ``jax.lax.ppermute`` of the schedule becomes one
``tree_ppermute``: the payload tree packed into one byte buffer and moved
by ``dist.batch_isend_irecv``. The schedule is
``topology.gossip_schedule`` (the exact per-hop frontier lowering by
default; ``schedule="chain"`` keeps the legacy under-covering oracle)::

    for each step (perm, parent):
        payload <- tree_ppermute(parent step's payload or my own, perm)
        s = senders[step, me]     # -1: broken chain or duplicate delivery
        acc_s = eval(payload, my validation batch)        # the receipt
        w_s   = reputation_row[s] * acc_s                 # Eq. 2
        accumulate w_s * payload                          # streaming Eq. 3
    new_model = (sum w m / sum w + my_model) / 2              # Eq. 3
    reputation_row <- punish lowest-accuracy sender           # impl1/impl2

With ``compress="int8"`` the int8 payload and its bf16 scales cross the
transport: the sender quantizes once (the quantize kernel on CUDA),
intermediate hops forward what they received, and each receiver
dequantizes (the dequantize kernel) before its receipt. A masked step (the
schedule's -1) is neither dequantized nor evaluated: its weight is zero in
the JAX round, so it contributes nothing there either.

Transport: under NCCL the buffers move on the card, and a group's first
exchange opens with a collective that every rank joins (NCCL leaves a first
batched P2P call that skips ranks undefined). Gloo moves host memory only,
so a CUDA payload is staged through the host there; the compute stays on
the card. ``WIRE`` counts, per process, the bytes and messages sent and
the seconds spent in ``tree_ppermute`` (packing, staging and waiting).

The dry-run cell report traces one node's round on the meta device over a
``launch.mesh.AbstractMesh`` (no process group): there each exchange
returns empty meta tensors of the received shapes and records its payload
bytes with ``kernels.report_collective`` ("collective-permute"),
and nothing moves or is counted in ``WIRE``.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import kernels, tree
from repro_torch.core import compression, fedavg
from repro_torch.core import topology as topology_lib
from repro_torch.core.reputation import ReputationImpl
from repro_torch.launch import mesh as mesh_lib

WIRE: collections.Counter = collections.Counter()
# NCCL groups that have had their first collective (see tree_ppermute)
_NCCL_OPENED: set = set()


def reset_wire() -> None:
    WIRE.clear()


def tree_ppermute(tree_, group, perm):
    """``jax.lax.ppermute`` of a tree over ``group``: rank ``src`` of each
    ``(src, dst)`` pair in ``perm`` sends its tree to rank ``dst``; a rank
    that no pair sends to gets zeros. Every rank of the group calls it with
    the same ``perm`` and a tree of the same structure, shapes and dtypes.
    ``group=None`` is the default group.

    The leaves travel as one byte buffer, widest dtype first (so each
    leaf's offset is aligned for its dtype): one message a step. A meta
    tree (the dry-run cell report) moves nothing: see the module doc."""
    leaves = tree.leaves(tree_)
    if leaves and leaves[0].is_meta:
        kernels.report_collective(
            "collective-permute", sum(x.numel() * x.element_size() for x in leaves))
        return tree.map(torch.empty_like, tree_)
    group = dist.group.WORLD if group is None else group
    me = dist.get_rank(group)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"perm {perm} is not a permutation")
    order = sorted(range(len(leaves)), key=lambda i: -leaves[i].element_size())
    sizes = [leaves[i].numel() * leaves[i].element_size() for i in order]
    dev = leaves[0].device
    backend = dist.get_backend(group)
    if backend == "nccl" and group not in _NCCL_OPENED:
        # NCCL leaves a group's first batched P2P call undefined unless
        # every rank joins it, and a perm may leave ranks out: open the
        # group with a collective (every rank of the group calls here)
        dist.all_reduce(torch.zeros(1, device=dev), group=group)
        _NCCL_OPENED.add(group)
    staged = dev.type == "cuda" and backend == "gloo"
    if staged:     # WIRE's clock leaves out the card's queued work
        torch.cuda.current_stream(dev).synchronize()
    t0 = time.perf_counter()
    ops = []
    if dsts:
        send = torch.cat([leaves[i].reshape(-1).view(torch.uint8)
                          for i in order])
        if staged:
            send = send.cpu()
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, dsts[0]), group))
        WIRE["bytes"] += send.numel()
        WIRE["messages"] += 1
    recv = torch.zeros(sum(sizes), dtype=torch.uint8,
                       device="cpu" if staged else dev)
    if srcs:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, srcs[0]), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        recv = recv.to(dev)
    out, off = [None] * len(leaves), 0
    for i, size in zip(order, sizes):
        out[i] = recv[off:off + size].view(leaves[i].dtype).reshape(
            leaves[i].shape)
        off += size
    WIRE["seconds"] += time.perf_counter() - t0
    return tree.unflatten(tree_, out)


def ring_perms(n: int):
    """The seed's hard-wired bidirectional ring (``topology.ring(n)
    .perm_schedule()`` gives these two perms)."""
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return fwd, bwd


def make_gossip_round(
    eval_fn: Callable,
    *,
    fed_size: int,
    ttl: int,
    rep_impl: ReputationImpl,
    compress: Optional[str] = None,
    mesh=None,
    topology: Optional[topology_lib.Topology] = None,
    schedule: str = "frontier",
):
    """Build the gossip round that each rank of the federation group runs
    for its own node.

    ``eval_fn(params, val_batch) -> accuracy`` in [0, 1] (a 0-d tensor),
    evaluated by the RECEIVER on its own validation batch (the receipt).
    ``mesh``: a ``launch.mesh.make_fed_mesh`` mesh, whose federation dim's
    group carries the round, or the federation's process group itself
    (default: the default process group; with no group up, ``fed_size``
    must be 1). A ``launch.mesh.AbstractMesh`` runs node 0's round with no
    group, for a meta trace (the dry-run cell report). ``topology`` is any
    ``topology.Topology`` over ``fed_size`` nodes (default: the
    bidirectional ring); the round sends ``gossip_schedule(topology, ttl)
    .num_collectives`` messages a rank at most.

    The returned ``gossip_round(params, rep_row, val_batch)`` takes this
    rank's node: its params tree, its (F,) reputation row (its opinion of
    every sender) and its validation batch, and returns ``(new_params,
    new_rep_row, metrics)``.
    """
    if ttl < 1:
        raise ValueError("ttl must be >= 1")
    if compress not in (None, "int8"):
        raise ValueError(f"unknown compress mode: {compress!r}")
    if topology is None:
        topology = topology_lib.ring(fed_size)
    if topology.num_nodes != fed_size:
        raise ValueError(
            f"topology has {topology.num_nodes} nodes, fed_size={fed_size}")
    sched = topology_lib.gossip_schedule(topology, ttl, schedule=schedule)
    senders = sched.senders
    # the last step that forwards each step's payload: a payload is dropped
    # after it (at LM size each one is the size of the model)
    last_use = list(range(len(sched.steps)))
    own_last = -1          # the last step that sends this node's own payload
    for t, (_, parent) in enumerate(sched.steps):
        if parent >= 0:
            last_use[parent] = t
        else:
            own_last = t
    # punish-the-worst needs competition: a node with a single distinct
    # sender (degree-1 topologies) would otherwise zero its only neighbour's
    # reputation and freeze itself out of averaging
    distinct = [len({int(s) for s in senders[:, i] if s >= 0}) > 1
                for i in range(fed_size)]

    def gossip_round(params, rep_row, val_batch):
        if isinstance(mesh, mesh_lib.AbstractMesh):
            group, size = None, fed_size
        else:
            group = mesh_lib.fed_group(mesh)
            size = dist.get_world_size(group) if group is not None else 1
        if size != fed_size:
            raise ValueError(
                f"the federation group has {size} ranks, fed_size={fed_size}")
        me = dist.get_rank(group) if group is not None else 0
        if compress == "int8":
            payload0, spec = compression.quantize_tree(params)
        else:
            payload0, spec = params, None
        acc_state = fedavg.streaming_init(params)
        zero = torch.zeros((), device=rep_row.device)
        sender_ids, accs, valids = [], [], []
        payloads = []    # payload after each step, for forwarding chains
        for s, (perm, parent) in enumerate(sched.steps):
            src = payload0 if parent < 0 else payloads[parent]
            payload = tree_ppermute(src, group, list(perm))
            payloads.append(payload)
            del src
            sender = int(senders[s, me])
            valid = sender >= 0
            acc = zero
            if valid:
                model = (compression.dequantize_tree(payload, spec)
                         if compress == "int8" else payload)
                acc = torch.as_tensor(eval_fn(model, val_batch),
                                      device=zero.device).to(torch.float32)
                w = fedavg.model_weights(rep_row[sender], acc)      # Eq. 2
                acc_state = fedavg.streaming_add(acc_state, model, w)
            sender_ids.append(max(sender, 0))
            accs.append(acc)
            valids.append(valid)
            model = payload = None
            if s == own_last:
                payload0 = None
            for p in range(s + 1):
                if last_use[p] <= s:
                    payloads[p] = None
        new_params = fedavg.streaming_finish(acc_state, params)    # Eq. 3
        valid_vec = torch.tensor(valids, dtype=torch.bool, device=zero.device)
        acc_vec = torch.stack(accs + [zero])[:len(accs)]
        # invalid receipts: acc pinned above 1.0 so they are never "worst",
        # and their (clamped-to-0) sender id is never punished
        new_rep = rep_row
        if distinct[me]:
            new_rep = rep_impl.update_row(
                rep_row, torch.tensor(sender_ids, device=zero.device),
                torch.where(valid_vec, acc_vec, 2.0))
        received = valid_vec.sum().to(torch.float32)
        inf = torch.full((1,), torch.inf, device=zero.device)
        metrics = {
            "mean_neighbor_acc": torch.where(valid_vec, acc_vec, 0.0).sum()
            / torch.clamp_min(received, 1.0),
            "min_neighbor_acc": torch.cat(
                [torch.where(valid_vec, acc_vec, torch.inf), inf]).min(),
            "rep_min": new_rep.min(),
            "models_received": received,
        }
        return new_params, new_rep, metrics

    return gossip_round


def make_local_steps(train_step_fn, *, num_steps: int = 1):
    """H local optimizer steps for this rank's node, no collective (the
    paper's asynchronous local training between broadcasts).

    ``local_steps(state, batches)``: ``batches`` leaves are (H, ...), H
    microbatches of this node; step h runs ``train_step_fn(state,
    batches[h]) -> (state, metrics)``. Returns the final state and the last
    step's metrics. H is the batches' leading axis, as the JAX package's
    scan takes it; ``num_steps`` is that package's argument, which its scan
    never reads, kept for the same call sites.
    """
    del num_steps

    def local_steps(state, batches):
        metrics = None
        for h in range(tree.leaves(batches)[0].shape[0]):
            state, metrics = train_step_fn(
                state, tree.map(lambda x, h=h: x[h], batches))
        return state, metrics

    return local_steps
