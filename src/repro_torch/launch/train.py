"""End-to-end training launcher (an example application and the production
entry point), the JAX package's ``repro.launch.train``.

Two modes:
  * plain training of a zoo arch on the synthetic pipeline;
  * ``--dfl``: DFL federated training — F nodes, H local steps per round,
    ttl-bounded reputation-weighted gossip, an elastic ring on a simulated
    node failure, digest-chained checkpoints.

A federation node is a process: ``--dfl`` starts ``--fed`` ranks with
``launch.mesh.spawn`` (the JAX launcher's ``--host-devices``), one node a
rank, each holding its whole replica. ``--device`` defaults to ``cuda`` and
raises without it; ``--device cpu`` runs on the CPU. ``--backend`` defaults
to NCCL when each rank has a card of its own and to gloo otherwise (the
CPU, or several ranks on one card).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \
      --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \
      --dfl --fed 4 --rounds 10 --local-steps 2 --ttl 1 --fail-node 2@5 \
      --ckpt-dir /tmp/dflckpt --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch import device as device_lib
from repro_torch import tree
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import dfl as dfl_lib
from repro_torch.core import gossip as gossip_lib
from repro_torch.core import reputation as rep_lib
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import step as step_lib
from repro_torch.train.fault import FedRing, elastic_gossip_builder


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: raises without a GPU), cuda:i or cpu")
    ap.add_argument("--backend", default=None, choices=(None, "gloo", "nccl"),
                    help="--dfl process group backend")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="--dfl: seconds before every rank is killed")
    # DFL federation
    ap.add_argument("--dfl", action="store_true")
    ap.add_argument("--fed", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--ttl", type=int, default=1)
    ap.add_argument("--reputation", default="impl2")
    ap.add_argument("--compress", default=None, choices=(None, "int8"))
    ap.add_argument("--fail-node", default=None,
                    help="simulate failure: '<replica>@<round>'")
    return ap.parse_args(argv)


def _batch(np_batch, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in np_batch.items()}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_plain(args, cfg, dev):
    """Train one model. Returns (state, history): the final state and one
    record a step (step, loss, accuracy, grad_norm, seconds)."""
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq)
    g = torch.Generator(device=dev).manual_seed(0)
    state = step_lib.init_train_state(cfg, g, device=dev)
    start = 0
    if args.resume and args.ckpt_dir:
        state, start = ckpt_lib.restore(args.ckpt_dir, state)
        print(f"[train] resumed from step {start} "
              f"(chain ok: {ckpt_lib.verify_chain(args.ckpt_dir)})", flush=True)
    ts = step_lib.make_train_step(cfg)
    history = []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        state, metrics = ts(state, _batch(pipe.batch_at(step), dev))
        history.append(dict(step=step, **{k: float(v) for k, v in metrics.items()},
                            seconds=time.perf_counter() - t0))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"[train] step {step} loss {history[-1]['loss']:.4f} "
                  f"acc {history[-1]['accuracy']:.3f}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt_dir, state, step + 1, arch=cfg.name)
    return state, history


def _node_batches(pipe, step, local_steps, node, dev):
    """Node ``node``'s (H, B, S) batches of round ``step``:
    ``pipe.fed_batches(step, local_steps)[node]``, drawn for this node only."""
    bs = [pipe.batch_at(step * local_steps + h, node=node)
          for h in range(local_steps)]
    return {k: torch.stack([torch.as_tensor(b[k]) for b in bs]).to(dev)
            for k in bs[0]}


def _to_cpu(state):
    return tree.map(lambda x: x.detach().cpu(), state)


def _dfl_rank(rank, dev, args, cfg):
    """One federation node; ``spawn``'s target. Returns, on the first
    survivor, every survivor's summary (``_summary``), and on the others
    their own."""
    fed = args.fed
    rep_impl = rep_lib.get(args.reputation)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, fed_nodes=fed)
    g = torch.Generator(device=dev).manual_seed(rank)
    state, rep_row = dfl_lib.init_federation(cfg, fed, g, device=dev)
    ring = FedRing(list(range(fed)))
    group = dist.group.WORLD
    fail_at = None
    if args.fail_node:
        rep, rnd = args.fail_node.split("@")
        fail_at = (int(rep), int(rnd))

    local = gossip_lib.make_local_steps(step_lib.make_train_step(cfg))

    def build_round(f):
        return gossip_lib.make_gossip_round(
            dfl_lib.make_lm_eval_fn(cfg), fed_size=f,
            ttl=min(args.ttl, max(1, (f - 1) // 2)), rep_impl=rep_impl,
            compress=args.compress, mesh=group)

    get_round = elastic_gossip_builder(build_round)
    records = []

    for rnd in range(args.rounds):
        if fail_at and rnd == fail_at[1] and fail_at[0] in ring.members:
            if rank == ring.members[0]:
                print(f"[dfl] replica {fail_at[0]} FAILED at round {rnd}; "
                      f"ring renumbers {ring.size} -> {ring.size - 1}", flush=True)
            survivors = [r for r in ring.members if r != fail_at[0]]
            new_group = dist.new_group(survivors)   # collective: every rank
            if rank == fail_at[0]:
                return _summary(rank, dev, records)
            # survivors keep their params and optimizer state untouched, and
            # drop the failed node's column from their reputation rows
            rep_row = rep_row[[ring.dense_rank(r) for r in survivors]]
            ring.fail(fail_at[0])
            group = new_group
        f = ring.size
        me = ring.dense_rank(rank)
        gossip_round = get_round(f)
        t0 = time.perf_counter()
        state, metrics = local(state, _node_batches(pipe, rnd, args.local_steps,
                                                    me, dev))
        val = pipe.batch_at(10_000 + rnd, node=me)
        vb = {k: torch.as_tensor(v[: max(2, args.batch // 2)], device=dev)
              for k, v in val.items()}
        _sync(dev)
        t1 = time.perf_counter()
        new_params, rep_row, gm = gossip_round(state["params"], rep_row, vb)
        state = dict(state, params=new_params)
        _sync(dev)
        records.append(dict(round=rnd, F=f, loss=float(metrics["loss"]),
                            neighbor_acc=float(gm["mean_neighbor_acc"]),
                            rep_min=float(gm["rep_min"]),
                            received=float(gm["models_received"]),
                            local_s=t1 - t0, round_s=time.perf_counter() - t1))
        rows = [None] * f
        dist.all_gather_object(rows, records[-1], group=group)
        if me == 0:
            print(f"[dfl] round {rnd} F={f} "
                  f"loss={sum(r['loss'] for r in rows) / f:.4f} "
                  f"neighbor_acc={sum(r['neighbor_acc'] for r in rows) / f:.3f} "
                  f"rep_min={min(r['rep_min'] for r in rows):.2f}", flush=True)
        if args.ckpt_dir and (rnd + 1) % args.ckpt_every == 0:
            # the nodes' states stacked (F, ...) on the first survivor, as
            # the JAX federation state holds them
            states = [None] * f if me == 0 else None
            dist.gather_object(_to_cpu(state), states, dst=ring.members[0],
                               group=group)
            if me == 0:
                fed_state = tree.map(lambda *xs: torch.stack(xs), *states)
                ckpt_lib.save(args.ckpt_dir, fed_state, rnd + 1, arch=cfg.name,
                              extra={"mode": "dfl", "fed": f})
    summaries = [None] * ring.size
    dist.all_gather_object(summaries, _summary(rank, dev, records), group=group)
    return summaries if ring.dense_rank(rank) == 0 else summaries[ring.dense_rank(rank)]


def _summary(rank, dev, records):
    """What a rank reports: its rounds, its kernel launches and wire
    counters (``gossip.WIRE``) over the run, and its peak device memory."""
    return {"rank": rank, "rounds": records, "launches": dict(LAUNCHES),
            "wire": dict(gossip_lib.WIRE),
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}


def run_dfl(args, cfg, dev):
    """Train the federation, one node a rank. Returns the survivors'
    summaries (rank, rounds, launches, wire counters, peak memory) from
    rank 0, or rank 0's own when it is the node that fails."""
    backend = args.backend
    if backend is None:
        own_cards = (dev.type == "cuda" and dev.index is None
                     and args.fed <= torch.cuda.device_count())
        backend = "nccl" if own_cards else "gloo"
    return mesh_lib.spawn(_dfl_rank, args.fed, device=str(dev), backend=backend,
                          timeout=args.timeout, args=(args, cfg))


def main(argv=None):
    args = parse_args(argv)
    dev = device_lib.resolve(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[train] arch={cfg.name} smoke={args.smoke} dfl={args.dfl} "
          f"device={dev}", flush=True)
    out = run_dfl(args, cfg, dev) if args.dfl else run_plain(args, cfg, dev)
    if args.ckpt_dir:
        print(f"[train] checkpoint chain ok: {ckpt_lib.verify_chain(args.ckpt_dir)}",
              flush=True)
    return out


if __name__ == "__main__":
    main()
