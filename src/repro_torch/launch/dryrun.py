"""The dry-run command line's federation runs: one federation, or a batched
grid of them, through the vectorized engine.

Port of the JAX package's ``repro.launch.dryrun`` entry points that run a
federation, with every option of its command line under the same name,
default, choices and meaning:

  * ``--engine lax``: one federation (a registered scenario under a
    registered attack) through ``chain.simlax.LaxSimulator``: the quick
    sanity pass for the §VI-D dynamics at a chosen scale, topology and
    adversary. ``--delivery sharded`` partitions the node axis over ranks:
    ``--mesh S`` (S > 1) starts S processes with ``launch.mesh.spawn``
    (the JAX package's forced host devices), ``--mesh 0`` takes one shard
    a visible CUDA device (one shard, in process, on the CPU);
  * ``--sweep``: an attack x topology-seed x size x seed grid, one batched
    run a shape-compatible batch (``chain.sweeps``), with its frontier
    tables.

Each run appends one JSON record to ``--out``, with the keys of the JAX
package's record and the device it ran on.

The JAX default, ``--engine mesh`` (with ``--arch``, ``--shape``, ``--all``,
``--multi-pod``, ``--dfl``, ``--gossip-schedule`` and ``--print-hlo``),
lowers and compiles XLA programs and reports their cost analysis. The
eager port has nothing to lower: that report is another slice
(``CELL_REPORT_ITEM``), and until then these options raise
``NotImplementedError``.

``--device`` defaults to ``cuda`` and raises without it; ``--device cpu``
runs on the CPU.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --engine lax \\
        --scenario lenet --attack signflip --nodes 16 --ticks 48 \\
        --topology kregular --ttl 2 --compress int8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --engine lax \\
        --nodes 64 --delivery sharded --mesh 2 --device cpu \\
        --churn 10:leave:3+5 --churn 20:join:3
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch import device as device_lib
from repro_torch.chain import attacks, scenarios, simlax, sweeps
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.core import topology as topology_lib
from repro_torch.core.reputation import get as get_rep
from repro_torch.launch import mesh as mesh_lib

CELL_REPORT_ITEM = "ROADMAP.md queue 1, item 13c, 'the dry-run cell report'"
# seconds before every rank of a --delivery sharded run is killed
SPAWN_TIMEOUT_S = 1800.0
# the --engine mesh options: (attribute, option) of the XLA cell report
_CELL_OPTIONS = (("arch", "--arch"), ("shape", "--shape"), ("all", "--all"),
                 ("multi_pod", "--multi-pod"), ("dfl", "--dfl"),
                 ("print_hlo", "--print-hlo"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dfl", action="store_true",
                    help="lower the DFL gossip round instead of the plain step "
                    f"(not ported: {CELL_REPORT_ITEM})")
    ap.add_argument("--engine", default="mesh", choices=("mesh", "lax"),
                    help="mesh: the XLA cell report (default; not ported: "
                    f"{CELL_REPORT_ITEM}); lax: run the vectorized tick "
                    "simulator end-to-end")
    ap.add_argument("--scenario", default=None, choices=scenarios.names(),
                    help="registered federation scenario for --engine lax")
    ap.add_argument("--model", default="toy", choices=scenarios.names(),
                    help="deprecated alias for --scenario")
    ap.add_argument("--attack", default="gaussian", choices=attacks.names(),
                    help="registered attack for the poisoned senders "
                    "(--engine lax)")
    ap.add_argument("--attack-arg", action="append", default=[],
                    metavar="K=V",
                    help="attack parameter override, repeatable "
                    "(e.g. --attack gaussian --attack-arg sigma=3.0)")
    ap.add_argument("--nodes", type=int, default=64,
                    help="federation size for --engine lax")
    ap.add_argument("--ticks", type=int, default=48,
                    help="simulated ticks for --engine lax")
    ap.add_argument("--delivery", default="compact",
                    choices=simlax.DELIVERY_ENGINES,
                    help="receipt engine for --engine lax: compact "
                    "(segment-compacted work buffer, default), sparse "
                    "(per-receiver slot buffer), dense (N^2 oracle), "
                    "sharded (the node axis partitioned over ranks)")
    ap.add_argument("--mesh", type=int, default=0, metavar="SHARDS",
                    help="--delivery sharded: partition the node axis over "
                    "this many ranks, started on --device (0 = one shard per "
                    "visible CUDA device, one on the CPU; num nodes must "
                    "divide evenly)")
    ap.add_argument("--churn", action="append", default=[],
                    metavar="TICK:OP:IDS",
                    help="membership event for --engine lax, repeatable: "
                    "OP is join|leave, IDS is '+'-separated node ids "
                    "(e.g. --churn 10:leave:3+5 --churn 20:join:3); "
                    "entries sharing a tick merge into one event. Rejoins "
                    "resume from committed params with reputation decayed")
    ap.add_argument("--churn-offline", default="", metavar="ID+ID...",
                    help="node ids offline from tick 0 (their first join "
                    "is not a rejoin: no reputation decay)")
    ap.add_argument("--churn-decay", type=float, default=0.5,
                    help="rejoin reputation decay factor in [0, 1] "
                    "(rep <- clip(decay * rep, floor, initial))")
    ap.add_argument("--compress", default=None,
                    type=lambda s: None if s in ("none", "") else s,
                    choices=simlax.COMPRESS_MODES, metavar="{none,int8}",
                    help="wire payload quantization for broadcasts "
                    "(--engine lax): int8 ships block-quantized models "
                    "(repro_torch.core.compression), none ships fp32 "
                    "(default)")
    ap.add_argument("--topology", default="ring", choices=topology_lib.KINDS,
                    help="gossip graph over the federation (--engine lax)")
    ap.add_argument("--topology-degree", type=int, default=2,
                    help="kregular/smallworld neighbor offsets per side")
    ap.add_argument("--ttl", type=int, default=1,
                    help="gossip flood radius in hops (--engine lax)")
    ap.add_argument("--gossip-schedule", default="frontier",
                    choices=topology_lib.SCHEDULES,
                    help="--dfl lowering: frontier (exact ttl-ball, default)"
                    " or chain (legacy under-covering oracle)")
    ap.add_argument("--sweep", action="store_true",
                    help="run a batched federation sweep "
                    "(repro_torch.chain.sweeps) instead of a single lax run")
    ap.add_argument("--sweep-sizes", default="16,64", metavar="N,N,...",
                    help="--sweep: comma-separated federation sizes")
    ap.add_argument("--sweep-attacks", default="none,gaussian,signflip",
                    metavar="A,A,...",
                    help="--sweep: comma-separated attack registry names "
                    "('none' = honest baseline)")
    ap.add_argument("--sweep-topology-seeds", default="0", metavar="S,S,...",
                    help="--sweep: topology generator seeds (erdos/smallworld"
                    " resampling; kregular/ring ignore the seed)")
    ap.add_argument("--sweep-seeds", default="0,1", metavar="S,S,...",
                    help="--sweep: engine PRNG seeds per cell")
    ap.add_argument("--target-acc", type=float, default=0.5,
                    help="--sweep: accuracy target for time-to-accuracy")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="--sweep: cap federations per batched dispatch "
                    "(0 = unlimited)")
    ap.add_argument("--out", default="experiments/dryrun.json")
    ap.add_argument("--print-hlo", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: raises without a GPU), cuda:i or cpu")
    return ap


def _parse_attack_args(pairs):
    """--attack-arg k=v pairs -> {k: int|float|str} for attacks.make."""
    out = {}
    for pair in pairs or ():
        if "=" not in pair:
            raise SystemExit(f"--attack-arg expects k=v, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def _parse_churn(args):
    """--churn TICK:OP:IDS entries (+ --churn-offline / --churn-decay) ->
    MembershipSchedule, or None when no churn was requested. Entries
    sharing a tick are merged into one event (the schedule's invariant)."""
    if not args.churn and not args.churn_offline:
        return None
    by_tick = {}
    for raw in args.churn:
        parts = raw.split(":")
        if len(parts) != 3 or parts[1] not in ("join", "leave"):
            raise SystemExit(
                f"--churn expects TICK:join|leave:ID+ID..., got {raw!r}")
        try:
            tick = int(parts[0])
            ids = tuple(int(i) for i in parts[2].split("+") if i)
        except ValueError:
            raise SystemExit(
                f"--churn expects integer tick/ids, got {raw!r}")
        joins, leaves = by_tick.setdefault(tick, (set(), set()))
        (joins if parts[1] == "join" else leaves).update(ids)
    offline = tuple(int(i) for i in args.churn_offline.split("+") if i)
    return attacks.MembershipSchedule.build(
        [(t, tuple(sorted(j)), tuple(sorted(lv)))
         for t, (j, lv) in sorted(by_tick.items())],
        rejoin_decay=args.churn_decay, initial_offline=offline)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _append(out, record):
    """Append ``record`` to the JSON list in ``out`` (made if missing)."""
    results = []
    if os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    results.append(record)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1, default=str)


def _lax_setup(args, shards):
    """The --engine lax federation: (scenario, spec, topology, config,
    malicious ids, attack, membership schedule), with the JAX CLI's
    constants."""
    n = args.nodes
    scenario_name = args.scenario or args.model
    mal = tuple(range(max(1, n // 10)))   # 10% attackers
    builder = scenarios.get(scenario_name)
    if scenario_name == "lenet":
        # the paper recipe's data/optimizer constants, at a CLI-friendly 4
        # steps per training action
        sc = builder(n, malicious=mal, train_steps=4, **scenarios.LENET_PAPER_HP)
        interval = (6, 6)
    else:
        sc = builder(n, dim=16, malicious=mal)
        interval = (8, 16)
    attack = attacks.make(args.attack, **_parse_attack_args(args.attack_arg))
    membership = _parse_churn(args)
    spec = attacks.FederationSpec.build(
        n, malicious=mal, attack=attack,
        initial_countdown=[1 + (5 * i) % interval[0] for i in range(n)],
        membership=membership)
    topo = topology_lib.make(args.topology, n, degree=args.topology_degree,
                             seed=1)
    cfg = simlax.SimLaxConfig(
        ticks=args.ticks, train_interval=interval, latency=1,
        ttl=max(1, args.ttl), record_every=max(1, args.ticks // 8), seed=0,
        delivery=args.delivery, compress=args.compress, shards=shards)
    return sc, spec, topo, cfg, mal, attack, membership


def _lax_run(args, dev, shards):
    """Build and run the --engine lax federation on ``dev``: (result, run
    seconds, malicious ids, attack, membership). Every rank of a sharded
    run calls it."""
    sc, spec, topo, cfg, mal, attack, membership = _lax_setup(args, shards)
    sim = simlax.LaxSimulator(sc, topo, spec, get_rep("impl2"), cfg, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    res = sim.run()
    _sync(dev)
    return res, time.perf_counter() - t0, mal, attack, membership


def _lax_rank(rank, dev, args, shards):
    """One rank of a --delivery sharded run; ``spawn``'s target. Rank 0
    returns the run (its result is the whole federation's)."""
    out = _lax_run(args, dev, shards)
    return out if rank == 0 else None


def _shards(args, dev):
    """The shard count of --delivery sharded: --mesh, else one a visible
    CUDA device (one on the CPU), capped at the node count."""
    if args.mesh:
        return args.mesh
    if dev.type == "cuda" and dev.index is None:
        return min(torch.cuda.device_count(), args.nodes)
    return 1


def run_lax_federation(args, dev):
    """--engine lax: run one federation and append its record."""
    n = args.nodes
    scenario_name = args.scenario or args.model
    shards = None
    if args.delivery == "sharded":
        shards = _shards(args, dev)
        if shards < 1 or n % shards:
            raise SystemExit(f"--delivery sharded needs --nodes ({n}) divisible "
                             f"by the shard count ({shards})")
    elif args.mesh:
        raise SystemExit("--mesh only applies to --delivery sharded")
    if shards is not None and shards > 1:
        res, wall, mal, attack, membership = mesh_lib.spawn(
            _lax_rank, shards, device=str(dev), timeout=SPAWN_TIMEOUT_S,
            args=(args, shards))
    else:
        res, wall, mal, attack, membership = _lax_run(args, dev, shards)
    honest = [i for i in range(n) if i not in mal]
    record = {
        "engine": "lax", "scenario": scenario_name, "model": scenario_name,
        "status": "ok", "attack": attack.name,
        "attack_params": _parse_attack_args(args.attack_arg),
        "delivery": args.delivery, "topology": args.topology,
        "shards": res.stats.get("shards"),
        "churn_events": len(membership.events) if membership else 0,
        "ttl": max(1, args.ttl), "nodes": n, "ticks": args.ticks,
        "compress": res.stats["compress"],
        "broadcast_bytes": res.stats["broadcast_bytes"],
        "wire_bytes": res.stats["wire_bytes"],
        "delivery_budget": res.stats["delivery_budget"],
        "compact_budget": res.stats["compact_budget"],
        "max_tick_deliveries": res.stats["max_tick_deliveries"],
        "broadcasts": res.stats["broadcasts"],
        "deliveries": res.stats["deliveries"],
        "fedavg_rounds": res.stats["fedavg_rounds"],
        "honest_acc": float(res.acc_history[-1][honest].mean()),
        "malicious_reputation": float(
            sum(res.mean_reputation(i) for i in mal) / len(mal)),
        "wall_s": round(wall, 1),
        "device": str(dev),
    }
    print(f"[dryrun] lax {scenario_name} attack={attack.name} n={n} "
          f"ticks={args.ticks} delivery={args.delivery} "
          f"compress={record['compress']} "
          f"budget={record['delivery_budget']} "
          f"deliveries={record['deliveries']} "
          f"wire_bytes={record['wire_bytes']:.3e} "
          f"honest_acc={record['honest_acc']:.3f} "
          f"rep_attacker={record['malicious_reputation']:.2f} "
          f"wall={wall:.1f}s device={dev}")
    _append(args.out, record)
    return 0


def _sweep_devices(dev):
    """Every visible CUDA device for --device cuda, else the one named."""
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def run_sweep_cli(args, dev):
    """--sweep: expand an attack x topology-seed x size x rng-seed grid, run
    each shape-compatible batch as one batched run (round robin over the
    devices), and append the frontier tables (time-to-accuracy,
    accuracy-under-attack) to the JSON log."""
    sizes = [int(s) for s in args.sweep_sizes.split(",")]
    attack_list = [None if a in ("none", "") else a
                   for a in args.sweep_attacks.split(",")]
    topo_seeds = [int(s) for s in args.sweep_topology_seeds.split(",")]
    seeds = [int(s) for s in args.sweep_seeds.split(",")]
    cells = sweeps.expand_grid(sizes=sizes, attacks=attack_list,
                               topology_seeds=topo_seeds, seeds=seeds)
    ticks = args.ticks
    cfg = simlax.SimLaxConfig(ticks=ticks, train_interval=(8, 16),
                              ttl=max(1, args.ttl),
                              record_every=max(1, ticks // 8),
                              delivery=args.delivery)
    scenario_name = args.scenario or "toy"
    devices = _sweep_devices(dev)
    n_batches = len(sweeps.plan_batches(cells, max_batch=args.max_batch))
    print(f"[dryrun] sweep: {len(cells)} federations in {n_batches} "
          f"batched dispatches over {len(devices)} devices")
    for d in devices:
        _sync(d)
    t0 = time.perf_counter()
    outcomes = sweeps.run_sweep(
        cells, cfg=cfg, scenario=scenario_name,
        topology_kind=args.topology, degree=args.topology_degree,
        target_acc=args.target_acc, max_batch=args.max_batch, devices=devices)
    for d in devices:
        _sync(d)
    wall = time.perf_counter() - t0
    tables = sweeps.frontier_tables(outcomes, target_acc=args.target_acc)
    for row in tables["accuracy_under_attack"]:
        print(f"[dryrun] sweep frontier: attack={row['attack']:<10} "
              f"n={row['size']:<5} acc={row['mean_final_honest_acc']:.3f} "
              f"rep_attacker={row['mean_attacker_reputation']}")
    print(f"[dryrun] sweep done: {len(cells)} federations in {wall:.1f}s "
          f"({len(cells) / wall:.2f} federations/s)")
    record = {
        "engine": "sweep", "status": "ok", "scenario": scenario_name,
        "topology": args.topology, "ttl": max(1, args.ttl), "ticks": ticks,
        "delivery": args.delivery, "sizes": sizes,
        "attacks": [a or "none" for a in attack_list],
        "cells": len(cells), "batches": n_batches,
        "devices": len(devices),
        "wall_s": round(wall, 1),
        "federations_per_s": round(len(cells) / wall, 2),
        "outcomes": [o.row() for o in outcomes],
        "frontier": tables,
        "device": str(dev),
    }
    _append(args.out, record)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.sweep and args.engine != "lax":
        given = [opt for attr, opt in _CELL_OPTIONS if getattr(args, attr)]
        raise NotImplementedError(
            "--engine mesh (the default: lower and compile each arch x shape "
            "cell and report its cost and memory"
            + (f"; given {' '.join(given)}" if given else "")
            + f") is not ported yet: {CELL_REPORT_ITEM}. Run a federation "
            "with --engine lax or --sweep")
    dev = device_lib.resolve(args.device)
    if args.sweep:
        return run_sweep_cli(args, dev)
    return run_lax_federation(args, dev)


if __name__ == "__main__":
    raise SystemExit(main())
