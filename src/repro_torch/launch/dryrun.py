"""The dry-run command line: a cell report for every (arch x shape x mesh)
cell, or a federation run.

Port of the JAX package's ``repro.launch.dryrun``, with every option of
its command line under the same name, default, choices and meaning:

  * ``--engine mesh`` (the default; ``--arch``/``--shape`` or ``--all``,
    ``--multi-pod``, ``--dfl``, ``--gossip-schedule``, ``--print-hlo``):
    the cell report. JAX lowers and compiles each cell for a 16 x 16 (or
    2 x 16 x 16) mesh of host devices and reads XLA's memory and cost
    analyses. The eager port has nothing to compile: ``lower_cell`` builds
    the step's inputs on the meta device (no weight drawn, no memory
    allocated), traces the port's own step (``make_train_step``,
    ``make_prefill``, ``make_decode``, or with ``--dfl`` one gossip round)
    once under the op-cost walker (``launch.op_cost``) at one device's
    share, and counts what it dispatches; ``cell_record`` does it for an
    ``InputShape`` and an abstract mesh. The record has the JAX record's
    keys, with ``lower_s`` the trace's seconds and ``compile_s`` 0.0
    (nothing compiles), plus ``device`` ("meta": the route allocates
    nothing anywhere, so ``--device`` does not touch it) and ``hw`` (the
    roofline's card figures, ``launch.roofline.H100``). ``--print-hlo``
    prints the walker's per-op table, the counterpart of the HLO text;
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

Each cell or run appends one JSON record to ``--out``.

A record holds one device of the named mesh. Bytes a device: the
arguments (params in fp32, the optimizer state for train, the cache for
prefill and decode, the batch; each leaf over its ``sharding.shard_factor``
under the cell's rules), the outputs (counted the same way), temp (the
walker's live-bytes peak above the arguments) and peak (argument + temp).
FLOPs and bytes a device follow the walker's rule (``launch.op_cost``).
Collective bytes a device, by kind, are a model of the tensor-parallel
step, not a trace (``collective_model``).

For the federation runs ``--device`` defaults to ``cuda`` and raises
without it; ``--device cpu`` runs on the CPU.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--dfl]
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
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import device as device_lib
from repro_torch import sharding as sh
from repro_torch import tree
from repro_torch.chain import attacks, scenarios, simlax, sweeps
from repro_torch.configs import ALL_IDS, ARCH_IDS, SHAPES, cell_status, get_config
from repro_torch.configs.base import ATTN, ENC_ATTN, LOCAL_ATTN, SLSTM
from repro_torch.core import dfl as dfl_lib
from repro_torch.core import topology as topology_lib
from repro_torch.core.reputation import get as get_rep
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_cost, roofline
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.train import step as step_lib

# seconds before every rank of a --delivery sharded run is killed
SPAWN_TIMEOUT_S = 1800.0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ALL_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dfl", action="store_true",
                    help="lower the DFL gossip round instead of the plain step")
    ap.add_argument("--engine", default="mesh", choices=("mesh", "lax"),
                    help="mesh: the cell report, traced on the meta device "
                    "(default); lax: run the vectorized tick simulator "
                    "end-to-end")
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
                    help="--engine lax / --sweep: cuda (default: raises "
                    "without a GPU), cuda:i or cpu (the cell report runs on "
                    "the meta device whatever this says)")
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
    device_lib.sync(dev)
    t0 = time.perf_counter()
    res = sim.run()
    device_lib.sync(dev)
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
        device_lib.sync(d)
    t0 = time.perf_counter()
    outcomes = sweeps.run_sweep(
        cells, cfg=cfg, scenario=scenario_name,
        topology_kind=args.topology, degree=args.topology_degree,
        target_acc=args.target_acc, max_batch=args.max_batch, devices=devices)
    for d in devices:
        device_lib.sync(d)
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


# ------------------------------------------------------------------ cell report
# the metrics a train step (loss, accuracy, aux, grad_norm) or a gossip
# round (its node's four) returns beside the state: fp32 scalars
_METRICS = 4


def _leaf_bytes(t) -> int:
    return t.numel() * t.element_size()


def _sharded_bytes(values, axes, mesh, rules) -> float:
    """Bytes a device holds of ``values`` (a tree, None leaves allowed)
    whose logical axes are ``axes``: each leaf over its shard factor."""
    total = 0.0
    for a, x in zip(tree.leaves(axes, is_leaf=sh.is_axes), tree.leaves(values)):
        if x is None:
            continue
        spec = sh.logical_to_spec(a, mesh, rules, tuple(x.shape))
        total += _leaf_bytes(x) / sh.shard_factor(spec, mesh)
    return total


def _non_model(entry, mesh) -> int:
    """The split of one spec entry over the mesh axes other than
    ``model`` (the walker divides by ``model`` itself)."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in names if a != "model")


def _entry(spec, i):
    return spec[i] if i < len(spec) else None


def _model_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def state_bytes(cfg, shape, mesh, rules, *, dfl=None):
    """(argument, output) bytes a device of one cell's step (see the
    module doc); ``dfl`` a DFLConfig for the gossip round's."""
    if dfl is not None:
        fed = mesh.shape[dfl_lib.fed_axis_for(mesh)]
        params, axes = dfl_lib.abstract_fed_params(cfg, fed)
        vb = {k: torch.empty(dims, dtype=dt, device=step_lib.META)
              for k, (dims, dt) in dfl_lib.val_batch_specs(cfg, dfl, fed).items()}
        rep = torch.empty((fed, fed), dtype=torch.float32, device=step_lib.META)
        p_b = _sharded_bytes(params, axes, mesh, rules)
        rep_b = _sharded_bytes(rep, (sh.FED, None), mesh, rules)
        vb_b = _sharded_bytes(vb, dfl_lib.val_batch_axes(vb), mesh, rules)
        return p_b + rep_b + vb_b, p_b + rep_b + 4 * _METRICS
    batch = step_lib.input_specs(cfg, shape)
    b_b = _sharded_bytes(batch, step_lib.batch_axes(cfg, shape), mesh, rules)
    if shape.kind == "train":
        state, axes = step_lib.abstract_train_state(cfg)
        s_b = _sharded_bytes(state, axes, mesh, rules)
        return s_b + b_b, s_b + 4 * _METRICS
    params, p_axes = step_lib.abstract_params(cfg)
    cache, c_axes = step_lib.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    p_b = _sharded_bytes(params, p_axes, mesh, rules)
    c_b = _sharded_bytes(cache, c_axes, mesh, rules)
    logits = torch.empty((shape.global_batch, cfg.vocab_size), device=step_lib.META)
    lg_b = _sharded_bytes(logits, (sh.BATCH, L.VOCAB), mesh, rules)
    pos_b = 4 if shape.kind == "decode" else 0      # the int32 position
    return p_b + c_b + b_b + pos_b, lg_b + c_b


def _device_shares(cfg, shape, mesh, rules, dfl):
    """(rows, seq) one device traces: the batch over the non-model axes of
    its BATCH spec; for decode the cache's sequence over the non-model
    axes of its KV_SEQ spec; for a gossip round the validation batch."""
    if dfl is not None:
        spec = sh.logical_to_spec((sh.FED, sh.BATCH), mesh, rules,
                                  (mesh.shape[dfl_lib.fed_axis_for(mesh)],
                                   dfl.val_rows))
        return dfl.val_rows // _non_model(_entry(spec, 1), mesh), dfl.val_seq
    B, S = shape.global_batch, shape.seq_len
    rows = B // _non_model(_entry(sh.logical_to_spec(
        (sh.BATCH, sh.SEQ), mesh, rules, (B, S)), 0), mesh)
    if shape.kind == "decode":
        S //= _non_model(_entry(sh.logical_to_spec(
            (sh.BATCH, sh.KV_SEQ), mesh, rules, (B, S)), 1), mesh)
    return rows, S


def _trace(cfg, shape, mesh, rows, seq, dfl):
    """One step at (rows, seq) on the meta device under the walker:
    its totals."""
    if dfl is not None:
        round_fn, args = dfl_lib.abstract_gossip_round(
            cfg, shape, mesh, dataclasses.replace(dfl, val_seq=seq), rows)
        run = lambda: round_fn(*args)
    elif shape.kind == "train":
        state, _ = step_lib.abstract_train_state(cfg)
        args = (state, step_lib.input_specs(cfg, shape, rows, seq))
        run = lambda: step_lib.make_train_step(cfg)(*args)
    else:
        params, _ = step_lib.abstract_params(cfg)
        cache, _ = step_lib.abstract_cache(cfg, rows, seq)
        batch = step_lib.input_specs(cfg, shape, rows, seq)
        if shape.kind == "prefill":
            args = (params, batch, cache)
            run = lambda: step_lib.make_prefill(cfg)(*args)
        else:
            args = (params, cache, batch["tokens"])
            run = lambda: step_lib.make_decode(cfg)(*args, seq - 1)
    # every trace makes the cached rope frequencies itself, so that each
    # one counts the same constants whatever ran before it
    L.rope_cache_clear()
    with op_cost.OpCost(known=args) as walker:
        run()
    return walker.totals()


def _seq_loop(cfg, shape) -> bool:
    """Whether the step runs a Python loop over the sequence (the sLSTM's
    step loop), whose trace is extrapolated from two lengths."""
    return shape.kind != "decode" and SLSTM in cfg.block_pattern


def traced_counts(cfg, shape, mesh, rules, *, dfl=None, full=False):
    """(counts, raw, trips): a device's walker counts for the whole step
    (before the model-axis split), the first trace's, and the trip counts
    applied. Traces 1 and 2 units and extrapolates to the config's unit
    count (n units: X1 + (n - 1)(X2 - X1)). A sequence loop (the sLSTM's)
    is extrapolated from two lengths a and b, two and three
    ``scan_chunk``s (from the mLSTM's second chunk on each adds the same:
    the first carry needs no gradient); there the unit increment's slope
    in S comes from 1- and 0-unit traces, so that only three traces run
    the loop: X(n, S) = X(1, S) + (n - 1)(X(2, a) - X(1, a) + [X(1, S) -
    X(1, a)] - [X(0, S) - X(0, a)]), each X(u, S) linear from a and b.
    ``full`` traces the whole depth and length instead (the check of the
    extrapolation)."""
    rows, seq = _device_shares(cfg, shape, mesh, rules, dfl)
    n_units, n_rest, _ = transformer.unit_layout(cfg)
    ul = transformer.unit_len(cfg)
    loop = _seq_loop(cfg, shape) and not full
    if loop and any(k in (ATTN, LOCAL_ATTN, ENC_ATTN) for k in cfg.block_pattern):
        raise ValueError("a sequence loop beside attention is not linear in S")

    def at(units, s):
        return _trace(cfg.scaled(num_layers=transformer.lead_len(cfg) + units * ul
                                 + n_rest), shape, mesh, rows, s, dfl)

    if full or n_units <= 2:
        units = [] if full or n_units == 0 else [n_units]
        if not loop:
            first = at(n_units, seq)
            return first, first, units
        a, b = 2 * cfg.scan_chunk, 3 * cfg.scan_chunk
        first, t = at(n_units, a), (seq - a) / (b - a)
        return (op_cost.combine([(1 - t, first), (t, at(n_units, b))]), first,
                units + [seq])
    first = at(1, seq if not loop else 2 * cfg.scan_chunk)
    if not loop:
        return op_cost.extrapolate(first, at(2, seq), n_units), first, [n_units]
    a, b = 2 * cfg.scan_chunk, 3 * cfg.scan_chunk
    t, n = (seq - a) / (b - a), n_units
    terms = [(n * (1 - t) - 2 * (n - 1), first), (n * t, at(1, b)),
             (n - 1, at(2, a)), ((n - 1) * t, at(0, a)), (-(n - 1) * t, at(0, b))]
    return op_cost.combine(terms), first, [n_units, seq]


def _row_split_products(cfg, mesh, rules) -> dict:
    """The products whose contracting dim is split over ``model`` (a
    weight whose input axis resolves to ``model``: attention's o, an FFN's
    down, RG-LRU's w_r / w_i / out, mLSTM's inner projections, the
    vocab-split embedding lookup); each leaves fp32 partial sums a device
    to all-reduce. ``{"features": ..., "count": ...}`` over all layers and
    over the stacked units alone (``unit_*``): a product's output features
    are its weight's last dim (o: d_model after contracting heads x
    head_dim; the lookup: a d_model row a token). The unembedding (x @
    table.T) contracts over d_model and is not one; the expert stacks go
    through the all-to-all."""
    params, axes = step_lib.abstract_params(cfg)
    out = dict(features=0.0, count=0, unit_features=0.0, unit_count=0)
    for key in ("embed", "lead", "units", "rest"):
        if key not in axes:
            continue
        stacked = key == "units"
        for a, x in zip(tree.leaves(axes[key], is_leaf=sh.is_axes),
                        tree.leaves(params[key])):
            dims = a[1:] if stacked else a
            if len(dims) < 2 or dims[0] in (L.EXPERTS, L.CONV):
                continue
            entry = _entry(sh.logical_to_spec(a, mesh, rules, tuple(x.shape)),
                           1 if stacked else 0)
            if entry is None or "model" not in (
                    entry if isinstance(entry, tuple) else (entry,)):
                continue
            n = x.shape[0] if stacked else 1
            out["features"] += n * x.shape[-1]
            out["count"] += n
            if stacked:
                out["unit_features"] += n * x.shape[-1]
                out["unit_count"] += n
    return out


def collective_model(cfg, shape, mesh, rules, *, dfl=None, receipts=0):
    """{kind: [bytes, count]}: the collectives a device joins, with their
    operand bytes, for the
    tensor-parallel step the walker's split stands for. With ``model`` > 1:
    every product whose contracting dim is split over ``model`` all-reduces
    its fp32 partial sums (``_row_split_products``' features x tokens x 4 bytes) once
    a forward pass, once in the backward (its column-split partner's input
    gradient, the same size) and once more under remat="full" recompute
    (the stacked units); the vocab-split unembedding adds one (tokens x
    d_model) in the backward; a decode over a cache whose sequence is split
    over ``model`` reduces each global attention layer's partial output and
    softmax sums. An MoE layer's dispatch scatter and combine gather cross
    the expert split the same way, as fp32 partial sums of its (rows x
    experts x capacity x d_model) buffer (decode dispatches the whole batch
    as one row), an all-to-all each a pass. Training adds the fp32
    gradients' all-reduce over the batch axes; FSDP the params' all-gather
    (bf16) a pass. A gossip round's
    ``receipts`` are forward passes of the validation batch."""
    out = {}
    model = _model_size(mesh)
    rows, seq = _device_shares(cfg, shape, mesh, rules, dfl)
    train = shape.kind == "train" and dfl is None
    decode = shape.kind == "decode" and dfl is None
    tokens = rows * (1 if decode else seq)
    fwd = receipts if dfl is not None else 1
    recompute = train and cfg.remat == "full"
    passes = fwd + (2 if recompute else 1 if train else 0)
    if model > 1:
        rs = _row_split_products(cfg, mesh, rules)
        feats = (rs["features"] * fwd + (rs["features"] + cfg.d_model if train else 0)
                 + (rs["unit_features"] if recompute else 0))
        count = (rs["count"] * fwd + (rs["count"] + 1 if train else 0)
                 + (rs["unit_count"] if recompute else 0))
        ar = tokens * 4 * feats
        kv = _entry(sh.logical_to_spec((sh.BATCH, sh.KV_SEQ), mesh, rules,
                                       (shape.global_batch, shape.seq_len)), 1)
        if decode and kv is not None and "model" in (
                kv if isinstance(kv, tuple) else (kv,)):
            n_global = sum(k == ATTN for k in cfg.layer_kinds())
            ar += n_global * rows * cfg.num_heads * (cfg.resolved_head_dim + 2) * 4
            count += n_global
        out["all-reduce"] = [ar, count]
        if cfg.moe is not None:
            m = cfg.moe
            n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
            n_rows, per_row = (1, shape.global_batch) if decode else (rows, seq)
            if m.router == "sigmoid":     # dropless: each (token, choice) pair, bf16
                buf = n_rows * per_row * m.top_k * cfg.d_model * 2
            else:
                cap = max(1, math.ceil(per_row * m.top_k / m.num_experts
                                       * m.capacity_factor))
                buf = n_rows * m.num_experts * cap * cfg.d_model * 4
            out["all-to-all"] = [2.0 * buf * n_moe * passes, 2 * n_moe * passes]
    if train and any(mesh.shape.get(a, 1) > 1 for a in ("pod", "data")):
        params, axes = step_lib.abstract_params(cfg)
        ar, count = out.get("all-reduce", [0.0, 0])
        out["all-reduce"] = [ar + _sharded_bytes(params, axes, mesh, rules),
                             count + 1]
    if cfg.fsdp and dfl is None and mesh.shape.get("data", 1) > 1:
        params, axes = step_lib.abstract_params(cfg)
        out["all-gather"] = [_sharded_bytes(params, axes, mesh, rules) / 2 * passes,
                             len(tree.leaves(params)) * passes]
    return out


def cell_record(cfg, shape, mesh, *, arch=None, dfl=False, extra_rules=None,
                dfl_cfg=None, hw=roofline.H100):
    """(record, counts): the cell report of ``cfg`` at ``shape`` (an
    ``InputShape``) for one device of ``mesh`` (an abstract mesh), and the
    walker's counts behind it for the whole step, before the model-axis
    split (``op_cost.op_table`` prints them; ``kernel_calls`` counts the
    kernel wrappers' calls a step, the flash forward under its route's
    name: ``flash_attention_sm90`` the sm90 kernel, ``flash_attention``
    the simt kernel)."""
    t0 = time.perf_counter()
    sched_info = None
    d = None
    if dfl:
        d = dfl_cfg or dfl_lib.DFLConfig()
        fed_axis = dfl_lib.fed_axis_for(mesh)
        sched_info = dfl_lib.schedule_report(d, mesh.shape[fed_axis], strict=True)
        print(f"[dryrun] gossip schedule: topology={sched_info['topology']} "
              f"ttl={sched_info['ttl']} schedule={sched_info['schedule']} "
              f"coverage={sched_info['coverage']:.3f} "
              f"num_collectives={sched_info['num_collectives']}")
        if shape.kind != "train":
            raise ValueError("the DFL gossip round applies to training shapes")
        rules = dfl_lib.gossip_rules(cfg, fed_axis)
    else:
        rules = step_lib.rules_for(cfg, shape)
    if extra_rules:
        rules.update(extra_rules)
    argument, output = state_bytes(cfg, shape, mesh, rules, dfl=d)
    counts, raw, trips = traced_counts(cfg, shape, mesh, rules, dfl=d)
    model = _model_size(mesh)
    per_dev = op_cost.scale(counts, 1.0 / model)
    raw_dev = op_cost.scale(raw, 1.0 / model)
    n_steps = round(counts["collective_count"].get("collective-permute", 0))
    model_coll = collective_model(cfg, shape, mesh, rules, dfl=d, receipts=n_steps)
    coll = {k: v[0] for k, v in model_coll.items()}
    count = {k: v[1] for k, v in model_coll.items()}
    if d is not None:
        # the exchanges carry a whole replica's payload: a device sends its
        # shard of each leaf
        params, axes = step_lib.abstract_params(cfg)
        coll["collective-permute"] = (
            counts["collective_bytes"].get("collective-permute", 0.0)
            * _sharded_bytes(params, axes, mesh, rules)
            / sum(_leaf_bytes(x) for x in tree.leaves(params)))
        count["collective-permute"] = n_steps
    cost = {"flops": per_dev["flops"], "bytes": per_dev["bytes"],
            "collective_bytes": coll, "collective_count": count,
            "scan_trip_counts": trips}
    terms = roofline.terms(cost, raw_dev, hw)
    temp = per_dev["peak_live"]
    params, _ = step_lib.abstract_params(cfg)
    total_params = transformer.param_count(params)
    mf = roofline.model_flops(cfg, total_params, params["embed"]["table"].numel(),
                              shape)
    t_trace = time.perf_counter() - t0
    flops_global = terms["hlo_flops"] * mesh.size
    record = {
        "arch": arch or cfg.name, "shape": shape.name, "status": "ok",
        "mesh": mesh.describe(),
        "mesh_axes": list(mesh.axis_names),
        "chips": mesh.size,
        "dfl": bool(dfl),
        "topology": d.topology if d is not None else None,
        "gossip_schedule": sched_info,
        "step_kind": "gossip" if dfl else shape.kind,
        "params": int(total_params),
        "bytes_per_device": {"argument": argument, "output": output,
                             "temp": temp, "peak": argument + temp},
        "compress": d.compress if d is not None else None,
        "permute_bytes": (coll.get("collective-permute", 0.0) if dfl else None),
        "roofline": terms,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / flops_global) if flops_global else None,
        "lower_s": round(t_trace, 1), "compile_s": 0.0,
        "device": "meta",
        "hw": dict(hw),
    }
    return record, counts


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               dfl: bool = False, extra_rules=None, cfg_overrides=None,
               mesh=None, dfl_cfg=None, hw=roofline.H100):
    """(record, counts) of one cell (``cell_record``), or a skip record and
    None when ``cell_status`` rules the cell out. ``mesh`` (an abstract
    mesh) overrides the production mesh; ``cfg_overrides`` scale the
    config as the JAX function's do."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.scaled(**cfg_overrides)
    shape = SHAPES[shape_name]
    ok, why = cell_status(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": why}, None
    if mesh is None:
        mesh = mesh_lib.abstract_production_mesh(multi_pod=multi_pod)
    return cell_record(cfg, shape, mesh, arch=arch, dfl=dfl,
                       extra_rules=extra_rules, dfl_cfg=dfl_cfg, hw=hw)


def run_cells(ap, args) -> int:
    """--engine mesh: one record a cell, appended to --out as it is made;
    cells already there (by the JAX key: arch, shape, mesh, dfl, topology)
    are skipped. Exits 1 when a cell errs."""
    if args.all:
        cells = [(arch, shape) for arch in ARCH_IDS for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]
    dfl_cfg = None
    if args.dfl:
        dfl_cfg = dfl_lib.DFLConfig(ttl=args.ttl, topology=args.topology,
                                    topology_degree=args.topology_degree,
                                    schedule=args.gossip_schedule,
                                    compress=args.compress)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    topo_tag = args.topology if args.dfl else None
    done = {(r["arch"], r["shape"], r.get("mesh"), r.get("dfl", False),
             r.get("topology", "ring" if r.get("dfl") else None))
            for r in results if r.get("status") in ("ok", "skip")
            and "arch" in r}
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    for arch, shape in cells:
        key = (arch, shape, mesh_tag, args.dfl, topo_tag)
        skip_key = (arch, shape, None, args.dfl, topo_tag)
        if key in done or skip_key in done:
            print(f"[dryrun] {arch} x {shape} ({mesh_tag}) cached, skipping")
            continue
        print(f"[dryrun] {arch} x {shape} mesh={mesh_tag} dfl={args.dfl} "
              f"topology={topo_tag} ...", flush=True)
        try:
            rec, counts = lower_cell(arch, shape, multi_pod=args.multi_pod,
                                     dfl=args.dfl, dfl_cfg=dfl_cfg)
            if rec["status"] == "ok":
                rf = rec["roofline"]
                print(f"  traced in {rec['lower_s']}s; "
                      f"flops/dev={rf['hlo_flops']:.3e} "
                      f"coll_bytes/dev={rf['collective_bytes']:.3e} "
                      f"dominant={rf['dominant']}")
                print(f"  memory/device: {rec['bytes_per_device']}")
                print(f"  collectives: {rf['collectives']}")
                if args.print_hlo:
                    print(op_cost.op_table(counts))
            else:
                print(f"  SKIP: {rec['reason']}")
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                   "dfl": args.dfl, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
            print(f"  ERROR: {type(e).__name__}: {e}")
            traceback.print_exc(limit=4)
        results.append(rec)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_skip = sum(1 for r in results if r.get("status") == "skip")
    n_err = sum(1 for r in results if r.get("status") == "error")
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_err} error -> {args.out}")
    return 1 if n_err else 0


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.sweep and args.engine != "lax":
        return run_cells(ap, args)
    dev = device_lib.resolve(args.device)
    if args.sweep:
        return run_sweep_cli(args, dev)
    return run_lax_federation(args, dev)


if __name__ == "__main__":
    raise SystemExit(main())
