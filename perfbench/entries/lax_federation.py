"""The LeNet federation cells: ``repro_torch.chain.simlax.LaxSimulator.run``
over the §VI-D recipe, one federation (or one batch of federations) a unit.

Set-up draws the scenario's inputs, the role sheets and the stacked initial
params from the seed (``gen.lenet_data``), builds the program's
``LeNetScenario`` from those arrays and warms the engine up on a short
federation. A unit constructs a fresh ``LaxSimulator`` (a user pays that
for every federation) with seeds derived from the run's seed and the
unit's index, and runs it from the benchmark's params.

The check needs what the timed path did, so the first unit of the window
records, through a thin wrapper around the scenario's stacked training,
the training inputs and outputs of the watched nodes (the watched
receivers and every node in their ttl-balls), copied without a host sync
into pinned host memory. After the window the plain reference
(``reference.federation``) follows the watched receivers through that
federation from those records, measuring every receipt and test accuracy
itself, holds their final params, reputation rows and test accuracies and
the watched nodes' last broadcasts to the program's result, and trains a
sample of the recorded inputs itself.
"""
from __future__ import annotations

import dataclasses
import math
import random
import statistics
import sys

import torch
from torch.profiler import record_function

from perfbench.gen import lenet_data
from perfbench.reference import federation as fed_ref
from perfbench.reference import lenet as lenet_ref
from perfbench.reference import precision
from perfbench.seeds import derive


def _countdown(recipe, n):
    cd = recipe["countdown"]
    return [cd["base"] + (cd["step"] * i) % cd["mod"] for i in range(n)]


def _malicious(recipe, n):
    return tuple(range(max(1, int(n * recipe["malicious_share"]))))


class Recorder:
    """Wraps a scenario's ``train_stacked``, ``eval_stacked`` and
    ``test_stacked``, each call also a profiler range. While ``active``, a
    training call is keyed by what it is handed, whatever the order or the
    grouping of the calls: its random stream names the member and the tick
    (the reference derives the same streams from the run's seeds), its
    ``ids`` the nodes. The watched nodes among them are found on the card
    and their inputs and outputs copied into pinned host memory, with no
    host sync."""

    def __init__(self, sc, layout, sched, member_seeds, watch, device):
        self.sc, self.layout = sc, layout
        self.device = device
        self.pin = device.type == "cuda"
        self.active = False
        self.key = {fed_ref.stream_seed(seed, t): (b, t)
                    for b, seed in enumerate(member_seeds)
                    for t in range(sched.ticks) if sched.trains[t]}
        # the watched nodes each (member, tick) trains, as index tensors
        # made once (no host-to-device copy inside the window)
        self.want = {}
        for b, nodes in watch.items():
            ws = set(nodes)
            for t in range(sched.ticks):
                sel = [i for i in sched.trains[t] if i in ws]
                if sel:
                    self.want[(b, t)] = (sel, torch.as_tensor(sel, device=device))
        self.orig = {"train": sc.train_stacked, "eval": sc.eval_stacked,
                     "test": sc.test_stacked}
        sc.train_stacked, sc.eval_stacked, sc.test_stacked = (
            self._train, self._eval, self._test)

    def start(self):
        """Record the next federation."""
        self.records, self.unknown = [], 0
        self.active = True

    def _host(self, x):
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=self.pin)
        out.copy_(x, non_blocking=True)
        return out

    def _train(self, params, generator, data, rows, ids=None):
        with record_function("perfbench.train_stacked"):
            out = self.orig["train"](params, generator, data, rows, ids)
            if self.active:
                key = self.key.get(generator.initial_seed())
                if key is None:
                    self.unknown += 1
                elif key in self.want:
                    nodes, want = self.want[key]
                    got = rows if ids is None else ids
                    hit = got[None, :] == want[:, None]            # (watched, M)
                    pos = hit.to(torch.int32).argmax(1)
                    self.records.append((key, nodes, self._host(hit.any(1)),
                                         self._host(got[pos]),
                                         self._host(self.layout.flatten(params, rows[pos])),
                                         self._host(self.layout.flatten(out, pos))))
            return out

    def _eval(self, models, data):
        with record_function("perfbench.eval_stacked"):
            return self.orig["eval"](models, data)

    def _test(self, params):
        with record_function("perfbench.test_stacked"):
            return self.orig["test"](params)

    def trainings(self, device):
        """{member: {(node, tick): (input, output)}} of the recorded
        federation, and the watched trainings the schedule has that it
        lacks (found in no call, or twice)."""
        out, seen = {}, {}
        for (b, t), nodes, found, got, ins, outs in self.records:
            for j, node in enumerate(nodes):
                if bool(found[j]) and int(got[j]) == node:
                    out.setdefault(b, {})[(node, t)] = (ins[j].to(device), outs[j].to(device))
                    seen[(b, node, t)] = seen.get((b, node, t), 0) + 1
        expected = {(b, node, t) for (b, t), (nodes, _) in self.want.items() for node in nodes}
        missing = sum(1 for k in expected if seen.get(k, 0) != 1)
        return out, missing + self.unknown


class FederationRun:
    def __init__(self, bench):
        from repro_torch.chain import attacks, scenarios, simlax
        from repro_torch.core import reputation, topology
        self.bench = bench
        cfgf, cell = bench.config, bench.cell
        # the configuration's fp32: no TF32 in cuDNN's convolutions or in
        # the products (PyTorch lets cuDNN take TF32 by default)
        fp32 = cfgf["model"]["precision"] == "float32"
        torch.backends.cudnn.allow_tf32 = not fp32
        torch.backends.cuda.matmul.allow_tf32 = not fp32
        recipe, model = cfgf["recipe"], cfgf["model"]
        traffic = cell["traffic"]
        self.recipe, self.model = recipe, model
        dev = self.device = bench.device
        n = self.n = traffic["nodes"]
        ticks = traffic.get("ticks", recipe["ticks"])
        self.ticks = ticks
        self.sheets = [s for s in traffic["sheets"] for _ in range(traffic["seeds_per_sheet"])]
        self.members = len(self.sheets)
        inputs = lenet_data.draw_inputs(recipe, model, n, bench.seed, dev)
        self.params0 = lenet_data.draw_params(model, n, bench.seed, dev)
        self.inputs = inputs
        mal = self.malicious = _malicious(recipe, n)
        cd = _countdown(recipe, n)
        self.sc = scenarios.LeNetScenario(
            class_probs=inputs["class_probs"].cpu().numpy(),
            train_images=inputs["train_images"], train_labels=inputs["train_labels"],
            eval_images=inputs["eval_images"], eval_labels=inputs["eval_labels"],
            test_images=inputs["test_images"], test_labels=inputs["test_labels"],
            malicious=mal, train_steps=recipe["train_steps"], batch=recipe["batch"],
            lr=recipe["lr"], seed=0)
        topo_cfg = recipe["topology"]
        self.topo = getattr(topology, topo_cfg["kind"])(n, topo_cfg["k"])
        self.rep_impl = reputation.get(recipe["reputation"])
        self.specs = []
        for sheet in self.sheets:
            if sheet == "honest":
                self.specs.append(attacks.FederationSpec.build(n, initial_countdown=cd))
            else:
                self.specs.append(attacks.FederationSpec.build(
                    n, malicious=mal, attack=sheet, initial_countdown=cd))
        iv = recipe["train_interval"]
        self.cfg = simlax.SimLaxConfig(
            ticks=ticks, train_interval=(iv, iv), latency=recipe["latency"],
            ttl=recipe["ttl"], record_every=recipe["record_every"], seed=0,
            delivery=recipe["delivery"], compress=recipe["compress"])
        self.simlax, self.attacks = simlax, attacks
        self.sched = fed_ref.Schedule(n, topo_cfg["k"], recipe["ttl"], recipe["latency"],
                                      iv, cd, ticks, recipe["record_every"])
        self.layout = lenet_ref.Layout(model)
        self._pick_watch()
        self.rec = Recorder(self.sc, self.layout, self.sched, self._seeds(0), self.watch, dev)
        self.k = 0
        self.result = None
        # warm-up: a short federation through the same calls and shapes
        warm = dataclasses.replace(self.cfg, ticks=min(ticks, cfgf["warmup_ticks"]))
        self._run(warm, 0)

    def _pick_watch(self):
        """Watched members (one a sheet) and receivers (one in the
        poisoners' block, one at its edge, one honest), drawn from the seed."""
        rng = random.Random(derive(self.bench.seed, "watch"))
        per = self.bench.cell["traffic"]["seeds_per_sheet"]
        n, m = self.n, len(self.malicious)
        members = [i * per + rng.randrange(per) for i in range(len(self.sheets) // per)]
        members = members[:self.bench.cell["check"]["members"]]
        self.receivers, self.watch = {}, {}
        for b in members:
            rs = sorted({rng.randrange(m), rng.randrange(max(0, m - 2), min(n, m + 2)),
                         rng.randrange(m, n)})
            self.receivers[b] = rs
            nodes = set(rs)
            for r in rs:
                nodes.update(int(s) for s in self.sched.ball[r])
            self.watch[b] = sorted(nodes)

    def _seeds(self, k):
        return [derive(self.bench.seed, "federation", k, b) for b in range(self.members)]

    def _run(self, cfg, k):
        seeds = self._seeds(k)
        if self.members == 1:
            spec, cfg = self.specs[0], dataclasses.replace(cfg, seed=seeds[0])
        else:
            spec = self.attacks.BatchedFederationSpec.build(self.specs, seeds)
        sim = self.simlax.LaxSimulator(self.sc, self.topo, spec, self.rep_impl, cfg,
                                       device=self.device)
        out = sim.run(self.params0)
        return out if isinstance(out, list) else [out]

    def unit(self):
        if self.k == 0:
            self.rec.start()
        results = self._run(self.cfg, self.k)
        if self.k == 0:
            self.result = results
        self.rec.active = False
        self.k += 1
        b = self.members
        return {"ticks": self.ticks * b, "units": 1, "federations": b,
                "trainings": int(self.sched.broadcasts().sum()) * b,
                "deliveries": self.sched.deliveries() * b,
                "test_models": len(range(0, self.ticks, self.recipe["record_every"]))
                * self.n * b}

    def release(self):
        """Drop the program's objects; the inputs and the records stay."""
        self.sc = None
        self.rec.sc = None
        self.rec.orig = None

    # ---------------------------------------------------------------- check
    def check(self, control=None, variants=False):
        """The numbers compared, each with its limit. ``control`` puts the
        control in the program's place; ``variants`` also follows each
        receiver in fp64, in bf16 and summing in descending sender order
        (readings). Both leave what they read in ``self.readings``."""
        dev = self.device
        layout, sched, rec = self.layout, self.sched, self.rec
        limits = self.bench.cell["check"]["limits"]
        seeds = self._seeds(0)
        params0 = layout.flatten(self.params0)
        train, lacking = rec.trainings(dev)
        events = lacking + sum(fed_ref.count_mismatches(sched, r.stats) for r in self.result)
        self.readings = {}
        if lacking:
            print(f"perfbench: {lacking} watched trainings not recorded once", file=sys.stderr)
            values = dict.fromkeys(limits, math.inf)
            values["events"] = events
            return [(k, values[k], limits[k]) for k in limits]
        test_images, test_labels = self.inputs["test_images"], self.inputs["test_labels"]
        follow_gap = rep_gap = wire_gap = 0.0
        varied = {"descending": 0.0, "fp64": 0.0, "bf16": 0.0}
        receipts = []
        rep = self.bench.config["reputation"][self.recipe["reputation"]]
        with precision():
            for b, rs in self.receivers.items():
                res = self.result[b]
                sheet = self.sheets[b]
                mal = () if sheet == "honest" else self.malicious
                final = _flat(layout, res.params, dev)
                sent = _flat(layout, res.sent, dev)
                record_rows = {t: i for i, t in enumerate(res.record_ticks.tolist())}
                for r in rs:
                    def test_acc(t, r=r, res=res):
                        return float(res.acc_history[record_rows[t], r])

                    args = (r, params0[r], train[b], test_acc,
                            (final[r], torch.as_tensor(res.reputation[r], device=dev)),
                            (self.inputs["eval_images"], self.inputs["eval_labels"]),
                            (test_images, test_labels))
                    follower = fed_ref.Follow(layout, sched, self.recipe, rep, sheet, mal,
                                              seeds[b])
                    g, rg, rc = follower.run(*args, control=control is not None)
                    follow_gap, rep_gap = max(follow_gap, g), max(rep_gap, rg)
                    receipts += rc
                    if variants:
                        for name, kw in (("descending", {"order": "descending"}),
                                         ("fp64", {"dtype": torch.float64}),
                                         ("bf16", {"dtype": torch.bfloat16})):
                            v = fed_ref.Follow(layout, sched, self.recipe, rep, sheet, mal,
                                               seeds[b], **kw).run(*args)[0]
                            varied[name] = max(varied[name], v)
                # the wire: every watched node's last broadcast, as sent
                for s in self.watch[b]:
                    tl = sched.train_ticks[s][-1]
                    cin, cout = train[b][(s, tl)]
                    sh = sheet if s in mal else "honest"
                    out = fed_ref.outgoing(layout, sh, cout, cin, seeds[b], tl, s)
                    wire_gap = max(wire_gap, fed_ref.wire_quanta(layout, sent[s][None], out[None]))
            # the training stage: a sample of the recorded trainings
            rng = random.Random(derive(self.bench.seed, "train-sample"))
            keys = sorted((b, s, t) for b in train for (s, t) in train[b])
            keys = rng.sample(keys, min(len(keys), self.bench.cell["check"]["train_sample"]))
            sample = [(b, s, t, *train[b][(s, t)]) for b, s, t in keys]
            fn = None if control is None else control(self)
            d = fed_ref.train_gaps(layout, sample, self.inputs, self.recipe,
                                   lambda b: seeds[b], fn)
        train_gap, train_off = training_numbers(d, self.bench.cell["check"])
        values = {"events": events, "train_gap": train_gap, "train_off": train_off,
                  "wire_gap": wire_gap,
                  "acc_gap": fed_ref.receipt_gap(receipts), "follow_gap": follow_gap,
                  "rep_gap": rep_gap}
        self.readings = {"values": values, "trainings": d, "follow": varied}
        return [(k, values[k], limits[k]) for k in values]


def training_numbers(d, check):
    """The training stage's two numbers, over the sampled trainings that
    the reference itself pins down (its own fp32 rounding moves them by at
    most ``check["conditioned"]`` of their move): the lower quartile of
    their gaps, steady from seed to seed, which reads the precision the
    trainings ran in; and the count of them whose gap passes
    ``check["off"]``, which reads a fault on any share of them. Judged
    trainings whose gap lies between the two are those where the program's
    rounding picked the other of two near-equal values in a max pooling
    (``d["margin"]``) and 8 steps carried the change on."""
    kept = d["round"] <= check["conditioned"]
    gaps = d["gap"][kept].tolist()
    print(f"perfbench: trainings judged {len(gaps)} of {len(kept)} (the reference's own "
          f"fp32 rounding moves the rest past {check['conditioned']!r})", file=sys.stderr)
    if not gaps:
        return math.inf, math.inf
    quartile = statistics.quantiles(gaps, n=4)[0] if len(gaps) > 1 else gaps[0]
    return quartile, sum(g > check["off"] for g in gaps)


def _flat(layout, tree, device):
    return layout.flatten({k: {kk: torch.as_tensor(vv, device=device) for kk, vv in v.items()}
                           for k, v in tree.items()})


def tf32_control(run):
    """The control: the reference's training in TF32 (operands rounded to
    10 mantissa bits) put in the program's place."""
    def fn(ins, images, labels):
        return lenet_ref.sgd(run.layout, ins, images, labels, run.recipe["lr"],
                             operands="tf32")
    return fn


def setup(bench):
    return FederationRun(bench)
