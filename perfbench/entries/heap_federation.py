"""The paper's chain path: ``repro_torch.chain.network.Simulator`` (the heap
engine: every node signs its transactions and receipts with 1024-bit
textbook RSA, receipts flow back to the generators, blocks are drafted,
confirmed by the neighbours and appended to digest-chained ledgers) over
the §VI-D recipe at n 10, built by ``chain.scenarios.make_heap_simulator``,
one federation a unit.

Set-up draws the inputs and the stacked initial params from the seed
(``gen.lenet_data``), builds the program's ``LeNetScenario`` from those
arrays and runs a short federation. A unit constructs a fresh Simulator
(keys included: a user pays them for every federation), seeds derived
from the run's seed and the unit's index, puts the benchmark's params in
its nodes and runs it. The chain's own work is timed by wrappers the
entry puts round the program's chain functions (after the JAX package's
``benchmarks/harness.py`` ``Timers``, written anew here): key generation,
signing and verifying, fingerprints and digests, block drafts,
confirmations and appends, receipts; a call inside another timed call
counts once, in the outer one. A unit returns its ticks and those seconds.

The check, over the window's first federation: the events (the broadcasts
and deliveries the Simulator counted against the reference's schedule,
``reference.federation.Schedule``); the chain (every ledger's digest chain
and every digest and signature of its blocks, transactions, receipts and
confirmations recomputed and verified in plain code, ``pow(sig, e, n)``);
and three watched receivers' FedAvg updates, recorded as the program made
them: each buffered model's receipt accuracy measured again on the
receiver's own data (``acc_gap``, samples), Eq. 2 / Eq. 3 over the buffer
(``follow_gap``) and the punishment of the lowest-accuracy senders
(``rep_gap``) worked out again from what the update was handed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import random
import sys
import time

import torch

from perfbench.entries.lax_federation import _countdown, _malicious
from perfbench.gen import lenet_data
from perfbench.reference import federation as fed_ref
from perfbench.reference import lenet as lenet_ref
from perfbench.reference import precision
from perfbench.seeds import derive

# the program's chain functions and node methods the timers wrap
CHAIN_FUNCS = ("generate_keypair", "sign", "verify", "hash_fields", "fingerprint_tree")
CHAIN_METHODS = ("create_transaction", "attach_receipt", "draft_block", "confirm_block",
                 "finalize_block")


class Timers:
    """Seconds in the wrapped calls; a timed call inside another counts in
    the outer one."""

    def __init__(self):
        self.seconds, self.depth = 0.0, 0

    def wrap(self, fn):
        def timed(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            self.depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1
                self.seconds += time.perf_counter() - t0
        return timed


def _hash_fields(*fields) -> str:
    """The chain's digest of its fields: sha256 over their JSON list of
    strings (the paper's hash(content))."""
    blob = json.dumps([str(f) for f in fields], separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def _signed(public_key: str, digest: str, sig: str) -> bool:
    n_hex, e_hex = public_key.split(":")
    n, e = int(n_hex, 16), int(e_hex, 16)
    return bool(sig) and pow(int(sig, 16), e, n) == int(digest, 16) % n


def chain_faults(ledgers) -> int:
    """Every block of every ledger after its genesis, its digest chain and
    every digest and signature in it checked in plain code: the count of
    those that fail."""
    bad = 0
    for blocks in ledgers:
        for prev, b in zip(blocks, blocks[1:]):
            bad += b.previous_final_digest != prev.final_digest
            bad += b.genesis_digest != blocks[0].genesis_digest
            d = _hash_fields(b.generator.address, b.create_time, b.previous_final_digest,
                             b.genesis_digest, b.height, [t.d for t in b.transactions],
                             [[r.d for r in t.receipts] for t in b.transactions])
            bad += d != b.d or not _signed(b.generator.public_key, b.d, b.sig)
            bad += b.final_digest != _hash_fields(b.d, [c.d for c in b.confirmations])
            for t in b.transactions:
                td = _hash_fields(t.generator.address, t.create_time, t.expire_time,
                                  t.ml_model, t.ttl)
                bad += td != t.d or not _signed(t.generator.public_key, t.d, t.sig)
                for r in t.receipts:
                    rd = _hash_fields(r.creator.address, r.transaction_digest,
                                      r.received_at_ttl, f"{r.accuracy:.6f}", r.create_time)
                    bad += (rd != r.d or r.transaction_digest != t.d
                            or not _signed(r.creator.public_key, r.d, r.sig))
            receipts = {r.d for t in b.transactions for r in t.receipts}
            for c in b.confirmations:
                cd = _hash_fields(c.creator.address, c.transaction_digest,
                                  c.receipt_digest, c.block_digest)
                bad += (cd != c.d or c.block_digest != b.d or c.receipt_digest not in receipts
                        or not _signed(c.creator.public_key, c.d, c.sig))
    return int(bad)


class UpdateRecorder:
    """Wraps the watched nodes' ``maybe_update_model``: for each update that
    fires, what it was handed (own params, the buffer's senders, models and
    accuracies, the reputations) and what it left (params, reputations),
    kept on the device (no host sync)."""

    def __init__(self, nodes, watched):
        self.records = {i: [] for i in watched}
        for i in watched:
            node = nodes[i]
            orig = node.maybe_update_model

            def update(now, node=node, orig=orig, i=i):
                full = len(node.buffer) >= node.rep_impl.buffer_size
                if full:
                    buf = node.buffer[:node.rep_impl.buffer_size]
                    before = (_clone(node.params), [b.sender for b in buf],
                              [_clone(b.params) for b in buf], [b.accuracy for b in buf],
                              dict(node.reputation))
                done = orig(now)
                if full and done:
                    self.records[i].append(before + (_clone(node.params),
                                                     dict(node.reputation)))
                return done
            node.maybe_update_model = update


def _clone(tree):
    return {k: {kk: v.detach().clone() for kk, v in leaves.items()}
            for k, leaves in tree.items()}


class HeapFederationRun:
    def __init__(self, bench):
        from repro_torch.chain import attacks, crypto, node, scenarios, simlax
        from repro_torch.core import reputation, topology
        self.bench = bench
        cfgf, cell = bench.config, bench.cell
        fp32 = cfgf["model"]["precision"] == "float32"
        torch.backends.cudnn.allow_tf32 = not fp32
        torch.backends.cuda.matmul.allow_tf32 = not fp32
        recipe, model = cfgf["recipe"], cfgf["model"]
        self.recipe, self.model = recipe, model
        dev = self.device = bench.device
        n = self.n = cell["traffic"]["nodes"]
        self.ticks = cell["traffic"].get("ticks", recipe["ticks"])
        self.inputs = inputs = lenet_data.draw_inputs(recipe, model, n, bench.seed, dev)
        self.params0 = lenet_data.draw_params(model, n, bench.seed, dev)
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
        self.spec = attacks.FederationSpec.build(
            n, malicious=mal, attack=cell["traffic"]["sheet"], initial_countdown=cd)
        iv = recipe["train_interval"]
        self.cfg = simlax.SimLaxConfig(
            ticks=self.ticks, train_interval=(iv, iv), latency=recipe["latency"],
            ttl=recipe["ttl"], record_every=recipe["record_every"], seed=0,
            compress=recipe["compress"])
        self.scenarios = scenarios
        self.sched = fed_ref.Schedule(n, topo_cfg["k"], recipe["ttl"], recipe["latency"],
                                      iv, cd, self.ticks, recipe["record_every"])
        self.layout = lenet_ref.Layout(model)
        rng = random.Random(derive(bench.seed, "watch"))
        self.watched = sorted(rng.sample(range(n), cell["check"]["receivers"]))
        self.timers = Timers()
        self.wrapped = [(crypto, name, getattr(crypto, name)) for name in CHAIN_FUNCS] + [
            (node.DFLNode, name, getattr(node.DFLNode, name)) for name in CHAIN_METHODS]
        for owner, name, fn in self.wrapped:
            setattr(owner, name, self.timers.wrap(fn))
        self.k, self.events, self.first = 0, 0, None
        warm = dataclasses.replace(self.cfg, ticks=min(self.ticks, cfgf["warmup_ticks"]))
        self._run(warm, -1)

    def _run(self, cfg, k):
        seed = derive(self.bench.seed, "heap-federation", k) % 2 ** 31
        sim = self.scenarios.make_heap_simulator(
            self.sc, self.topo, self.spec, self.rep_impl,
            dataclasses.replace(cfg, seed=seed), seed=seed, device=self.device)
        nodes = list(sim.nodes.values())
        for i, nd in enumerate(nodes):       # the benchmark's initial params
            nd.params = {k_: {kk: v[i].clone() for kk, v in leaves.items()}
                         for k_, leaves in self.params0.items()}
        rec = UpdateRecorder(nodes, self.watched) if k == 0 else None
        sim.run()
        return sim, nodes, rec

    def unit(self):
        before = self.timers.seconds
        sim, nodes, rec = self._run(self.cfg, self.k)
        st = sim.stats
        self.events += (abs(st["tx_sent"] - int(self.sched.broadcasts().sum()))
                        + abs(st["tx_delivered"] - self.sched.deliveries()))
        if self.k == 0:
            self.first = (nodes, rec, int(st.get("blocks", 0)))
        self.k += 1
        return {"ticks": self.ticks, "units": 1, "federations": 1,
                "chain_s": self.timers.seconds - before, "blocks": int(st.get("blocks", 0))}

    def release(self):
        self.sc = None
        for owner, name, fn in self.wrapped:      # the program's own again
            setattr(owner, name, fn)

    # ---------------------------------------------------------------- check
    def check(self):
        nodes, rec, blocks = self.first
        limits = self.bench.cell["check"]["limits"]
        ledgers = [nd.ledger.blocks for nd in nodes]
        appended = sum(len(b) - 1 for b in ledgers)
        chain_off = chain_faults(ledgers) + abs(appended - blocks) + (appended == 0)
        ev_i, ev_l = self.inputs["eval_images"], self.inputs["eval_labels"]
        n_eval = ev_l.shape[-1]
        rep = self.bench.config["reputation"][self.recipe["reputation"]]
        acc_gap = follow_gap = rep_gap = 0.0
        updates = 0
        with precision():
            for r, records in rec.records.items():
                for own, senders, models, accs, rep_in, after, rep_out in records:
                    updates += 1
                    vec = self.layout.flatten({k: {kk: v[None] for kk, v in lv.items()}
                                               for k, lv in own.items()})[0]
                    mods = torch.cat([self.layout.flatten(
                        {k: {kk: v[None] for kk, v in lv.items()} for k, lv in m.items()})
                        for m in models])
                    ref_acc = lenet_ref.accuracy(
                        self.layout, mods, ev_i[r].expand(len(models), *ev_i[r].shape),
                        ev_l[r].expand(len(models), *ev_l[r].shape))
                    acc_gap = max(acc_gap, max(round(abs(a - float(b)) * n_eval)
                                               for a, b in zip(accs, ref_acc)))
                    w = torch.tensor([rep_in.get(s, rep["initial"]) for s in senders],
                                     dtype=torch.float32, device=vec.device) * ref_acc
                    want = vec if float(w.sum()) <= 1e-12 else \
                        0.5 * ((w[:, None] * mods).sum(0) / w.sum() + vec)
                    got = self.layout.flatten({k: {kk: v[None] for kk, v in lv.items()}
                                               for k, lv in after.items()})[0]
                    follow_gap = max(follow_gap, float((got.double() - want.double()).norm()
                                                       / want.double().norm()))
                    worst = float(ref_acc.min())
                    row = dict(rep_in)
                    for s, a in zip(senders, ref_acc.tolist()):
                        if a <= worst + 1e-9:
                            row[s] = max(rep["floor"], row.get(s, rep["initial"]) - rep["penalty"])
                    for s in set(row) | set(rep_out):
                        rep_gap = max(rep_gap, abs(row.get(s, rep["initial"])
                                                   - rep_out.get(s, rep["initial"])))
        print(f"perfbench: {appended} blocks checked, {updates} watched updates "
              f"followed", file=sys.stderr)
        values = {"events": self.events + (updates == 0), "chain_off": chain_off,
                  "acc_gap": acc_gap, "follow_gap": follow_gap, "rep_gap": rep_gap}
        return [(k, values[k], limits[k]) for k in values]


def setup(bench):
    return HeapFederationRun(bench)
