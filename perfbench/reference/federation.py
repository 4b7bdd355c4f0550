"""The §VI-D federation in plain PyTorch and NumPy, for one receiver at a
time: the tick schedule, the ttl-bounded deliveries and their receipts,
impl2 reputation and Eq. 2/3 averaging, the five attacks and the int8
wire, worked out again from the benchmark's inputs.

It follows the program step by step from the program's own state: a
receiver's buffer, reputation row, params and every accuracy are the
reference's, but the models that arrive are rebuilt from the senders'
training inputs and outputs that the run recorded (the reference trains a
sample of those itself, ``train_gaps``). Nothing here imports the program.

The per-tick order is the engine's documented one: deliveries due at t
(receiver ascending, sender ascending) are evaluated, weighted by
rep * accuracy (Eq. 2) and summed into the receiver's buffer in that order;
a buffer of ``buffer_size`` receipts fires: the params become
0.5 * (sum / weight + params) (Eq. 3, when the weight is above 1e-12) and
the sender of the worst receipt (lowest sender on a tie) loses ``penalty``
of reputation, clipped to [floor, initial]; then nodes whose countdown ran
out train and broadcast; a node's model reaches each node within ``ttl``
hops ``hops * latency`` ticks later.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from perfbench.reference import lenet as lenet_ref
from perfbench.reference import wire


# ------------------------------------------------------------------ streams
def _seed_of(text: str) -> int:
    digest = hashlib.sha256(text.encode()).digest()
    return int.from_bytes(digest[:8], "big") & (2 ** 63 - 1)


def _seeded(text: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(_seed_of(text))
    return g


def stream_seed(seed: int, tick: int) -> int:
    """The seed of the stream a federation's tick draws its train batches
    from: a training call handed it is that federation's at that tick."""
    return _seed_of(f"stream:{int(seed)}:{int(tick)}:0")


def train_stream(seed: int, tick: int, device) -> torch.Generator:
    """The generator a federation's tick draws its train batches from."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, tick))
    return g


def attack_stream(seed: int, tick: int, node: int, device, fold: int = 1):
    """An attacker's generator at a tick (fold 1: a sheet's only attack)."""
    return _seeded(f"attack:{int(seed)}:{int(tick)}:{int(fold)}:{int(node)}", device)


# ----------------------------------------------------------------- schedule
class Schedule:
    """Who trains when and which receipts fall due when, for a federation
    on the circulant ring kregular(n, k) under a fixed train interval.

    ``countdown[i]``: ticks until node i's first training (it trains at
    tick countdown - 1, then every ``interval`` ticks)."""

    def __init__(self, n, k, ttl, latency, interval, countdown, ticks, record_every):
        self.n, self.ticks, self.record_every = n, ticks, record_every
        self.interval, self.latency = interval, latency
        ring = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
        ring = np.minimum(ring, n - ring)
        self.hops = -(-ring // k)                       # hop distance
        self.ball = [np.flatnonzero((self.hops[r] >= 1) & (self.hops[r] <= ttl))
                     for r in range(n)]
        self.train_ticks = [list(range(int(c) - 1, ticks, interval)) for c in countdown]
        self.trains = [[] for _ in range(ticks)]
        for i, tt in enumerate(self.train_ticks):
            for t in tt:
                self.trains[t].append(i)
        due = [[] for _ in range(ticks)]
        for s, tt in enumerate(self.train_ticks):
            for tb in tt:
                for r in self.ball[s]:
                    t = tb + int(self.hops[r, s]) * latency
                    if t < ticks:
                        due[t].append((int(r), s))
        self.due = [sorted(d) for d in due]

    def broadcasts(self):
        return np.array([len(tt) for tt in self.train_ticks], np.int64)

    def deliveries(self):
        return sum(len(d) for d in self.due)

    def max_due(self):
        return max((len(d) for d in self.due), default=0)


def count_mismatches(schedule: Schedule, stats: dict) -> int:
    """Event counts of one federation's result that differ from the
    schedule's: broadcasts a node, deliveries, the busiest tick."""
    bad = int((np.asarray(stats["broadcasts_per_node"]) != schedule.broadcasts()).sum())
    bad += int(stats["broadcasts"] != int(schedule.broadcasts().sum()))
    bad += int(stats["deliveries"] != schedule.deliveries())
    bad += int(stats["max_tick_deliveries"] != schedule.max_due())
    return bad


# ------------------------------------------------------------------ attacks
def outgoing(layout, sheet, trained, committed, seed, tick, node):
    """What a sender broadcasts before the wire: its trained model, or its
    attack's model (flat fp32 vectors)."""
    if sheet == "honest":
        return trained
    if sheet == "signflip":
        return -1.0 * trained
    if sheet == "scaled":
        return committed + 10.0 * (trained - committed)
    if sheet == "freerider":
        return committed
    if sheet == "intermittent" and tick % 8 >= 4:
        return trained
    if sheet in ("gaussian", "intermittent"):
        g = attack_stream(seed, tick, node, trained.device)
        parts = [1.0 * torch.randn(shape, generator=g, dtype=torch.float32,
                                   device=trained.device).reshape(-1)
                 for _, shape, _ in layout.leaves]
        return torch.cat(parts)
    raise ValueError(f"unknown sheet {sheet!r}")


def received(layout, vecs):
    """The models after the int8 wire."""
    return lenet_ref.roundtrip(layout, vecs)


def wire_quanta(layout, sent, vecs):
    """Largest |sent - wire(vecs)| in units of each element's block scale."""
    worst = 0.0
    got = layout.split(sent)
    for name, leaf in layout.split(vecs).items():
        y, scale = wire.roundtrip_leaf(leaf)
        b = min(wire.BLOCK, leaf.shape[-1])
        per = scale.repeat_interleave(b, -1)[..., :leaf.shape[-1]]
        worst = max(worst, float(((got[name] - y).abs() / per).max()))
    return worst


# ------------------------------------------------------------- train check
def train_gaps(layout, records, inputs, recipe, seed_of, precision_fn=None):
    """Each sampled training against the reference's in fp64, over
    ``records`` [(member, node, tick, in_vec, out_vec)]: the reference
    trains each input on the batches the tick's stream draws. Returns
    (M,) float64 tensors on the host, each the worst leaf's ||x - ref64|| /
    ||ref64 - input||: ``gap`` of the program's output, ``round`` of the
    reference's own in fp32 (how far fp32 rounding alone moves this
    training: about 1e-7 where the training is well conditioned, O(1)
    where saturated units and max-pool ties amplify it), ``gap32`` of the
    program's against the fp32 reference's, ``in_norm``, the input's
    norm, and ``margin``, the smallest gap between the two largest values
    of any max-pooling window the fp64 reference met (where the
    program's rounding can pick the other one, and route that unit's
    gradient elsewhere). ``precision_fn`` puts its output in the program's place (the
    control)."""
    if not records:
        empty = torch.zeros(0, dtype=torch.float64)
        return dict.fromkeys(("gap", "round", "gap32", "in_norm", "margin"), empty)
    dev = records[0][3].device
    n, pool = inputs["train_labels"].shape
    steps, batch = recipe["train_steps"], recipe["batch"]
    images, labels = [], []
    for b, node, t, _, _ in records:
        idx = torch.randint(0, pool, (n, steps, batch),
                            generator=train_stream(seed_of(b), t, dev), device=dev)[node]
        images.append(inputs["train_images"][node][idx])
        labels.append(inputs["train_labels"][node][idx])
    ins = torch.stack([r[3] for r in records])
    outs = torch.stack([r[4] for r in records])
    images, labels = torch.stack(images), torch.stack(labels)
    ref32 = lenet_ref.sgd(layout, ins, images, labels, recipe["lr"])
    margins = []
    ref = lenet_ref.sgd(layout, ins.double(), images.double(), labels, recipe["lr"],
                        margins=margins)
    if precision_fn is not None:
        outs = precision_fn(ins, images, labels)
    moved = layout.split(ref - ins.double())

    def worst(x):
        w = torch.zeros(len(records), dtype=torch.float64, device=dev)
        for name, d in layout.split(x).items():
            den = moved[name].flatten(1).norm(dim=1).clamp_min(1e-30)
            w = torch.maximum(w, d.flatten(1).norm(dim=1) / den)
        return w.cpu()

    return {"gap": worst(outs.double() - ref), "round": worst(ref32.double() - ref),
            "gap32": worst(outs.double() - ref32.double()),
            "in_norm": ins.double().norm(dim=1).cpu(),
            "margin": torch.stack(margins).amin(0).cpu()}


# ------------------------------------------------------------- the follower
class Follow:
    """One receiver of one member, followed through the run.

    ``dtype`` and ``order`` vary the follower's own arithmetic (readings
    only): Eq. 2/3 and the buffer in another precision, or each tick's
    receipts summed in descending sender order."""

    def __init__(self, layout, schedule, recipe, rep, sheet, malicious, seed,
                 dtype=torch.float32, order="ascending"):
        self.layout, self.sched, self.recipe, self.rep = layout, schedule, recipe, rep
        self.sheet, self.malicious, self.seed = sheet, set(malicious), seed
        self.dtype, self.order = dtype, order

    def sent_models(self, senders, train_rec):
        """{(s, tick): the model s broadcast at tick, after the wire}."""
        keys, outs = [], []
        for s in senders:
            for tb in self.sched.train_ticks[s]:
                cin, cout = train_rec[(s, tb)]
                sheet = self.sheet if s in self.malicious else "honest"
                keys.append((s, tb))
                outs.append(outgoing(self.layout, sheet, cout, cin, self.seed, tb, s))
        models = received(self.layout, torch.stack(outs)) if outs else None
        return {k: models[i] for i, k in enumerate(keys)}

    def run(self, r, params0, train_rec, test_acc, final, eval_data, test_data,
            control=False):
        """Returns (largest relative params gap, reputation gap, receipts).
        Every receipt's weight takes the reference's own accuracy of the
        arriving model; ``receipts`` lists (the program's test accuracy at
        a record tick, ``test_acc(t)``, the reference's of its own params,
        the number of samples); with ``control``, the control's (TF32
        operands) in place of the program's."""
        sched, rep, dt = self.sched, self.rep, self.dtype
        dev = params0.device
        senders = [int(s) for s in sched.ball[r]]
        sent = self.sent_models(senders, train_rec)
        keys = list(sent)
        n_test = test_data[1].shape[-1]
        ref_acc = {}
        if keys:
            models = torch.stack([sent[k] for k in keys])
            ev_i = eval_data[0][r].expand(len(keys), *eval_data[0][r].shape)
            ev_l = eval_data[1][r].expand(len(keys), *eval_data[1][r].shape)
            accs = lenet_ref.accuracy(self.layout, models, ev_i, ev_l)
            ref_acc = {k: float(accs[i]) for i, k in enumerate(keys)}
        receipts = []
        p = params0.to(dt)
        row = torch.full((sched.n,), rep["initial"], dtype=dt, device=dev)
        acc_sum = torch.zeros_like(p)
        w_sum = torch.zeros((), dtype=dt, device=dev)
        cnt, min_acc, min_sender = 0, float("inf"), 0
        gap = 0.0

        def rel(a, b):
            a, b = a.double(), b.double()
            return float((a - b).norm() / b.norm().clamp_min(1e-30))

        hops = sched.hops[r]
        own_ticks = set(sched.train_ticks[r])
        for t in range(sched.ticks):
            items = [s for (rr, s) in sched.due[t] if rr == r] if sched.due[t] else []
            if items:
                accs = {s: ref_acc[(s, t - int(hops[s]) * sched.latency)] for s in items}
                summed = items if self.order == "ascending" else items[::-1]
                for s in summed:
                    w = row[s] * accs[s]
                    acc_sum = acc_sum + w * sent[(s, t - int(hops[s]) * sched.latency)].to(dt)
                    w_sum = w_sum + w
                cnt += len(items)
                batch_min, batch_sender = float("inf"), 0
                for s in items:                      # lowest sender on a tie
                    if accs[s] < batch_min:
                        batch_min, batch_sender = accs[s], s
                if batch_min < min_acc:
                    min_acc, min_sender = batch_min, batch_sender
            if cnt >= rep["buffer_size"]:
                if float(w_sum) > 1e-12:
                    p = 0.5 * (acc_sum / torch.clamp_min(w_sum, 1e-12) + p)
                if min_acc < float("inf"):
                    row[min_sender] = torch.clamp(row[min_sender] - rep["penalty"],
                                                  rep["floor"], rep["initial"])
                acc_sum = torch.zeros_like(p)
                w_sum = torch.zeros_like(w_sum)
                cnt, min_acc, min_sender = 0, float("inf"), 0
            if t in own_ticks:
                cin, cout = train_rec[(r, t)]
                gap = max(gap, rel(cin, p))
                if r not in self.malicious:
                    p = cout.to(dt)
            if t % sched.record_every == 0:
                args = (self.layout, p.float()[None], test_data[0][None], test_data[1][None])
                ref = float(lenet_ref.accuracy(*args)[0])
                got = (float(lenet_ref.accuracy(*args, operands="tf32")[0]) if control
                       else test_acc(t))
                receipts.append((float(got), ref, n_test))
        fin_params, fin_rep = final
        gap = max(gap, rel(fin_params, p))
        rep_gap = float((fin_rep.double() - row.double()).abs().max())
        return gap, rep_gap, receipts


def receipt_gap(receipts):
    """The largest number of samples by which a measured accuracy differs
    from the reference's."""
    return max((round(abs(a - b) * n) for a, b, n in receipts), default=0)
