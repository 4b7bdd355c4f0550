"""An LM node's local training: the H local steps a DFL node runs between
gossip rounds, ``repro_torch.core.gossip.make_local_steps(
repro_torch.train.step.make_train_step(cfg))``, one call a unit.

Set-up draws the fp32 params on the card from the seed (``gen.glm_weights``),
builds the program's training state (its AdamW state and step counter)
around them, and drives that same state through the window's own call and
feed for two calls, H = 2 steps each: they warm every kernel and shape of
the window up, and the first three of their steps are the ones the
reference follows. The train step those calls make is watched
(``StepWatch``), which keeps only what the check compares: each step's
loss, each leaf's norm of the first gradient as the optimizer got it
(from AdamW's first moment after one step) and each leaf's change over
the first three steps, read before the fourth. The window then drives the
same state on, H steps a call, on the next token rows (no row is reused
while the pool lasts).

After the window the state is freed, and the reference (``reference.glm``,
fp32, TF32 off) draws the same initial params again and takes the same
three steps.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import sys
import time

import torch

from perfbench.gen import glm_weights, tokens
from perfbench.reference import glm as glm_ref
from perfbench.reference import precision

FIRST_STEPS = 3
SETUP_CALLS = 2


def arch_config(config: dict):
    from repro_torch.configs.base import ArchConfig
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in config["arch"].items() if k in fields}
    kw["block_pattern"] = tuple(kw.get("block_pattern", ("attn",)))
    return ArchConfig(**kw)


def _norms(tree_paths):
    return {path: float(t.double().norm()) for path, t in tree_paths}


class StepWatch:
    """The train step the local steps call: the program's, passed through;
    while ``on``, after step k (1 first) it reads the loss, after step 1
    the first moment's norms and after step ``FIRST_STEPS`` the change."""

    def __init__(self, fn, read):
        self.fn, self.read = fn, read
        self.on, self.k = False, 0

    def __call__(self, state, batch):
        state, metrics = self.fn(state, batch)
        if self.on:
            self.k += 1
            self.read(self.k, state, metrics)
        return state, metrics


class LocalStepsRun:
    def __init__(self, bench):
        from repro_torch.core import gossip
        from repro_torch.models import transformer
        from repro_torch.train import step as step_lib
        self.bench = bench
        cfgf, traffic = bench.config, bench.cell["traffic"]
        # fp32 sums stay fp32 (the flash backward's products of bf16-rounded
        # operands): no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = self.device = bench.device
        self.cfg = cfg = arch_config(cfgf)
        self.B, self.S, self.H = traffic["batch"], traffic["seq"], traffic["local_steps"]
        rows = traffic["pool_rows"]
        t0 = time.time()
        toks, labs = tokens.bigram_rows(bench.seed, cfg.vocab_size, rows, self.S)
        self.tokens = torch.as_tensor(toks, device=dev)
        self.labels = torch.as_tensor(labs, device=dev)
        self.row_index = torch.arange(rows, device=dev)
        self.meta = transformer.init(None, cfg, "meta")
        self.paths = [p for p, _ in glm_weights.leaf_paths(self.meta)]
        self.opt = step_lib.make_optimizer(cfg)
        self.step = StepWatch(step_lib.make_train_step(cfg, self.opt), self._read)
        self.local = gossip.make_local_steps(self.step)
        self.fresh_state()
        t1 = time.time()
        self.first_steps()
        print(f"perfbench: tokens, params and state {t1 - t0:.3f} s, the first "
              f"{SETUP_CALLS * self.H} steps and their readings {time.time() - t1:.3f} s",
              file=sys.stderr)

    def fresh_state(self):
        params = glm_weights.draw_params(self.meta, self.bench.seed, self.device)
        self.state = {"params": params, "opt": self.opt.init(params),
                      "step": torch.zeros((), dtype=torch.int32, device=self.device)}
        self.next_row = 0

    def first_steps(self):
        """Set-up's calls, through the window's own call and feed, watched."""
        self.prog = {"losses": [],
                     "numel": {p: t.numel() for p, t in glm_weights.leaf_paths(self.meta)}}
        self.step.on, self.step.k = True, 0
        for _ in range(SETUP_CALLS):
            self.unit()
        self.step.on = False
        if self.step.k < FIRST_STEPS + 1:
            raise RuntimeError(f"set-up made {self.step.k} steps, not {SETUP_CALLS * self.H}")

    def rerun(self):
        """Set-up's first calls again from fresh params and optimizer state
        (a fault planted in the step)."""
        self.state = None
        self.fresh_state()
        self.first_steps()

    def _read(self, k, state, metrics):
        if k <= FIRST_STEPS:
            self.prog["losses"].append(float(metrics["loss"]))
        if k == 1:
            b1 = self.bench.config["optimizer"]["b1"]
            self.prog["first"] = {
                path: n / (1 - b1)
                for path, n in _norms(glm_weights.leaf_paths(state["opt"]["m"])).items()}
        if k == FIRST_STEPS:
            self.prog["change"] = self._change(state["params"])

    def _batches(self, h):
        """The next h (B, S) microbatches of the pool (it wraps round when
        used up), stacked (h, B, S)."""
        n = self.tokens.shape[0]
        rows = [(self.next_row + j) % n for j in range(h * self.B)]
        self.next_row += h * self.B
        idx = self.row_index[rows[0]:rows[0] + len(rows)] if rows[-1] >= rows[0] else \
            torch.as_tensor(rows, device=self.device)
        return {"tokens": self.tokens[idx].reshape(h, self.B, self.S),
                "labels": self.labels[idx].reshape(h, self.B, self.S)}

    def _change(self, params):
        """Each leaf's change from the initial params (drawn again from the
        seed): the whole change, on the host, of a leaf of at most
        ``glm_ref.SMALL`` elements, else its norm."""
        out = {}
        for path, leaf in glm_weights.leaf_paths(params):
            init = glm_weights.draw_leaf(path, tuple(leaf.shape), self.bench.seed, self.device)
            diff = leaf - init
            out[path] = (diff.cpu() if diff.numel() <= glm_ref.SMALL
                         else float(diff.double().norm()))
            del init, diff
        return out

    def unit(self):
        batches = self._batches(self.H)
        self.state, _ = self.local(self.state, batches)
        return {"units": 1, "steps": self.H, "tokens": self.H * self.B * self.S}

    def release(self):
        self.state = self.local = self.step = None

    # ---------------------------------------------------------------- check
    def reference(self, operands=None):
        """The reference's losses, first grad norms and changes."""
        cfgf, cfg = self.bench.config, self.cfg
        rcfg = {"num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
                "num_kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
                "d_model": cfg.d_model, "rope": cfg.rope, "rope_theta": cfg.rope_theta,
                "leaf_paths": self.paths}
        shapes = {p: tuple(t.shape) for p, t in glm_weights.leaf_paths(self.meta)}
        seed, dev = self.bench.seed, self.device

        def draw(path):
            return glm_weights.draw_leaf(path, shapes[path], seed, dev)

        with precision():
            model = glm_ref.Model(rcfg, draw)
            batches = []
            for k in range(FIRST_STEPS):      # the rows set-up's calls fed them
                rows = slice(k * self.B, (k + 1) * self.B)
                batches.append((self.tokens[rows], self.labels[rows]))
            losses, first, first_small = glm_ref.train(model, batches, cfgf["optimizer"],
                                                       operands)
            change = {}
            for path, ts in model.leaves():
                init = draw(path)
                if path in first_small:
                    change[path] = glm_ref.stacked(ts) - init.cpu()
                elif path[0] == "units":
                    change[path] = math.sqrt(sum(
                        float((t.detach() - init[i]).double().square().sum())
                        for i, t in enumerate(ts)))
                else:
                    change[path] = float((ts[0].detach() - init).double().norm())
                del init
        del model
        return {"losses": losses, "first": first, "first_small": first_small,
                "change": change, "numel": {p: math.prod(shapes[p]) for p in shapes}}

    def check(self, ref=None):
        t0 = time.time()
        ref = ref or self.reference()
        print(f"perfbench: the reference {time.time() - t0:.3f} s", file=sys.stderr)
        got = self.prog
        values = compare(got, ref)
        limits = self.bench.cell["check"]["limits"]
        return [(k, values[k], limits[k]) for k in ("loss_gap", "grad_gap", "change_gap")]


def compare(got, ref):
    """The three numbers: the worst step's relative loss gap; the worst
    leaf's gap of first-gradient norms and of changes over the steps, each
    against the larger of the leaf's reference norm and the median leaf's.

    Parts whose reference gradient is nought to rounding move under AdamW
    by round-off alone, so the change leaves them out: a leaf whose first
    gradient's norm is under a thousandth of the median leaf's, and, in
    the leaves kept whole (biases, norms), each element whose first
    gradient is under a thousandth of the median leaf's RMS gradient (the
    key bias's unrotated half, which the softmax cannot see)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    med_g = statistics.median(ref["first"].values())
    grad_gap = max(abs(got["first"][p] - g) / max(g, med_g) for p, g in ref["first"].items())
    moved = [p for p, g in ref["first"].items() if g >= 1e-3 * med_g]
    rms = {p: g / math.sqrt(ref["numel"][p]) for p, g in ref["first"].items()}
    thr = 1e-3 * statistics.median(rms.values())

    def norm(change, path):
        c = change[path]
        if isinstance(c, float):
            return c
        keep = ref["first_small"][path].abs() >= thr
        return float(c[keep].double().norm())

    pairs = {p: (norm(got["change"], p), norm(ref["change"], p)) for p in moved}
    med_c = statistics.median(r for _, r in pairs.values())
    change_gap = max(abs(g - r) / max(r, med_c) for g, r in pairs.values())
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def setup(bench):
    return LocalStepsRun(bench)
