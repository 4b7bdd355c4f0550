"""A mixture-of-experts LM node's local training: the H local steps a DFL
node runs between gossip rounds, ``repro_torch.core.gossip.make_local_steps(
repro_torch.train.step.make_train_step(cfg))``, one call a unit, for a
configuration with the dropless, sigmoid-routed expert layer (Trinity-Mini's
AFMoE) holding its chip's share of the experts.

As ``lm_local_steps`` (whose watch and comparison it uses): set-up draws the
fp32 params on the card from the seed (``gen.glm_weights``), builds the
program's training state (AdamW state, step counter and the expert bias,
zeros) and drives it through two of the window's own calls, H = 2 steps
each; the first three steps are the ones the reference follows. Besides
the loss, the first gradients' norms and the changes, the watch keeps
each MoE layer's routing choices of those three steps (the first
forward's, on the card, from a wrapper the entry puts round the program's
``moe.sigmoid_route``) and the expert bias after the third. Every step's
``expert_load`` (a metric of the program's train step) is added to
counters on the card (``RouteCounters``: held and other slots, dropped
pairs, the load ratio), read once a unit, off the step's path.

The check: the reference (``reference.afmoe``, fp32, TF32 off) draws the
same initial params and takes the same three steps, routed by the
program's choices; ``route_off`` counts the choices that lie more than the
cell's ``route_margin`` under the reference's own k-th score (within it,
rounding decides the tie); ``bias_gap`` is the largest difference of the
expert bias after three steps, in units of the bias's step; ``dropped`` the
pairs the run's steps routed to a held expert and did not compute.

The configuration's ``arch`` (with its ``moe`` group) must name only
fields the program's ``ArchConfig`` and ``MoEConfig`` have: a program
that lacks one cannot build this model, and set-up stops at once.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time

import torch

from perfbench.entries.lm_local_steps import FIRST_STEPS, SETUP_CALLS, StepWatch, compare
from perfbench.gen import glm_weights, tokens
from perfbench.reference import afmoe
from perfbench.reference import precision


def arch_config(config: dict):
    """The program's ArchConfig of the configuration's ``arch``; SystemExit
    where the program lacks a field it names."""
    from repro_torch.configs.base import ArchConfig, MoEConfig
    arch = dict(config["arch"])
    moe = dict(arch.pop("moe"))
    for cls, kw in ((ArchConfig, arch), (MoEConfig, moe)):
        missing = sorted(set(kw) - {f.name for f in dataclasses.fields(cls)})
        if missing:
            raise SystemExit(f"the program's {cls.__name__} has no {', '.join(missing)}: "
                             f"it cannot build {config['name']}")
    moe["held"] = tuple(moe["held"])
    for key in ("block_pattern", "rope_kinds"):
        arch[key] = tuple(arch[key])
    return ArchConfig(**arch, moe=MoEConfig(**moe))


def reference_config(cfg, paths) -> dict:
    """``reference.afmoe``'s configuration of the program's ``cfg``."""
    m = cfg.moe
    ul = len(cfg.block_pattern)              # interleave 1: a unit is a period
    return {"num_layers": cfg.num_layers, "d_model": cfg.d_model,
            "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
            "head_dim": cfg.resolved_head_dim, "window": cfg.window,
            "rope_theta": cfg.rope_theta, "norm_eps": cfg.norm_eps,
            "kinds": cfg.layer_kinds(), "first_dense": m.first_dense, "unit_len": ul,
            "moe": {"num_experts": m.num_experts, "top_k": m.top_k,
                    "held": list(m.held_range), "route_scale": m.route_scale,
                    "bias_rate": m.bias_rate},
            "leaf_paths": paths}


class ChoiceTap:
    """Keeps, while ``on``, the first ``layers`` routing calls of each step
    (the forward's, in layer order; the remat recompute's come after), as
    uint8 on the card."""

    def __init__(self, layers):
        self.layers, self.on, self.steps = layers, False, []

    def new_step(self):
        if self.on:
            self.steps.append([])

    def __call__(self, choices):
        if self.on and self.steps and len(self.steps[-1]) < self.layers:
            self.steps[-1].append(choices.to(torch.uint8))

    def wrap(self, route):
        """``route`` (``moe.sigmoid_route``) passing its choices here."""
        def tapped(*args, **kwargs):
            w, choices = route(*args, **kwargs)
            self(choices)
            return w, choices
        return tapped


class RouteCounters:
    """Sums over the steps' dropless MoE layers, kept on the card: ``add``
    takes a step's ``expert_load`` (MoE layers, num_experts + 1) and
    launches a few kernels, never waiting on the host; ``read`` copies the
    sums out once (one host sync) and starts again. Per (step, layer): the
    (token, choice) pairs routed to held experts, routed elsewhere, and
    dropped (|pairs routed to held experts - rows the grouped products
    computed|: a pair lost, or one computed that no token routed there),
    and the largest held expert's load over the held experts' mean."""

    FIELDS = ("held_slots", "other_slots", "dropped", "layer_steps", "load_ratio_sum")

    def __init__(self, held):
        self.held, self.sums = held, None

    def add(self, load):
        lo, hi = self.held
        n = load.to(torch.float64)
        mine = n[:, lo:hi]
        held_sum = mine.sum()
        ratio = mine.amax(-1) / mine.mean(-1).clamp_min(1e-30)
        v = torch.stack([held_sum, n[:, :-1].sum() - held_sum,
                         (mine.sum(-1) - n[:, -1]).abs().sum(),
                         torch.full((), n.shape[0], dtype=torch.float64, device=n.device),
                         ratio.sum()])
        self.sums = v if self.sums is None else self.sums.add_(v)

    def read(self) -> dict:
        out = dict.fromkeys(self.FIELDS, 0.0) if self.sums is None else \
            dict(zip(self.FIELDS, self.sums.tolist()))
        self.sums = None
        return out


class MoeLocalStepsRun:
    def __init__(self, bench):
        self.bench = bench
        self.cfg = cfg = arch_config(bench.config)     # first: a program without the
        from repro_torch.core import gossip              # fields stops here
        from repro_torch.models import moe as moe_lib
        from repro_torch.models import transformer
        from repro_torch.train import step as step_lib
        self.moe_lib, self.transformer = moe_lib, transformer
        traffic = bench.cell["traffic"]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = self.device = bench.device
        self.B, self.S, self.H = traffic["batch"], traffic["seq"], traffic["local_steps"]
        rows = traffic["pool_rows"]
        t0 = time.time()
        toks, labs = tokens.bigram_rows(bench.seed, cfg.vocab_size, rows, self.S)
        self.tokens = torch.as_tensor(toks, device=dev)
        self.labels = torch.as_tensor(labs, device=dev)
        self.row_index = torch.arange(rows, device=dev)
        self.meta = transformer.init(None, cfg, "meta")
        self.paths = [p for p, _ in glm_weights.leaf_paths(self.meta)]
        self.n_moe = transformer.moe_layers(cfg)
        self.tap = ChoiceTap(self.n_moe)
        self.routes = RouteCounters(cfg.moe.held_range)
        self.dropped = 0.0           # over set-up's and the window's steps
        self.route = moe_lib.sigmoid_route             # the program's own
        moe_lib.sigmoid_route = self.tap.wrap(self.route)
        self.opt = step_lib.make_optimizer(cfg)
        self.step = StepWatch(self._stepped(step_lib.make_train_step(cfg, self.opt)),
                              self._read)
        self.local = gossip.make_local_steps(self.step)
        self.fresh_state()
        t1 = time.time()
        self.first_steps()
        print(f"perfbench: tokens, params and state {t1 - t0:.3f} s, the first "
              f"{SETUP_CALLS * self.H} steps and their readings {time.time() - t1:.3f} s",
              file=sys.stderr)

    def _stepped(self, fn):
        def step(state, batch):
            self.tap.new_step()
            state, metrics = fn(state, batch)
            self.routes.add(metrics["expert_load"])
            return state, metrics
        return step

    def fresh_state(self):
        params = glm_weights.draw_params(self.meta, self.bench.seed, self.device)
        self.state = {"params": params, "opt": self.opt.init(params),
                      "step": torch.zeros((), dtype=torch.int32, device=self.device),
                      "expert_bias": self.transformer.init_expert_bias(self.cfg, self.device)}
        self.next_row = 0

    def first_steps(self):
        """Set-up's calls, through the window's own call and feed, watched."""
        self.prog = {"losses": [],
                     "numel": {p: t.numel() for p, t in glm_weights.leaf_paths(self.meta)}}
        self.step.on, self.step.k = True, 0
        self.tap.on, self.tap.steps = True, []
        for _ in range(SETUP_CALLS):
            self.unit()
        self.step.on = self.tap.on = False
        self.tap.steps = self.tap.steps[:FIRST_STEPS]
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
                path: float(t.double().norm()) / (1 - b1)
                for path, t in glm_weights.leaf_paths(state["opt"]["m"])}
        if k == FIRST_STEPS:
            self.prog["change"] = self._change(state["params"])
            self.prog["bias"] = state["expert_bias"].cpu().clone()

    def _batches(self, h):
        n = self.tokens.shape[0]
        rows = [(self.next_row + j) % n for j in range(h * self.B)]
        self.next_row += h * self.B
        idx = self.row_index[rows[0]:rows[0] + len(rows)] if rows[-1] >= rows[0] else \
            torch.as_tensor(rows, device=self.device)
        return {"tokens": self.tokens[idx].reshape(h, self.B, self.S),
                "labels": self.labels[idx].reshape(h, self.B, self.S)}

    def _change(self, params):
        out = {}
        for path, leaf in glm_weights.leaf_paths(params):
            init = glm_weights.draw_leaf(path, tuple(leaf.shape), self.bench.seed, self.device)
            diff = leaf - init
            out[path] = (diff.cpu() if diff.numel() <= afmoe.SMALL
                         else float(diff.double().norm()))
            del init, diff
        return out

    def unit(self):
        batches = self._batches(self.H)
        self.state, _ = self.local(self.state, batches)
        routes = self.routes.read()                # one host read a unit
        self.dropped += routes["dropped"]
        return {"units": 1, "steps": self.H, "tokens": self.H * self.B * self.S, **routes}

    def release(self):
        self.state = self.local = self.step = None
        self.moe_lib.sigmoid_route = self.route          # the program's own again

    # ---------------------------------------------------------------- check
    def reference(self, operands=None):
        """The reference's three steps, routed by the program's choices."""
        cfgf, cfg = self.bench.config, self.cfg
        shapes = {p: tuple(t.shape) for p, t in glm_weights.leaf_paths(self.meta)}
        seed, dev = self.bench.seed, self.device
        margin = self.bench.cell["check"]["route_margin"]

        def draw(path):
            return glm_weights.draw_leaf(path, shapes[path], seed, dev)

        with precision():
            model = afmoe.Model(reference_config(cfg, self.paths), draw)
            batches = []
            for k in range(FIRST_STEPS):      # the rows set-up's calls fed them
                rows = slice(k * self.B, (k + 1) * self.B)
                batches.append((self.tokens[rows], self.labels[rows]))
            out = afmoe.train(model, batches, cfgf["optimizer"], operands,
                              self.tap.steps, margin)
            change = {}
            for path, ts in model.leaves():
                init = draw(path)
                if path in out["first_small"]:
                    change[path] = afmoe.stacked(path, ts) - init.cpu()
                elif path[0] == "units":
                    change[path] = math.sqrt(sum(
                        float((t.detach() - init[i]).double().square().sum())
                        for i, t in enumerate(ts)))
                else:
                    change[path] = float((ts[0].detach() - init).double().norm())
                del init
        del model
        out.update(change=change, numel={p: math.prod(shapes[p]) for p in shapes})
        return out

    def check(self, ref=None):
        t0 = time.time()
        ref = ref or self.reference()
        print(f"perfbench: the reference {time.time() - t0:.3f} s (route_lag "
              f"{ref['route_lag']:.6g})", file=sys.stderr)
        values = gaps(self.prog, ref, self.cfg.moe.bias_rate)
        values["dropped"] = self.dropped
        limits = self.bench.cell["check"]["limits"]
        return [(k, values[k], limits[k]) for k in
                ("loss_gap", "grad_gap", "change_gap", "route_off", "bias_gap", "dropped")]


def gaps(prog, ref, rate):
    """``lm_local_steps.compare``'s three numbers, ``route_off`` and
    ``bias_gap`` (the largest difference of the bias after three steps,
    over the bias's step ``rate``)."""
    values = compare(prog, ref)
    values["route_off"] = float(ref["route_off"])
    values["bias_gap"] = float((prog["bias"] - ref["bias"]).abs().max()) / rate
    return values


def setup(bench):
    return MoeLocalStepsRun(bench)
