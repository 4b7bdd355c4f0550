"""Step factories: train_step / prefill / decode and the training state (the
JAX package's ``repro.train.step``).

The step is functional in form, ``(state, batch) -> (state, metrics)``, as
in JAX, with one difference: it writes the new params and optimizer state
into the tensors of the state it is given and returns them (the JAX
launcher donates the state, ``donate_argnums=(0,)``; at llama3-8b scale a
second copy would not fit beside the first). Pass each state once.

The abstract-struct and sharding helpers of the JAX module
(``abstract_params``, ``abstract_cache``, ``opt_state_axes``,
``input_specs``, ``batch_axes``, ``rules_for``, ``state_shardings``,
``batch_shardings``, ``abstract_train_state``) serve the XLA dry-run
lowering; they come with ``sharding.py`` (ROADMAP.md queue 1, 'CLI and
the rest').
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim import schedules


# --------------------------------------------------------------- step factories
def make_lr_fn(cfg: ArchConfig, total_steps: int = 100_000):
    peak = 3e-4 if cfg.optimizer != "adafactor" else 1e-3
    return schedules.warmup_cosine(peak, 2_000, total_steps)


def make_optimizer(cfg: ArchConfig, total_steps: int = 100_000):
    return opt_lib.make_optimizer(cfg.optimizer, make_lr_fn(cfg, total_steps))


def loss_and_grads(params, cfg, batch):
    """(loss, metrics, grads) of ``transformer.train_loss`` at ``params``
    (which it leaves as they are); the grads are fp32, shaped as the
    params, and zero for a leaf the loss does not use (the token table of
    an audio model, which takes frame embeddings), as JAX's are."""
    leaves = [x.detach().requires_grad_() for x in tree.leaves(params)]
    loss, metrics = transformer.train_loss(tree.unflatten(params, leaves), cfg,
                                           batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree.unflatten(params, grads)


def make_train_step(cfg: ArchConfig, opt: Optional[opt_lib.Optimizer] = None,
                    grad_clip: float = 1.0):
    opt = opt or make_optimizer(cfg)
    accum = max(1, cfg.accum_steps)

    def train_step(state, batch):
        if accum == 1:
            _, metrics, grads = loss_and_grads(state["params"], cfg, batch)
        else:
            # microbatch over the batch dim: live activations shrink accum x
            n = torch.tensor(float(accum))
            grads = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state["params"])
            metrics = None
            for a in range(accum):
                mb = tree.map(lambda x, a=a: x.reshape(
                    accum, x.shape[0] // accum, *x.shape[1:])[a], batch)
                _, m, g = loss_and_grads(state["params"], cfg, mb)
                grads = tree.map(lambda acc, x: acc.add_(x.to(torch.float32)), grads, g)
                m = {k: v / n.to(v.device) for k, v in m.items()}
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
            grads = tree.map(lambda g: g / n.to(g.device), grads)
        grads, gnorm = opt_lib.clip_by_global_norm(grads, grad_clip)
        updates, opt_state = opt.update(grads, state["opt"], state["params"],
                                        state["step"])
        del grads
        params = opt_lib.apply_updates(state["params"], updates)
        metrics = dict(metrics, grad_norm=gnorm)
        return ({"params": params, "opt": opt_state, "step": state["step"] + 1},
                metrics)

    return train_step


def make_prefill(cfg: ArchConfig):
    def prefill_step(params, batch, cache):
        return transformer.prefill(params, cfg, batch, cache)

    return prefill_step


def make_decode(cfg: ArchConfig):
    def decode_step(params, cache, tokens, position):
        return transformer.decode_step(params, cfg, tokens, cache, position)

    return decode_step


def init_train_state(cfg: ArchConfig, generator, opt: Optional[opt_lib.Optimizer] = None,
                     device="cuda"):
    """Concrete state: params drawn from ``generator`` (a ``torch.Generator``
    on ``device``), the optimizer's fp32 state, and the step counter (an
    int32 0-d tensor)."""
    dev = device_lib.resolve(device)
    opt = opt or make_optimizer(cfg)
    params = transformer.init(generator, cfg, dev)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
