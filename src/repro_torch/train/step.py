"""Step factories: train_step / prefill / decode and the training state (the
JAX package's ``repro.train.step``).

The step is functional in form, ``(state, batch) -> (state, metrics)``, as
in JAX, with one difference: it writes the new params and optimizer state
into the tensors of the state it is given and returns them (the JAX
launcher donates the state, ``donate_argnums=(0,)``; at llama3-8b scale a
second copy would not fit beside the first). Pass each state once.

The abstract helpers (``abstract_params``, ``abstract_cache``,
``abstract_train_state``, ``input_specs``) build a cell's inputs on the
meta device: shapes and dtypes, nothing drawn and nothing allocated (the
JAX module's ``ShapeDtypeStruct``s). ``opt_state_axes``, ``batch_axes``,
``rules_for``, ``state_shardings`` and ``batch_shardings`` give their
logical axes and, against a mesh, their spec trees (``sharding``); the
dry-run cell report (``launch.dryrun``) reads both.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch import sharding as sh
from repro_torch import tree
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.spans import span
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim import schedules


# --------------------------------------------------------------- step factories
def make_lr_fn(cfg: ArchConfig, total_steps: int = 100_000):
    peak = 3e-4 if cfg.optimizer != "adafactor" else 1e-3
    return schedules.warmup_cosine(peak, 2_000, total_steps)


def make_optimizer(cfg: ArchConfig, total_steps: int = 100_000):
    return opt_lib.make_optimizer(cfg.optimizer, make_lr_fn(cfg, total_steps))


def loss_and_grads(params, cfg, batch, expert_bias=None):
    """(loss, metrics, grads) of ``transformer.train_loss`` at ``params``
    (which it leaves as they are); the grads are fp32, shaped as the
    params, and zero for a leaf the loss does not use (the token table of
    an audio model, which takes frame embeddings), as JAX's are."""
    leaves = [x.detach().requires_grad_() for x in tree.leaves(params)]
    with span("dfl.train.forward"):
        loss, metrics = transformer.train_loss(tree.unflatten(params, leaves), cfg,
                                               batch, expert_bias)
    with span("dfl.train.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree.unflatten(params, grads)


def make_train_step(cfg: ArchConfig, opt: Optional[opt_lib.Optimizer] = None,
                    grad_clip: float = 1.0):
    """``train_step(state, batch) -> (state, metrics)``. A config with the
    dropless sigmoid router keeps its expert bias in ``state[
    "expert_bias"]`` (``init_train_state``): it routes the step's forward
    and, after the optimizer, moves toward an even load
    (``moe.update_expert_bias``: no gradient, clipping, decay or AdamW), on
    the device; the metrics keep the step's ``expert_load``."""
    opt = opt or make_optimizer(cfg)
    accum = max(1, cfg.accum_steps)

    def train_step(state, batch):
        bias = state.get("expert_bias")
        with span("dfl.train.step"):
            if accum == 1:
                _, metrics, grads = loss_and_grads(state["params"], cfg, batch, bias)
            else:
                # microbatch over the batch dim: live activations shrink accum x
                n = torch.tensor(float(accum))
                grads = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), state["params"])
                metrics = None
                for a in range(accum):
                    mb = tree.map(lambda x, a=a: x.reshape(
                        accum, x.shape[0] // accum, *x.shape[1:])[a], batch)
                    _, m, g = loss_and_grads(state["params"], cfg, mb, bias)
                    grads = tree.map(lambda acc, x: acc.add_(x.to(torch.float32)), grads, g)
                    m = {k: v / n.to(v.device) for k, v in m.items()}
                    metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
                grads = tree.map(lambda g: g / n.to(g.device), grads)
            params, opt_state, gnorm = opt.apply(grads, state["opt"], state["params"],
                                                 state["step"], grad_clip)
            metrics = dict(metrics, grad_norm=gnorm)
            new = dict(state, params=params, opt=opt_state, step=state["step"] + 1)
            load = metrics.get("expert_load")
            if bias is not None and load is not None:
                with span("dfl.train.expert_bias"):
                    moe_lib.update_expert_bias(bias, load, cfg.moe.bias_rate)
            return new, metrics

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
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    bias = transformer.init_expert_bias(cfg, dev)
    if bias is not None:
        state["expert_bias"] = bias
    return state


# ------------------------------------------------------------ abstract inputs
META = torch.device("meta")


def abstract_params(cfg: ArchConfig):
    """(params on the meta device, their logical axes): fp32, as ``init``
    stores them, without drawing or allocating anything."""
    return transformer.init(None, cfg, META), transformer.param_axes(cfg)


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int):
    """(the ``cache_init`` tree on the meta device, its logical axes)."""
    return (transformer.cache_init(cfg, batch, max_seq, META),
            transformer.cache_axes(cfg))


def opt_state_axes(opt_name: str, params_axes, params):
    """Logical axes for optimizer state, mirroring the param axes."""
    if opt_name == "adamw":
        return {"m": params_axes, "v": params_axes}
    if opt_name == "sgdm":
        return {"mu": params_axes}
    if opt_name == "adafactor":
        def leaf(a, p):
            if len(p.shape) >= 2:
                return {"vr": tuple(a[:-1]), "vc": tuple(a[:-2]) + (a[-1],)}
            return {"v": a}

        return {"v": tree.map(leaf, params_axes, params, is_leaf=sh.is_axes)}
    raise KeyError(opt_name)


def input_specs(cfg: ArchConfig, shape: InputShape, batch: Optional[int] = None,
                seq: Optional[int] = None):
    """Meta stand-ins for every model input of a cell: int32 tokens and
    labels, bf16 frame / patch embeddings, an fp32 loss mask. ``batch`` and
    ``seq`` override the shape's global batch and sequence length (a
    device's share)."""
    B = shape.global_batch if batch is None else batch
    S = shape.seq_len if seq is None else seq

    def t(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=META)

    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "decode":
        return {"tokens": t((B, 1), i32)}
    if cfg.frontend == "audio":
        batch_ = {"frame_embeds": t((B, S, cfg.d_model), bf16)}
        if shape.kind == "train":
            batch_["labels"] = t((B, S), i32)
            batch_["loss_mask"] = t((B, S), torch.float32)
        return batch_
    batch_ = {"tokens": t((B, S), i32)}
    if shape.kind == "train":
        batch_["labels"] = t((B, S), i32)
    if cfg.frontend == "vision":
        batch_["patch_embeds"] = t((B, cfg.num_patch_tokens, cfg.d_model), bf16)
    return batch_


def batch_axes(cfg: ArchConfig, shape: InputShape):
    specs = {
        "tokens": (sh.BATCH, sh.SEQ),
        "labels": (sh.BATCH, sh.SEQ),
        "loss_mask": (sh.BATCH, sh.SEQ),
        "frame_embeds": (sh.BATCH, sh.SEQ, None),
        "patch_embeds": (sh.BATCH, None, None),
    }
    return {k: specs[k] for k in input_specs(cfg, shape, 1, 1)}


def abstract_train_state(cfg: ArchConfig):
    """(the training state on the meta device, its logical axes)."""
    params, p_axes = abstract_params(cfg)
    opt = make_optimizer(cfg)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=META)}
    axes = {"params": p_axes,
            "opt": opt_state_axes(cfg.optimizer, p_axes, params), "step": ()}
    bias = transformer.init_expert_bias(cfg, META)
    if bias is not None:
        state["expert_bias"], axes["expert_bias"] = bias, (None, L.EXPERTS)
    return state, axes


# ------------------------------------------------------------------- shardings
def rules_for(cfg: ArchConfig, shape: InputShape) -> dict:
    rules = sh.make_rules(fsdp=cfg.fsdp)
    if shape.kind == "decode":
        # KV cache sequence dim: prefer data (frees when batch < data axis),
        # else model (flash-decoding style sequence parallelism).
        rules[sh.KV_SEQ] = (("data",), ("model",))
    return rules


def state_shardings(state, axes, mesh, rules):
    return sh.tree_specs(axes, mesh, rules, state)


def batch_shardings(cfg, shape, batch, mesh, rules):
    return sh.tree_specs(batch_axes(cfg, shape), mesh, rules, batch)
