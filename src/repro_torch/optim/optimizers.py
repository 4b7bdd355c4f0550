"""Optimizers in the optax style (init/update pairs) over the port's trees
(``repro_torch.tree``), the JAX package's ``repro.optim.optimizers``:

    opt = make_optimizer(name, lr_fn, **hp)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

State is fp32 whatever the params' dtype. Unlike the JAX functions, which
return new arrays, ``update`` writes the new moments into the state's
tensors (AdamW also writes its updates into the grads' tensors),
``apply_updates`` adds the updates into the params' tensors and
``clip_by_global_norm`` scales the grads in place (at llama3-8b scale a
second copy of the params, grads and AdamW state would not fit beside the
first): what is passed in is consumed, as the JAX launcher donates the
state (``donate_argnums=(0,)``). The
arithmetic is the JAX functions', operation for operation; every quotient
divides by an fp32 tensor (a CUDA division by a Python scalar multiplies by
its reciprocal).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, state)


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step_f32(step):
    return torch.as_tensor(step).to(torch.float32)


def _mean(x, dim, keepdim=False):
    """``jnp.mean``: the sum over ``dim`` divided by its length."""
    n = torch.tensor(float(x.shape[dim]), dtype=torch.float32, device=x.device)
    return x.sum(dim, keepdim=keepdim) / n


def apply_updates(params, updates):
    """``params + updates`` in each param's dtype, written into ``params``."""
    def leaf(p, u):
        if p.dtype == u.dtype:
            return p.add_(u)
        return p.copy_((p + u).to(p.dtype))

    return tree.map(leaf, params, updates)


def global_norm(tree_):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.leaves(tree_)))


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to a global norm of at most ``max_norm``, the norm);
    the grads are scaled in place."""
    norm = global_norm(grads)
    scale = torch.clamp_max(
        torch.tensor(float(max_norm), device=norm.device) / torch.clamp_min(norm, 1e-9),
        1.0)
    return tree.map(lambda g: g.mul_(scale), grads), norm


# ----------------------------------------------------------------- sgd+momentum
def sgd_momentum(lr_fn, momentum=0.9, weight_decay=0.0):
    def init(params):
        return {"mu": tree.map(_zeros32, params)}

    def update(grads, state, params, step):
        lr = lr_fn(step)
        mu = tree.map(lambda m, g: m.mul_(momentum).add_(g.to(torch.float32)),
                      state["mu"], grads)
        upd = tree.map(
            lambda m, p: -lr * (m + weight_decay * p.to(torch.float32)), mu, params)
        return upd, {"mu": mu}

    return Optimizer("sgdm", init, update)


# ------------------------------------------------------------------------ adamw
def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    def init(params):
        return {"m": tree.map(_zeros32, params), "v": tree.map(_zeros32, params)}

    def update(grads, state, params, step):
        lr = lr_fn(step)
        t = _step_f32(step) + 1.0
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def leaf(g, m, v, p):
            g = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            # -lr * (mhat / (sqrt(vhat) + eps) + wd * p), op by op, written
            # into the (consumed) grad: one leaf's temporaries at a time
            upd = torch.div(m, bc1, out=g)
            upd.div_(torch.div(v, bc2).sqrt_().add_(eps))
            upd.add_(weight_decay * p.to(torch.float32))
            return upd.mul_(-lr)

        upd = tree.map(leaf, grads, state["m"], state["v"], params)
        return upd, state

    return Optimizer("adamw", init, update)


# -------------------------------------------------------------------- adafactor
def _is_state_leaf(x):
    """One param's adafactor state: ``{"vr", "vc"}`` or ``{"v"}``."""
    return (isinstance(x, dict) and set(x) in ({"vr", "vc"}, {"v"})
            and all(isinstance(t, torch.Tensor) for t in x.values()))


def adafactor(lr_fn, decay=0.8, eps=1e-30, clip_threshold=1.0):
    """Factored second moments for >=2D params (memory: O(n+m) vs O(n*m));
    used by the >=35B configs so optimizer state fits per-device memory."""

    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def leaf(p):
            if _factored(p.shape):
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                      device=p.device),
                }
            return {"v": _zeros32(p)}

        return {"v": tree.map(leaf, params)}

    def update(grads, state, params, step):
        t = _step_f32(step) + 1.0
        beta = 1.0 - t ** -decay
        lr = lr_fn(step)

        def leaf(g, s, p):
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if _factored(p.shape):
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * _mean(g2, -1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * _mean(g2, -2))
                denom = torch.clamp_min(_mean(s["vr"], -1, keepdim=True), eps)
                v = (s["vr"][..., None] * s["vc"][..., None, :]) / denom[..., None]
            else:
                v = s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
            u = g * torch.rsqrt(v + eps)
            # update clipping (RMS)
            rms = torch.sqrt(_mean(torch.square(u).reshape(-1), 0) + 1e-12)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            return -lr * u

        gl, pl = tree.leaves(grads), tree.leaves(params)
        sl = tree.leaves(state["v"], is_leaf=_is_state_leaf)
        upd = [leaf(g, s, p) for g, s, p in zip(gl, sl, pl, strict=True)]
        return tree.unflatten(params, upd), state

    return Optimizer("adafactor", init, update)


_FACTORIES = {"sgdm": sgd_momentum, "adamw": adamw, "adafactor": adafactor}


def make_optimizer(name, lr_fn, **hp) -> Optimizer:
    if name not in _FACTORIES:
        raise KeyError(f"unknown optimizer {name!r}")
    return _FACTORIES[name](lr_fn, **hp)
