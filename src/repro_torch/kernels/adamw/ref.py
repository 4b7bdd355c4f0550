"""Plain PyTorch version of the clip and AdamW kernels, one PyTorch op at a
time, as the JAX package's ``repro.optim.optimizers`` writes it: the norm
and the clip scale are ``repro_torch.optim.optimizers``' own, the AdamW
leaf step is the op-by-op code that ``optimizers.adamw``'s ``update`` runs.

Every quotient divides by an fp32 tensor (a CUDA division by a Python
scalar multiplies by its reciprocal). ``adamw_step`` leaves g as it is, as
the kernel does: it scales a copy.
"""
from __future__ import annotations

import torch

from repro_torch.optim import optimizers as opt_lib


def grad_norm(leaves, max_norm):
    """(the global norm of ``leaves``, the clip scale for ``max_norm``)."""
    norm = opt_lib.global_norm(leaves)
    return norm, opt_lib.clip_scale(norm, max_norm)


def adamw_update(g, m, v, p, lr, bc1, bc2, *, b1, b2, eps, weight_decay):
    """One leaf's AdamW update ``-lr * (mhat / (sqrt(vhat) + eps) + wd * p)``;
    the moments are written into ``m`` and ``v``, the update into ``g``."""
    g = g.to(torch.float32)
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * torch.square(g))
    # -lr * (mhat / (sqrt(vhat) + eps) + wd * p), op by op, written
    # into the (consumed) grad: one leaf's temporaries at a time
    upd = torch.div(m, bc1, out=g)
    upd.div_(torch.div(v, bc2).sqrt_().add_(eps))
    upd.add_(weight_decay * p.to(torch.float32))
    return upd.mul_(-lr)


def adamw_step(g, m, v, p, scale, lr, bc1, bc2, **hp):
    """The AdamW step of one leaf on ``g * scale``, added into ``p``; m and v
    written in place, g left as it is (``hp``: b1, b2, eps, weight_decay)."""
    return opt_lib.apply_updates(p, adamw_update(g * scale, m, v, p, lr, bc1, bc2, **hp))
