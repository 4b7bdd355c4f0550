"""Learning-rate schedules (step -> fp32 0-d tensor), the JAX package's
``repro.optim.schedules``. ``step`` is an int or a 0-d tensor; the result
lies on the step's device. Every quotient divides by an fp32 tensor: a
CUDA division by a Python scalar multiplies by its reciprocal, which can
differ from the JAX division in the last bit."""
from __future__ import annotations

import math

import torch


def _f32(step):
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def _const(x, like):
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def constant(lr):
    return lambda step: _const(lr, _f32(step))


def warmup_cosine(peak_lr, warmup_steps, total_steps, final_frac=0.1):
    def fn(step):
        s = _f32(step)
        warm = peak_lr * torch.clamp_max(
            (s + 1.0) / _const(max(1, warmup_steps), s), 1.0)
        frac = torch.clamp((s - warmup_steps)
                           / _const(max(1, total_steps - warmup_steps), s), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup_steps, warm, cos)

    return fn


def caffe_inv(base_lr, gamma=1e-4, power=0.75):
    """Caffe 'inv' policy — the paper's LeNet solver (§VI-D)."""
    def fn(step):
        s = _f32(step)
        return base_lr * (1.0 + gamma * s) ** (-power)

    return fn
