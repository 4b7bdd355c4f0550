"""Shared building blocks of the language models (params as dicts of tensors).

Port of the JAX package's ``models/layers.py`` with its layouts: a dense
weight is (in, *out), an embedding table (vocab, d_model). Params are fp32
(master weights); products run in the activation dtype, each weight cast to
it at use (``transformer.cast_params`` makes that cast once up front, which
gives the same numbers). ``lead`` is a tuple of leading dims for stacked
layers: ``lead=(n,)`` draws n independent layers in one tensor per leaf.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_pt = torch.float32  # params kept fp32 (master weights); compute casts


def truncated_normal(generator, shape, scale, device):
    """``scale / sqrt(shape[-1])`` times a standard normal truncated to
    [-2, 2], as the JAX package's ``truncated_normal``."""
    stddev = scale / max(1.0, np.sqrt(shape[-1] if len(shape) else 1))
    return _trunc(generator, shape, stddev, device)


def _trunc(generator, shape, stddev, device):
    t = torch.empty(shape, dtype=_pt, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(stddev)


def dense_init(generator, in_dim, out_dims, *, use_bias, device, lead=()):
    """Weight (*lead, in_dim, *out_dims) with fan-in scaled init."""
    p = {"w": _trunc(generator, (*lead, in_dim, *out_dims), 1 / np.sqrt(in_dim),
                     device)}
    if use_bias:
        p["b"] = torch.zeros((*lead, *out_dims), dtype=_pt, device=device)
    return p


def dense_apply(p, x, *, contract_dims=1):
    """x @ w (+ b). Contracts the last `contract_dims` dims of x with the
    first `contract_dims` dims of w."""
    w = p["w"].to(x.dtype)
    k = contract_dims
    n_in = int(np.prod(w.shape[:k]))
    y = x.reshape(*x.shape[:-k], n_in) @ w.reshape(n_in, -1)
    y = y.reshape(*x.shape[:-k], *w.shape[k:])
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# --------------------------------------------------------------------------- norm
def norm_init(d, kind, use_bias, device, lead=()):
    p = {"scale": torch.ones((*lead, d), dtype=_pt, device=device)}
    if kind == "layernorm" and use_bias:
        p["bias"] = torch.zeros((*lead, d), dtype=_pt, device=device)
    return p


def norm_apply(p, x, kind, eps=1e-6):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    else:  # layernorm
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------- mlp
def mlp_init(generator, d_model, d_ff, use_bias, device, lead=()):
    """SwiGLU MLP: gate/up (d, ff) x2, down (ff, d)."""
    kw = dict(use_bias=use_bias, device=device, lead=lead)
    return {"gate": dense_init(generator, d_model, (d_ff,), **kw),
            "up": dense_init(generator, d_model, (d_ff,), **kw),
            "down": dense_init(generator, d_ff, (d_model,), **kw)}


def mlp_apply(p, x):
    g = dense_apply(p["gate"], x)
    u = dense_apply(p["up"], x)
    return dense_apply(p["down"], F.silu(g) * u)


# ---------------------------------------------------------------------- embedding
def embed_init(generator, vocab, d_model, device):
    return {"table": truncated_normal(generator, (vocab, d_model), 1.0, device)}


def embed_apply(p, tokens, dtype=torch.bfloat16):
    # gather, then cast: the same numbers as casting the whole table first
    return p["table"][tokens].to(dtype)


def unembed_apply(p, x):
    """Project to vocab logits in fp32 for a stable softmax/xent."""
    w = p["table"].to(x.dtype)
    return (x @ w.T).to(torch.float32)


# --------------------------------------------------------------------------- rope
def rope_freqs(head_dim, rotary_dim, theta):
    exponents = np.arange(0, rotary_dim, 2, dtype=np.float32) / rotary_dim
    return 1.0 / (theta ** exponents)  # (rotary_dim/2,)


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim, rotary_dim, theta, device):
    # copied to the device once: a copy from host memory synchronises the
    # stream, which at every layer would stall the decode loop on the card
    return torch.from_numpy(rope_freqs(head_dim, rotary_dim, theta)).to(device)


def apply_rope(x, positions, *, rotary_dim, theta):
    """x: (..., S, H, D); positions: (..., S). Rotates the first rotary_dim dims."""
    if rotary_dim == 0:
        return x
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, rotary_dim, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, r/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, r/2)
    sin = torch.sin(angles)[..., None, :]
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    x1, x2 = rot[..., : rotary_dim // 2], rot[..., rotary_dim // 2:]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    out = torch.cat([out1, out2], dim=-1).to(x.dtype)
    if rotary_dim < d:
        out = torch.cat([out, rest], dim=-1)
    return out


# --------------------------------------------------------------------------- loss
def xent_terms(logits, labels):
    """Per-token (nll, top-1 hit) of fp32 logits (..., V) against int labels
    (...): ``logsumexp - gold`` and ``argmax == label`` as fp32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    hit = (torch.argmax(logits, -1) == labels).to(torch.float32)
    return logz - gold, hit


def softmax_xent(logits, labels, mask=None):
    """Token-level cross entropy; logits fp32 (..., V), labels int (...).
    Returns (loss, accuracy)."""
    nll, hit = xent_terms(logits, labels)
    if mask is None:
        n = torch.tensor(float(nll.numel()), device=nll.device)
        return nll.sum() / n, hit.sum() / n
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    return torch.sum(nll * mask) / denom, torch.sum(hit * mask) / denom
