"""Mixture-of-experts FFN with capacity-based dispatch.

Port of the JAX package's ``models/moe.py`` with its param layout (a
``router`` dense, expert stacks ``gate``/``up`` (E, d, ff) and ``down``
(E, ff, d), an optional SwiGLU ``shared`` expert) and its two dispatch
strategies:

* ``per_row`` (train / prefill, S > 1): a token's slot in an expert is its
  rank among the row's (token, choice) pairs routed there, in row-major
  (N, k) order, from a per-row cumsum; the dispatch buffer is (B, E, C, d)
  with ``C = ceil(S * top_k / E * capacity_factor)``;
* ``flat`` (decode, S == 1): the batch's tokens form one row, with
  ``C = ceil(B * top_k / E * capacity_factor)``, so expert FLOPs follow the
  active params.

Pairs past an expert's capacity are dropped (weight 0), the Switch/GShard
policy; gates are renormalized over the chosen top_k. Everything is
fixed-shape: no ``nonzero`` and no host sync on the path.

Numerics kept from the JAX module: the expert stacks are rounded to bf16
at every use, even in an fp32 forward (``gather_expert_weights``); the
router and the shared expert are not. The top-k breaks ties toward the
lower expert index, as ``jax.lax.top_k`` does (a stable descending sort).
The expert products are plain batched matmuls (``torch.einsum``), as they
are XLA einsums outside any kernel in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

EXPERT_DTYPE = torch.bfloat16    # the expert stacks' dtype at use
EXPERT_STACKS = ("gate", "up", "down")


def moe_init(generator, cfg, device, lead=(), dtype=None):
    """Random params; the router's and the shared expert's weights and the
    expert stacks stored in ``dtype``. A stack is filled one (unit, expert)
    slice at a time, each drawn in fp32 and cast into place, so no fp32
    copy larger than one expert's matrix is ever alive."""
    m = cfg.moe
    d, E, ff = cfg.d_model, m.num_experts, m.d_ff_expert

    def stack(shape, fan_in):
        return L._trunc(generator, shape, 1.0 / math.sqrt(fan_in), device,
                        (*lead, E), dtype)

    p = {"router": L.dense_init(generator, d, (E,), use_bias=False, device=device,
                                lead=lead, dtype=dtype),
         "gate": stack((d, ff), d),
         "up": stack((d, ff), d),
         "down": stack((ff, d), ff)}
    if m.shared_expert:
        p["shared"] = L.mlp_init(generator, d, ff, False, device, lead, dtype)
    return p


def top_k(probs, k):
    """(values, indices) of the k largest along the last axis, ties broken
    toward the lower index (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _route(p, cfg, x):
    """Router top-k. x (..., d) -> gates (..., k) fp32, experts (..., k)
    int64, and the Switch load-balancing aux loss."""
    m = cfg.moe
    logits = L.dense_apply(p["router"], x).to(torch.float32)   # (..., E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k(probs, m.top_k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # E * sum(frac_tokens * frac_prob), frac_tokens from the first choice
    probs_mean = probs.reshape(-1, m.num_experts).mean(0)
    onehot = F.one_hot(experts.reshape(-1, m.top_k)[:, 0], m.num_experts)
    frac_tokens = onehot.to(torch.float32).mean(0)
    aux = m.num_experts * torch.sum(frac_tokens * probs_mean)
    return gates, experts, aux


def _expert_ffn(p, xe):
    """xe (R, E, C, d) -> (R, E, C, d), batched over experts."""
    g = torch.einsum("recd,edf->recf", xe, p["gate"].to(xe.dtype))
    u = torch.einsum("recd,edf->recf", xe, p["up"].to(xe.dtype))
    return torch.einsum("recf,efd->recd", F.silu(g) * u, p["down"].to(xe.dtype))


def _dispatch_combine(p, cfg, x3d, capacity):
    """Capacity dispatch for x3d (R, N, d): R independent rows, N tokens
    each; slots from a per-row cumsum. Returns (y (R, N, d), aux)."""
    m = cfg.moe
    R, N, d = x3d.shape
    E, k = m.num_experts, m.top_k
    gates, experts, aux = _route(p, cfg, x3d)            # (R, N, k)
    flat_e = experts.reshape(R, N * k)                   # (R, N*k)
    pos = torch.cumsum(F.one_hot(flat_e, E), dim=1) - 1  # slot within expert
    flat_pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = flat_pos < capacity
    safe_pos = torch.where(keep, flat_pos, 0)
    # scatter the kept (token, choice) pairs into (R, E, C, d); a dropped
    # pair adds zeros at its expert's slot 0, as the JAX scatter-add does
    xk = torch.repeat_interleave(x3d, k, dim=1)          # (R, N*k, d)
    ridx = torch.arange(R, device=x3d.device)[:, None].expand(R, N * k)
    buf = torch.zeros((R, E, capacity, d), dtype=x3d.dtype, device=x3d.device)
    buf = buf.index_put((ridx, flat_e, safe_pos),
                        torch.where(keep[..., None], xk, 0), accumulate=True)
    ye = _expert_ffn(p, buf)                             # (R, E, C, d)
    yk = ye[ridx, flat_e, safe_pos]                      # (R, N*k, d)
    w = (gates.reshape(R, N * k) * keep).to(x3d.dtype)
    y = torch.sum((yk * w[..., None]).reshape(R, N, k, d), dim=2)
    return y, aux


def capacity(cfg, tokens: int) -> int:
    """Slots an expert has for a row of ``tokens`` tokens."""
    m = cfg.moe
    return max(1, math.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor))


def moe_apply(p, cfg, x):
    """x (B, S, d) -> ((B, S, d), aux). Decode (S == 1) flattens the batch
    into a single dispatch row."""
    B, S, d = x.shape
    pg = dict(p, **{k: p[k].to(EXPERT_DTYPE) for k in EXPERT_STACKS})
    if S == 1:
        y, aux = _dispatch_combine(pg, cfg, x.reshape(1, B, d), capacity(cfg, B))
        y = y.reshape(B, 1, d)
    else:
        y, aux = _dispatch_combine(pg, cfg, x, capacity(cfg, S))
    if "shared" in p:
        y = y + L.mlp_apply(p["shared"], x)
    return y, aux

