"""Mixture-of-experts FFN: capacity-based dispatch, and a dropless one.

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

The dropless path (``moe_dropless``, ``router="sigmoid"``: Trinity's AFMoE
layer; the JAX package has none) routes every token over all
``num_experts`` in fp32 (sigmoid scores; top-k of score + the layer's
expert bias, which chooses and does not weight; the chosen scores
renormalized and scaled) and computes only the experts this device holds
(``held``, [lo, hi)): a stable sort of the (token, choice) pairs by held
expert, with the pairs routed elsewhere after them, then the grouped
products (``grouped_mm``) over the held experts' row groups and a combine
in pair order. No pair is dropped and nothing waits on the host: every
buffer is sized to the upper bound of held pairs (tokens x top_k), the
group offsets stay on the device, and the rows past the last offset are
kept out of the combine and out of the tokens' gradients (the grouped
product leaves them undefined). It returns each expert's load, which the
train step turns into the bias update and reports in its metrics.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.spans import span
from repro_torch.kernels import report_meta
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

    def stack(shape, fan_in):     # the held experts' matrices (all by default)
        return L._trunc(generator, shape, 1.0 / math.sqrt(fan_in), device,
                        (*lead, m.num_held), dtype)

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


# ------------------------------------------------------------ dropless path
def update_expert_bias(bias, load, rate):
    """The aux-loss-free balancing step, in place on ``bias`` (layers,
    experts): with n_e the pairs routed to expert e over this device's
    tokens (``load``'s first num_experts columns), delta = rate x sign(
    mean(n) - n), bias += delta - mean(delta)."""
    n = load[:, :bias.shape[1]].to(torch.float32)
    delta = rate * torch.sign(n.mean(-1, keepdim=True) - n)
    bias.add_(delta - delta.mean(-1, keepdim=True))


class _GroupedMeta(torch.autograd.Function):
    """The grouped product on meta tensors: empty outputs, its FLOPs and
    bytes reported (``kernels.report_meta``) for the forward and for the
    backward's two products."""

    @staticmethod
    def forward(ctx, x, w, offs, rows):
        ctx.rows = rows
        ctx.x = (x.shape, x.dtype)                   # shapes only: nothing kept alive
        ctx.w = (w.shape, w.dtype)
        _report_grouped(rows, ctx.x, ctx.w)
        return x.new_empty((x.shape[0], w.shape[-1]))

    @staticmethod
    def backward(ctx, dy):
        _report_grouped(ctx.rows, ctx.x, ctx.w)      # dx = dy w^T
        _report_grouped(ctx.rows, ctx.x, ctx.w)      # dw = x^T dy
        return (dy.new_empty(ctx.x[0], dtype=ctx.x[1]),
                dy.new_empty(ctx.w[0], dtype=ctx.w[1]), None, None)


def _report_grouped(rows, x, w):
    (G, K, N), size = w[0], w[1].itemsize
    report_meta("grouped_mm", flops=2.0 * rows * K * N,
                nbytes=rows * (K + N) * x[1].itemsize + G * K * N * size)


def grouped_mm(x, w, offs, rows=None):
    """Row groups of ``x`` (M, K) times their own matrix of ``w`` (G, K, N):
    rows [offs[g-1], offs[g]) by w[g] (``offs`` (G,) int32 ends, on x's
    device). Rows from offs[-1] on are undefined in the result and in x's
    gradient. CUDA: ``torch._grouped_mm`` (bf16 operands, fp32 sums, on
    sm90) and its backward; CPU: a loop over the groups (one host read of
    the offsets); meta: empty, its work reported for ``rows`` rows
    (default M)."""
    if x.is_meta:
        return _GroupedMeta.apply(x, w, offs, x.shape[0] if rows is None else rows)
    if x.is_cuda:
        return torch._grouped_mm(x, w, offs=offs)
    ends = offs.tolist()
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    start = 0
    for g, end in enumerate(ends):
        if end > start:
            out[start:end] = x[start:end] @ w[g]
        start = end
    return out


class _ZeroTailGrad(torch.autograd.Function):
    """Identity forward; the backward zeroes the gradient's rows from
    ``end`` (a 0-d tensor) on: the grouped product's undefined rows."""

    @staticmethod
    def forward(ctx, x, end):
        ctx.save_for_backward(end)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (end,) = ctx.saved_tensors
        rows = torch.arange(g.shape[0], device=g.device)
        return torch.where((rows < end)[:, None], g, 0), None


def sigmoid_route(p, m, x, bias=None):
    """x (N, d) -> (weights (N, k) fp32, choices (N, k) int64), in fp32:
    s = sigmoid(x W_r) over all experts, the top k of s + bias (ties to
    the lower index), their s renormalized (over their sum + 1e-20) and
    times ``route_scale``."""
    s = torch.sigmoid(x.to(torch.float32) @ p["router"]["w"].to(torch.float32))
    _, choices = top_k(s if bias is None else s + bias, m.top_k)
    w = torch.gather(s, 1, choices)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * m.route_scale, choices


def moe_dropless(p, cfg, x, bias=None):
    """x (B, S, d) -> (y (B, S, d), load): the held experts' part of the
    routed FFN plus the shared expert. ``bias`` (num_experts,) fp32 or
    None (zeros). ``load`` (num_experts + 1,) int64 on the device: the
    (token, choice) pairs routed to each expert, over all experts, then
    the pairs the grouped products computed (the held ones: none is
    dropped)."""
    m = cfg.moe
    B, S, d = x.shape
    N, k, E = B * S, m.top_k, m.num_experts
    lo, hi = m.held_range
    Eh, P = hi - lo, N * k
    x2 = x.reshape(N, d)
    dev = x.device
    with span("dfl.moe.route"):
        w, choices = sigmoid_route(p, m, x2, bias)
        flat = choices.reshape(P)
        ones = torch.ones(P, dtype=torch.int64, device=dev)
        load = torch.zeros(E + 1, dtype=torch.int64, device=dev).scatter_add_(0, flat, ones)
    with span("dfl.moe.dispatch"):
        key = torch.where((flat >= lo) & (flat < hi), flat - lo, Eh)
        order = torch.sort(key, stable=True).indices       # held experts' rows first
        counts = torch.zeros(Eh + 1, dtype=torch.int64, device=dev).scatter_add_(0, key, ones)
        offs = torch.cumsum(counts[:Eh], 0).to(torch.int32)
        end = offs[-1]
        load[E] = end
        xs = _ZeroTailGrad.apply(x2[order // k], end)      # (P, d)
    with span("dfl.moe.experts"):
        dt = x.dtype
        rows = P * Eh // E if x.is_meta else None          # an even load, for the meta trace
        g = grouped_mm(xs, p["gate"].to(dt), offs, rows)
        u = grouped_mm(xs, p["up"].to(dt), offs, rows)
        ye = grouped_mm(F.silu(g) * u, p["down"].to(dt), offs, rows)
    with span("dfl.moe.combine"):
        valid = torch.arange(P, device=dev) < end
        ye = torch.where(valid[:, None], ye, 0)
        inv = torch.empty_like(order).scatter_(0, order, torch.arange(P, device=dev))
        y = torch.einsum("nk,nkd->nd", w.to(dt), ye[inv].reshape(N, k, d))
    if "shared" in p:
        with span("dfl.moe.shared"):
            y = y + L.mlp_apply(p["shared"], x2)
    return y.reshape(B, S, d), load
