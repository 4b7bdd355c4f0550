"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Port of the JAX package's ``models/rglru.py`` with its param and cache
layout. Block structure (one "recurrent" temporal-mixing sublayer):

    x -> [W_gate -> GeLU] ---------------------------\\
    x -> [W_x] -> causal conv1d(width 4) -> RG-LRU ->  * -> W_out

RG-LRU recurrence (elementwise, diagonal):

    r_t = sigmoid(W_r x_t + b_r)              recurrence gate
    i_t = sigmoid(W_i x_t + b_i)              input gate
    log a_t = -c * softplus(Lambda) * r_t     (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The JAX prefill is ``jax.lax.associative_scan`` over time; here it is a
parallel scan with the same combine, ``(a1 + a2, exp(a2) * b1 + b2)`` on
(log decay, state), in ceil(log2 S) doubling steps of elementwise ops over
(B, S, D) (``scan``). The two add in different orders, so they agree to
fp32 rounding, not bit for bit. Decode is one step carried in the cache.
The gates and the recurrence run in fp32 whatever the activation dtype;
``gelu`` is the tanh form (``jax.nn.gelu``'s default) and softplus is
``logaddexp(x, 0)`` (``jax.nn.softplus``; torch's returns x above 20).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

_C = 8.0
_CONV_WIDTH = 4
_pt = torch.float32


def rglru_init(generator, cfg, device, lead=(), dtype=None):
    """The temporal mix's params; the dense weights and the conv taps (cast
    at use) stored in ``dtype``, the gates' w_r / w_i (used in fp32) not."""
    d = cfg.d_model
    d_rnn = cfg.d_model  # RecurrentGemma: RNN width == d_model
    kw = dict(use_bias=False, device=device, lead=lead, dtype=dtype)

    def normal(shape, stored=None):
        return L.normal(generator, shape, 0.01, device, lead, stored)

    def zeros():
        return torch.zeros((*lead, d_rnn), dtype=_pt, device=device)

    def lam():
        t = torch.empty((d_rnn,), dtype=_pt, device=device)
        return t.uniform_(2.0, 6.0, generator=generator)

    p = {"gate": L.dense_init(generator, d, (d_rnn,), **kw),
         "x": L.dense_init(generator, d, (d_rnn,), **kw),
         "out": L.dense_init(generator, d_rnn, (d,), **kw),
         "conv_w": normal((_CONV_WIDTH, d_rnn), dtype),
         "conv_b": zeros(),
         "w_r": normal((d_rnn, d_rnn)),
         "b_r": zeros(),
         "w_i": normal((d_rnn, d_rnn)),
         "b_i": zeros()}
    # Lambda init so that a^c = sigmoid(Lambda)^c spans ~[0.9, 0.999]
    p["lam"] = L.draw_stacked(lead, (d_rnn,), lam, device)
    return p


def _causal_conv(p, u, state=None):
    """Depthwise causal conv width 4. u (B,S,D). state (B, 3, D) prior inputs."""
    B, S, D = u.shape
    if state is None:
        pad = torch.zeros((B, _CONV_WIDTH - 1, D), dtype=u.dtype, device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)  # (B, S+3, D)
    w = p["conv_w"].to(u.dtype)
    y = sum(full[:, i: i + S] * w[i] for i in range(_CONV_WIDTH))
    y = y + p["conv_b"].to(u.dtype)
    return y, full[:, -(_CONV_WIDTH - 1):]


def _gates(p, u):
    """r/i gates and log decay. u (..., D) -> (log_a, beta*i*u) in fp32."""
    uf = u.to(_pt)
    r = torch.sigmoid(uf @ p["w_r"] + p["b_r"])
    i = torch.sigmoid(uf @ p["w_i"] + p["b_i"])
    lam = p["lam"]
    log_a = -_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r   # <= 0
    a2 = torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12))
    return log_a, beta * i * uf


def scan(log_a, b):
    """h_t = exp(log_a_t) * h_{t-1} + b_t along axis 1 with h_{-1} = 0, for
    every t: Hillis-Steele doubling with ``associative_scan``'s combine."""
    S = log_a.shape[1]
    a, h, off = log_a, b, 1
    while off < S:
        h = torch.cat([h[:, :off], torch.exp(a[:, off:]) * h[:, :-off] + h[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] + a[:, off:]], dim=1)
        off *= 2
    return h


def rglru_cache_init(cfg, batch, device, dtype=torch.bfloat16, lead=()):
    d_rnn = cfg.d_model
    return {"h": torch.zeros((*lead, batch, d_rnn), dtype=_pt, device=device),
            "conv": torch.zeros((*lead, batch, _CONV_WIDTH - 1, d_rnn), dtype=dtype,
                                device=device)}


def _write(cache, h, conv_state):
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state.to(cache["conv"].dtype))


def rglru_apply(p, cfg, x, *, cache=None):
    """Full-sequence apply. x (B,S,d) -> (B,S,d); returns (y, cache), the
    cache (when given) carried in and written in place."""
    gate = F.gelu(L.dense_apply(p["gate"], x), approximate="tanh")
    u = L.dense_apply(p["x"], x)
    u, conv_state = _causal_conv(p, u, None if cache is None else cache["conv"])
    log_a, b = _gates(p, u)                               # (B,S,D) fp32
    if cache is not None:
        # fold carried state into step 0: b_0 += a_0 * h0
        b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1]) * cache["h"][:, None],
                       b[:, 1:]], dim=1)
    h = scan(log_a, b)
    y = (gate.to(_pt) * h).to(x.dtype)
    y = L.dense_apply(p["out"], y)
    if cache is not None:
        _write(cache, h[:, -1], conv_state)
    return y, cache


def rglru_decode(p, cfg, x, cache):
    """Single-token step. x (B,1,d); the cache is updated in place."""
    gate = F.gelu(L.dense_apply(p["gate"], x), approximate="tanh")[:, 0]
    u = L.dense_apply(p["x"], x)
    u, conv_state = _causal_conv(p, u, cache["conv"])
    log_a, b = _gates(p, u[:, 0])
    h = torch.exp(log_a) * cache["h"] + b
    y = (gate.to(_pt) * h).to(x.dtype)[:, None]
    y = L.dense_apply(p["out"], y)
    _write(cache, h, conv_state)
    return y, cache
