"""Plain PyTorch version of the flash-attention kernel: masked softmax
attention in fp32, one shot (it holds the (B, H, Sq, Skv) scores, so it is
for checks, not for long sequences).

q (B, Sq, H, Dh); k/v (B, Skv, KH, Dh) with query head ``h`` reading kv
head ``h // (H // KH)`` (the JAX model's ``q.reshape(B, S, KH, G, Dh)``).
Masks as the Pallas kernel's: causal keeps ``k <= q``, a window keeps
``k > q - window`` (positions from 0 on both axes).
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """Returns (B, Sq, H, Dh) in q.dtype."""
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = Dh ** -0.5 if scale is None else scale
    qg = q.to(torch.float32).reshape(B, Sq, KH, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)).mul_(scale)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    s.masked_fill_(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, Dh).to(q.dtype)
