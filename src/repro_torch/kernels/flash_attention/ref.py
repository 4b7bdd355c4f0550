"""Plain PyTorch version of the flash-attention kernels: masked softmax
attention in fp32, one shot (it holds the (B, H, Sq, Skv) scores, so it is
for checks, not for long sequences).

q (B, Sq, H, Dh); k/v (B, Skv, KH, Dh) with query head ``h`` reading kv
head ``h // (H // KH)`` (the JAX model's ``q.reshape(B, S, KH, G, Dh)``).
Masks as the Pallas kernel's: causal keeps ``k <= q``, a window keeps
``k > q - window`` (positions from 0 on both axes).

``return_lse`` adds each row's log-sum-exp of its kept scaled scores,
(B, H, Sq) fp32, what the kernels write for the backward. A row with no
kept key gets LSE_EMPTY, the kernels' masked score.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38
LSE_EMPTY = -1.0e38


def attention_ref(q, k, v, *, causal=True, window=0, scale=None,
                  return_lse=False):
    """Returns (B, Sq, H, Dh) in q.dtype; with ``return_lse``, (out, lse)."""
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = Dh ** -0.5 if scale is None else scale
    qg = q.to(torch.float32).reshape(B, Sq, KH, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * scale
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    out = o.reshape(B, Sq, H, Dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(ok.any(-1), torch.logsumexp(s, dim=-1), LSE_EMPTY)
    return out, lse.reshape(B, H, Sq)
