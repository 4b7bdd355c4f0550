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

``flash_backward`` is the plain version of the sm90 backward kernel, and
the port of the JAX model's jnp backward (``models/flash.py`` ``_bwd``):
per (query block, key block) pair it recomputes p from the lse and forms
``delta = sum(dout * out)``, dq, dk and dv with fp32 sums, the kv-head sum
over the G query heads of a group included. It visits only the key blocks
that the causal or window mask keeps for a query block: the pairs the JAX
``_bwd_tri`` leaves out of its triangle packing (a layout choice there,
not another function). p, dout, ds and the operands of the gradient
products are rounded to bf16 first, with fp32 sums, as the JAX backward
does (``preferred_element_type=f32``) whatever the input dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38
LSE_EMPTY = -1.0e38
BLOCK_Q = 512      # query rows a backward block (the JAX block_q default)
BLOCK_KV = 1024    # keys a backward block (the JAX block_kv default)


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


def _bf16(x):
    """x rounded to bf16, held in fp32: a bf16 operand of an fp32-summed
    product (``preferred_element_type=f32``)."""
    return x.to(torch.bfloat16).to(torch.float32)


def flash_backward(q, k, v, out, lse, dout, *, causal, window, scale=None,
                   block_q=BLOCK_Q, block_kv=BLOCK_KV):
    """The recompute VJP of masked softmax attention.

    q, out, dout (B, Sq, H, Dh); k, v (B, Skv, KH, Dh); lse (B, H, Sq) fp32,
    the forward's log-sum-exp of each row's kept scaled scores. Returns
    (dq, dk, dv) in the dtypes of q, k, v. Positions run from 0 on both
    axes, as the forward's masks do."""
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = Dh ** -0.5 if scale is None else float(scale)
    f32 = torch.float32
    # (B, KH, G, S, Dh) and (B, KH, S, Dh): a block is a slice along S
    qh = q.to(f32).reshape(B, Sq, KH, G, Dh).permute(0, 2, 3, 1, 4)
    doh = dout.to(f32).reshape(B, Sq, KH, G, Dh).permute(0, 2, 3, 1, 4)
    kh, vh = (x.to(f32).permute(0, 2, 1, 3) for x in (k, v))
    delta = (dout.to(f32) * out.to(f32)).sum(-1)               # (B, Sq, H)
    delta = delta.reshape(B, Sq, KH, G).permute(0, 2, 3, 1)    # (B, KH, G, Sq)
    lseh = lse.reshape(B, KH, G, Sq)
    dq = torch.zeros((B, KH, G, Sq, Dh), dtype=f32, device=q.device)
    dk = torch.zeros((B, KH, Skv, Dh), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        # the keys the mask keeps for some row of [q0, q1)
        lo = max(0, q0 - window + 1) if window else 0
        hi = min(Skv, q1) if causal else Skv
        if lo >= hi:
            continue
        q_blk, do_blk = qh[:, :, :, q0:q1], doh[:, :, :, q0:q1]
        q16, do16 = _bf16(q_blk), _bf16(do_blk)
        lse_blk = lseh[..., q0:q1, None]
        delta_blk = delta[..., q0:q1, None]
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        dq_acc = dq[:, :, :, q0:q1]
        for k0 in range(lo, hi, block_kv):
            k1 = min(k0 + block_kv, hi)
            k_blk, v_blk = kh[:, :, k0:k1], vh[:, :, k0:k1]
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk) * scale
            k_pos = torch.arange(k0, k1, device=q.device)[None, :]
            keep = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=q.device)
            if causal:
                keep &= k_pos <= q_pos
            if window:
                keep &= k_pos > q_pos - window
            p = torch.where(keep, torch.exp(s - lse_blk), 0.0)
            dv[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", _bf16(p), do16)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", do16, _bf16(v_blk))
            ds = _bf16(p * (dp - delta_blk) * scale)
            dq_acc += torch.einsum("bhgqk,bhkd->bhgqd", ds, _bf16(k_blk))
            dk[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, q16)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
