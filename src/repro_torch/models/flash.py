"""Flash attention for the models: the kernel forward and the recompute
backward.

Port of the JAX package's ``models/flash.py`` (``flash_attention_padded``
with its custom VJP ``_fwd`` / ``_bwd``). There the Pallas kernel
``kernels/flash_attention`` "implements the same forward" and is not
called by the model; here the forward IS the kernel: CUDA tensors launch
one of the two flash kernels through ``kernels.flash_attention.ops``
(``csrc/flash_attention_sm90.cu`` for bf16 at head dims 64 / 80 / 128 / 256,
``csrc/flash_attention.cu`` otherwise), CPU tensors take the plain
version. The kernels mask the ragged edge themselves, so nothing is
padded, and pick their own tiles.

Under autograd the forward also asks the kernel for each row's fp32
log-sum-exp and saves (q, k, v, out, lse): residuals stay O(S). The
backward is plain PyTorch, as the JAX package's is jnp (it has no backward
kernel): per (query block, key block) pair it recomputes p from the lse
and forms ``delta = sum(dout * out)``, dq, dk and dv with fp32 sums, the
kv-head sum over the G query heads of a group included. It visits only
the key blocks that the causal or window mask keeps for a query block:
the pairs the JAX ``_bwd_tri`` leaves out of its triangle packing (a
layout choice there, not another function). p, dout, ds and the operands
of the gradient products are rounded to bf16 first, with fp32 sums, as
the JAX backward does (``preferred_element_type=f32``) whatever the input
dtype.

Numerics of the forward: in bf16 the JAX forward casts p to v's dtype
before P.V, and so does the sm90 kernel; the other kernel and the plain
version keep p in fp32 (as the Pallas kernel does), so bf16 results differ
at bf16 rounding by design. In fp32 they agree to summation order.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.spans import span
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref

BLOCK_Q = 512      # query rows a backward block (the JAX block_q default)
BLOCK_KV = 1024    # keys a backward block (the JAX block_kv default)
_PLAIN = [False]


@contextlib.contextmanager
def plain_route():
    """Attention through the plain version (``attention_ref``), autograd
    through it, on any device, for the ``with`` body: a check that holds a
    training step through the kernels against the same step without them.
    Nothing else takes this route."""
    _PLAIN[0] = True
    try:
        yield
    finally:
        _PLAIN[0] = False


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


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with span("dfl.flash.backward"):
            dq, dk, dv = flash_backward(q, k, v, out, lse, dout, causal=ctx.causal,
                                        window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_padded(q, k, v, causal=True, window=0):
    """q (B, Sq, KH, G, Dh); k/v (B, Skv, KH, Dh) -> (B, Sq, KH, G, Dh).
    Under autograd the kernel also writes the log-sum-exp that the backward
    reads; otherwise (serving, receipts) it writes none."""
    B, Sq, KH, G, Dh = q.shape
    q = q.reshape(B, Sq, KH * G, Dh)
    if _PLAIN[0]:
        out = attention_ref(q, k, v, causal=causal, window=window)
    elif torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out = _FlashForward.apply(q, k, v, causal, window)
    else:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    return out.reshape(B, Sq, KH, G, Dh)
