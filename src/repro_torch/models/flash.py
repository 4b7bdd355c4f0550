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
backward is ``ops.flash_attention_backward``: the hand-written sm90
backward (``csrc/flash_attention_bwd_sm90.cu``) for the CUDA calls it
takes, the plain recompute backward ``ref.flash_backward`` (the JAX
package's ``_bwd`` is jnp; it has no backward kernel) for the rest. Both
round p, dout, ds and the operands of the gradient products to bf16 with
fp32 sums, as the JAX backward does (``preferred_element_type=f32``).

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
            dq, dk, dv = ops.flash_attention_backward(q, k, v, out, lse, dout,
                                                      causal=ctx.causal,
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
