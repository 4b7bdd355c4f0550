"""Flash attention for the models, forward only.

Port of the forward of the JAX package's ``models/flash.py``
(``flash_attention_padded`` / ``_fwd_impl``). There the Pallas kernel
``kernels/flash_attention`` "implements the same forward" and is not
called by the model; here the forward IS the kernel: CUDA tensors launch
one of the two flash kernels through ``kernels.flash_attention.ops``
(``csrc/flash_attention_sm90.cu`` for bf16 at head dims 64 / 128 / 256,
``csrc/flash_attention.cu`` otherwise), CPU tensors take the plain
version. The kernels mask the ragged edge themselves, so nothing is
padded, and pick their own tiles (no block sizes here).

Numerics: in bf16 the JAX forward casts p to v's dtype before P.V, and so
does the sm90 kernel; the other kernel and the plain version keep p in
fp32 (as the Pallas kernel does), so bf16 results differ at bf16 rounding
by design. In fp32 they agree to summation order.

The recompute backward (``_bwd``, ``_bwd_tri``) comes with training; until
then a backward through this function raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops

TRAINING_ITEM = "ROADMAP.md queue 1, 'LM training'"


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "the flash-attention backward (the JAX package's recompute VJP) "
            f"is not ported yet: {TRAINING_ITEM}")


def flash_attention_padded(q, k, v, causal=True, window=0):
    """q (B, Sq, KH, G, Dh); k/v (B, Skv, KH, Dh) -> (B, Sq, KH, G, Dh)."""
    B, Sq, KH, G, Dh = q.shape
    out = _FlashForward.apply(q.reshape(B, Sq, KH * G, Dh), k, v, causal,
                              window)
    return out.reshape(B, Sq, KH, G, Dh)
