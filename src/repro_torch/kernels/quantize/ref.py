"""Plain PyTorch version of the int8 quantizer (the math of
``repro_torch.core.compression``, restated on the kernel's (R, C) rows).

It is the CPU path and the oracle the CUDA kernel is held to bitwise on the
card. Both divisions take a tensor divisor: PyTorch's CUDA ``div`` by a
Python scalar multiplies by the scalar's reciprocal, which is not the IEEE
quotient the contract pins.
"""
from __future__ import annotations

import torch


def quantize_ref(x):
    """x (R, C) fp -> (q int8 (R, C), scales fp32 (R, 1)).

    Scales are clamped and rounded through bf16 before q is computed — the
    contract shared with the compression module, whose wire format stores
    scales in bf16.
    """
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(absmax / absmax.new_tensor(127.0), 1e-12)
    scale = scale.to(torch.bfloat16).to(torch.float32)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_ref(q, scales):
    """q (R, C) int8, scales (R, 1) -> (R, C) fp32."""
    return q.to(torch.float32) * scales.to(torch.float32)
