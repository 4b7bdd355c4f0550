"""The int8 wire in plain PyTorch: each leaf blocked along its last axis
into blocks of min(256, last) columns, a block's scale its absolute max over
127 (an IEEE quotient) clamped at 1e-12 and rounded through bf16, q the
quotient x / scale rounded half to even and clipped to +-127, the receiver's
value q * scale in fp32."""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def roundtrip_leaf(x: torch.Tensor, block: int = BLOCK):
    """x (..., last) fp32 -> (the received x, the (..., nblocks) scales)."""
    last = x.shape[-1]
    b = min(block, max(last, 1))
    nb = -(-last // b)
    xp = F.pad(x, (0, nb * b - last)) if nb * b != last else x
    xb = xp.reshape(*x.shape[:-1], nb, b)
    absmax = xb.abs().amax(-1, keepdim=True)
    scale = torch.clamp_min(absmax / torch.tensor(127.0, device=x.device), 1e-12)
    scale = scale.to(torch.bfloat16).to(torch.float32)
    q = torch.clamp(torch.round(xb / scale), -127, 127)
    y = (q * scale).reshape(*x.shape[:-1], nb * b)[..., :last]
    return y, scale[..., 0]
