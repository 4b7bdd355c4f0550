"""Plain PyTorch versions of the int8 quantizer (the math of
``repro_torch.core.compression``).

``quantize_ref`` / ``dequantize_ref`` work on the kernel's (R, C) rows: the
row API's oracle. ``quantize_tree_ref`` / ``dequantize_tree_ref`` /
``roundtrip_tree_ref`` walk the same segment table (``table.plan``) over the
same arenas as the tree kernels: each segment's leaf is blocked into its
rows, its ragged tail padded with zeros, its q and scales written at the
segment's offsets in the wire arenas, and its output at its offset in the
output arena. They are the CPU path of the tree API and the oracle the
tree kernels are held to bitwise on the card.

Both divisions take a tensor divisor: PyTorch's CUDA ``div`` by a Python
scalar multiplies by the scalar's reciprocal, which is not the IEEE
quotient the contract pins.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize import table


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


def dequantize_ref(q, scales, dtype=torch.float32):
    """q (R, C) int8, scales (R, 1) -> (R, C) in ``dtype`` (the fp32
    product, rounded once)."""
    return (q.to(torch.float32) * scales.to(torch.float32)).to(dtype)


def _segments(plan):
    """The indices of the plan's segments, launch by launch, as the kernels
    walk them (leaves without rows are none)."""
    return [i for g in plan.groups for i in g.leaves]


def quantize_tree_ref(leaves, block: int):
    """leaves -> [(q (*lead, nblocks, b) int8, scales (*lead, nblocks) bf16)],
    views of the two wire arenas."""
    plan = table.plan_for(leaves, block)
    xs = table.kernel_inputs(plan, leaves)
    q, s = table.wire_arenas(plan, table.device_of(leaves))
    for i in _segments(plan):
        lf = plan.leaves[i]
        x = xs[i].reshape(lf.lead_rows, lf.last)
        pad = lf.nblocks * lf.b - lf.last
        if pad:
            x = F.pad(x.to(torch.float32), (0, pad))
        qr, sr = quantize_ref(x.reshape(lf.rows, lf.b))
        q[lf.q_off:lf.q_off + lf.rows * lf.b].copy_(qr.reshape(-1))
        s[lf.s_off:lf.s_off + lf.rows].copy_(sr.reshape(-1))
    return table.wire_views(plan, q, s)


def dequantize_tree_ref(pairs, specs):
    """[(q, scales)] and [(shape, dtype)] -> the leaves, views of one output
    arena (cast where a leaf's type is not fp32 or bf16)."""
    plan = table.plan_for_wire(pairs, specs)
    _, outs = table.out_views(plan, table.device_of([q for q, _ in pairs]))
    for i in _segments(plan):
        lf, (q, s), out = plan.leaves[i], pairs[i], outs[i]
        x = dequantize_ref(q.reshape(lf.rows, lf.b), s.reshape(lf.rows, 1),
                           lf.dtype)
        out.view(lf.lead_rows, lf.last).copy_(
            x.reshape(lf.lead_rows, lf.nblocks * lf.b)[:, :lf.last])
    return table.cast_back(outs, [dt for _, dt in specs])


def roundtrip_tree_ref(leaves, block: int):
    """Quantize, then dequantize every leaf back to its own shape and type."""
    return dequantize_tree_ref(quantize_tree_ref(leaves, block),
                               [(tuple(x.shape), x.dtype) for x in leaves])
