"""Gossip payload compression: block-wise symmetric int8 along the last axis.

Port of the JAX package's ``repro.core.compression`` (last-axis scheme):
4x fewer wire bytes than fp32 at <0.4% relative error per tensor. Per-block
scales ship as bfloat16 and are rounded through bf16 BEFORE q is computed,
so the scale the receiver multiplies by is the one the sender divided by;
the ``SCALE_EPS`` clamp keeps all-zero blocks exact.

Each leaf's (..., nblocks, b) blocks are reshaped to (R, b) rows and go
through ``repro_torch.kernels.quantize.ops``: the CUDA kernels for CUDA
tensors, the plain version for CPU tensors. Both are bitwise equal to the
JAX package's module on fp32 inputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.kernels.quantize import ops as q_ops

BLOCK = 256  # quantization block (elements)

# Zero-block guard, inside bf16's normal range (min normal ~1.2e-38).
SCALE_EPS = 1e-12


def _last_axis_blocking(shape, block: int = BLOCK):
    """shape -> (lead, last, b, nblocks) for the last-axis scheme.

    0-d arrays quantize as one 1-element block; zero-size last axes carry
    zero blocks (empty in, empty out).
    """
    lead = tuple(shape[:-1])
    last = shape[-1] if len(shape) else 1
    b = min(block, max(last, 1))
    nblocks = -(-last // b)  # ceil; 0 when last == 0
    return lead, last, b, nblocks


def quantize_last_axis(x, block: int = BLOCK):
    """Blocks along the LAST axis only -> (q int8 (*lead, nblocks, b),
    scales bf16 (*lead, nblocks)).

    A 0-d leaf is one 1-element block (q (1, 1), scales (1,)); a zero-size
    last axis yields zero blocks (q (*lead, 0, 1), scales (*lead, 0)).
    """
    lead, last, b, nblocks = _last_axis_blocking(tuple(x.shape), block)
    xf = x.reshape(*lead, last)
    if xf.dtype not in (torch.float32, torch.bfloat16):
        xf = xf.to(torch.float32)
    pad = nblocks * b - last
    if pad:
        xf = F.pad(xf.to(torch.float32), (0, pad))
    q, scale = q_ops.quantize_rows(xf.reshape(-1, b))
    return (q.reshape(*lead, nblocks, b),
            scale.reshape(*lead, nblocks).to(torch.bfloat16))


def dequantize_last_axis(q, scales, shape, dtype):
    lead, last, b, nblocks = _last_axis_blocking(tuple(shape), q.shape[-1])
    if last == 0:
        return torch.zeros(tuple(shape), dtype=dtype, device=q.device)
    x = q_ops.dequantize_rows(q.reshape(-1, b),
                              scales.to(torch.float32).reshape(-1, 1))
    x = x.reshape(*lead, nblocks * b)[..., :last]
    return x.reshape(tuple(shape)).to(dtype)


def _is_qs_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and torch.is_tensor(x[0])


def quantize_tree(tree_, block: int = BLOCK):
    """Tree -> (tree of (q, scales), (shape, dtype) spec tree)."""
    spec = tree.map(lambda x: (tuple(x.shape), x.dtype), tree_)
    qt = tree.map(lambda x: quantize_last_axis(x, block), tree_)
    return qt, spec


def dequantize_tree(qt, spec):
    return tree.map(
        lambda qs, sp: dequantize_last_axis(qs[0], qs[1], sp[0], sp[1]),
        qt, spec, is_leaf=_is_qs_pair)


def roundtrip_tree(tree_, block: int = BLOCK):
    """Quantize + immediately dequantize every leaf back to its own dtype:
    the simulators' wire model (the sender quantizes its broadcast once,
    every receiver sees the identical reconstruction)."""
    qt, spec = quantize_tree(tree_, block)
    return dequantize_tree(qt, spec)


def leaf_wire_bytes(shape, dtype, compress) -> int:
    """Bytes on the wire for one leaf under a compression mode.

    None ships the raw dtype; "int8" ships the padded int8 blocks plus one
    bf16 scale per block (the exact arrays quantize_last_axis emits).
    """
    size = math.prod(shape)
    if compress is None:
        return size * dtype.itemsize
    if compress == "int8":
        lead, _, b, nblocks = _last_axis_blocking(tuple(shape))
        return math.prod(lead) * nblocks * (b + torch.bfloat16.itemsize)
    raise ValueError(f"unknown compress mode: {compress!r}")


def payload_bytes(tree_, compress) -> int:
    """Total wire bytes for a broadcast payload tree (tensors, or anything
    with .shape/.dtype)."""
    return sum(leaf_wire_bytes(tuple(leaf.shape), leaf.dtype, compress)
               for leaf in tree.leaves(tree_))
