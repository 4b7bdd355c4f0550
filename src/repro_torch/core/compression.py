"""Gossip payload compression: block-wise symmetric int8 along the last axis.

Port of the JAX package's ``repro.core.compression`` (last-axis scheme):
4x fewer wire bytes than fp32 at <0.4% relative error per tensor. Per-block
scales ship as bfloat16 and are rounded through bf16 BEFORE q is computed,
so the scale the receiver multiplies by is the one the sender divided by;
the ``SCALE_EPS`` clamp keeps all-zero blocks exact.

``quantize_tensor`` / ``dequantize_tensor`` are the flat-block forms (the
tensor flattened, zero-padded to whole 256-element blocks); they go through
the same kernel pair as a one-segment table.

A tree's leaves go through ``repro_torch.kernels.quantize.ops`` together:
one kernel launch quantizes the whole tree into the packed wire (int8 q,
bf16 scales) and one dequantizes it, for CUDA tensors; the plain version,
walking the same segment table, for CPU tensors. Both are bitwise equal to
the JAX package's module.

The leaves ``dequantize_tree`` and ``roundtrip_tree`` return are views of
one output arena per call, and the q and scales ``quantize_tree`` returns
views of the two wire arenas. That is safe because nothing writes a
received payload in place: the simulator hands it to receivers, who
evaluate it and average it into new tensors (``DFLNode``, ``fedavg``);
training steps build new tensors as well.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.core.spans import span
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.kernels.quantize.table import last_axis_blocking

BLOCK = 256  # quantization block (elements)

# Zero-block guard, inside bf16's normal range (min normal ~1.2e-38).
SCALE_EPS = 1e-12


def quantize_tensor(x, block: int = BLOCK):
    """x (any shape) -> (q int8 (nblocks, block), scales bf16 (nblocks,)):
    the flattened tensor, zero-padded to whole blocks, one block a row.
    Size-0 inputs produce 0 blocks: q (0, block), scales (0,)."""
    flat = x.to(torch.float32).reshape(-1)
    pad = -flat.numel() % block
    if pad:
        flat = F.pad(flat, (0, pad))
    # a (nblocks, block) leaf is one block a row under the last-axis scheme
    q, scales = q_ops.quantize_tree([flat.reshape(-1, block)], block)[0]
    return q.reshape(-1, block), scales.reshape(-1)


def dequantize_tensor(q, scales, shape, dtype):
    """The inverse of ``quantize_tensor``: the fp32 products ``q * scale``,
    cut to ``shape`` and cast to ``dtype``."""
    nblocks, block = q.shape
    flat = q_ops.dequantize_tree([(q.reshape(nblocks, 1, block),
                                   scales.reshape(nblocks, 1))],
                                 [((nblocks, block), torch.float32)])[0]
    return flat.reshape(-1)[:math.prod(shape)].reshape(shape).to(dtype)


def _last_axis_blocking(shape, block: int = BLOCK):
    """shape -> (lead, last, b, nblocks) for the last-axis scheme."""
    return last_axis_blocking(shape, block)


def quantize_last_axis(x, block: int = BLOCK):
    """Blocks along the LAST axis only -> (q int8 (*lead, nblocks, b),
    scales bf16 (*lead, nblocks)).

    A 0-d leaf is one 1-element block (q (1, 1), scales (1,)); a zero-size
    last axis yields zero blocks (q (*lead, 0, 1), scales (*lead, 0)).
    """
    return q_ops.quantize_tree([x], block)[0]


def dequantize_last_axis(q, scales, shape, dtype):
    return q_ops.dequantize_tree([(q, scales)], [(tuple(shape), dtype)])[0]


def _is_qs_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and torch.is_tensor(x[0])


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype)


def quantize_tree(tree_, block: int = BLOCK):
    """Tree -> (tree of (q, scales), (shape, dtype) spec tree)."""
    spec = tree.map(lambda x: (tuple(x.shape), x.dtype), tree_)
    pairs = q_ops.quantize_tree(tree.leaves(tree_), block)
    return tree.unflatten(tree_, pairs), spec


def dequantize_tree(qt, spec):
    pairs = tree.leaves(qt, is_leaf=_is_qs_pair)
    out = q_ops.dequantize_tree(pairs, tree.leaves(spec, is_leaf=_is_spec))
    return tree.unflatten(qt, out, is_leaf=_is_qs_pair)


def roundtrip_tree(tree_, block: int = BLOCK):
    """Quantize + immediately dequantize every leaf back to its own dtype:
    the simulators' wire model (the sender quantizes its broadcast once,
    every receiver sees the identical reconstruction)."""
    with span("dfl.wire"):
        return tree.unflatten(tree_, q_ops.roundtrip_tree(tree.leaves(tree_), block))


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
