"""The segment table of the int8 quantize / dequantize kernels, and the
arenas it points into.

A parameter tree's leaves, in ``tree.leaves`` order, are blocked along
their last axis (``last_axis_blocking``) into ``rows = prod(lead) *
nblocks`` block rows of ``b <= 256`` columns each. Every leaf with rows is
one segment of a launch: its first block row in the launch (``row0``),
``last``, ``b``, ``nblocks``, its element types, and the pointers to its
input, its q and its scales. A launch takes at most ``MAX_SEGMENTS``
segments, so a tree of more leaves is cut into groups of that many, one
launch each.

The wire (``wire_arenas``): every leaf's q, in the layout ``(*lead,
nblocks, b)`` with its padding columns, packed back to back into one int8
arena, and every leaf's scales into one bf16 arena: together exactly
``compression.payload_bytes(tree, "int8")``. Dequantize writes every leaf
into one output arena, each leaf at a 16-byte aligned offset
(``out_views``). The leaves handed back are views of these arenas.

Nothing here launches or computes: ``ops`` fills the table's pointers and
launches the kernels of ``csrc/quantize.cu``; ``ref`` walks the same
segments over the same arenas with plain PyTorch. Which of the two runs is
decided by the tensors' device alone.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

MAX_SEGMENTS = 64        # segments a launch takes (kMaxSegments in quantize.cu)
MAX_COLS = 256           # widest block a warp quantizes (kMaxCols)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# one row of the table, as ``struct Segment`` in csrc/quantize.cu lays it out
SEGMENT = np.dtype([("x", "<i8"), ("q", "<i8"), ("s", "<i8"), ("row0", "<i8"),
                    ("last", "<i4"), ("b", "<i4"), ("nblocks", "<i4"),
                    ("flags", "<i4")])
X_BF16 = 1   # flags: x (quantize's input, dequantize's output) is bf16, else fp32
S_BF16 = 2   # the scales are bf16, else fp32
VEC = 4      # 16-byte loads and stores of x (set per call, from the pointers)
ALIGN = 16   # bytes: a vector of x, and each leaf's offset in the output arena


def last_axis_blocking(shape, block: int):
    """shape -> (lead, last, b, nblocks) for the last-axis scheme.

    0-d arrays quantize as one 1-element block; zero-size last axes carry
    zero blocks (empty in, empty out).
    """
    lead = tuple(shape[:-1])
    last = shape[-1] if len(shape) else 1
    b = min(block, max(last, 1))
    nblocks = -(-last // b)  # ceil; 0 when last == 0
    return lead, last, b, nblocks


def kernel_dtype(dtype) -> torch.dtype:
    """The element type the kernels read and write for a leaf of ``dtype``:
    its own for fp32 and bf16, else fp32 (cast before and after)."""
    return dtype if dtype in KERNEL_DTYPES else torch.float32


def _strides(shape) -> tuple:
    out, acc = [], 1
    for d in reversed(shape):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


class Leaf(NamedTuple):
    shape: tuple
    dtype: torch.dtype        # the kernel's element type for this leaf
    lead_rows: int
    last: int
    b: int
    nblocks: int
    rows: int                 # block rows: lead_rows * nblocks
    q_shape: tuple            # (*lead, nblocks, b)
    s_shape: tuple            # (*lead, nblocks)
    q_off: int                # bytes into the q arena
    s_off: int                # scales into the scale arena
    out_off: int              # bytes into the output arena (16-byte aligned)


class Group(NamedTuple):
    """The segments of one launch."""
    leaves: tuple             # indices into Plan.leaves, each with rows > 0
    table: np.ndarray         # SEGMENT rows: row0, last, b, nblocks, X_BF16 filled
    rows: int                 # block rows of the launch
    q_offs: np.ndarray        # per segment: bytes into the q arena
    s_offs: np.ndarray        # per segment: bytes into the bf16 scale arena
    out_offs: np.ndarray      # per segment: bytes into the output arena
    vec_ok: np.ndarray        # per segment: b and last hold whole vectors
    q_align: np.ndarray       # per segment: bytes of q a vector covers


class Plan(NamedTuple):
    leaves: Tuple[Leaf, ...]
    groups: Tuple[Group, ...]
    q_bytes: int
    n_scales: int
    out_bytes: int


@functools.lru_cache(maxsize=256)
def plan(signature) -> Plan:
    """The table's shape part for ``signature``, one ``(shape, dtype,
    block)`` per leaf in tree order. Cached: a call with a known signature
    only fills in the pointers."""
    leaves, q_off, s_off, out_off = [], 0, 0, 0
    for shape, dtype, block in signature:
        lead, last, b, nblocks = last_axis_blocking(shape, block)
        if b > MAX_COLS:
            raise ValueError(f"block {block} is wider than {MAX_COLS} columns")
        kd = kernel_dtype(dtype)
        lead_rows = math.prod(lead)
        rows = lead_rows * nblocks
        leaves.append(Leaf(tuple(shape), kd, lead_rows, last, b, nblocks, rows,
                           (*lead, nblocks, b), (*lead, nblocks), q_off, s_off,
                           out_off))
        q_off += rows * b
        s_off += rows
        nbytes = math.prod(shape) * kd.itemsize
        out_off += -(-nbytes // ALIGN) * ALIGN
    live = [i for i, lf in enumerate(leaves) if lf.rows]
    groups = tuple(_group(leaves, live[k:k + MAX_SEGMENTS])
                   for k in range(0, len(live), MAX_SEGMENTS))
    return Plan(tuple(leaves), groups, q_off, s_off, out_off)


def _group(leaves, idx) -> Group:
    sel = [leaves[i] for i in idx]
    table = np.zeros(len(sel), SEGMENT)
    table["row0"] = np.cumsum([0] + [lf.rows for lf in sel[:-1]])
    table["last"] = [lf.last for lf in sel]
    table["b"] = [lf.b for lf in sel]
    table["nblocks"] = [lf.nblocks for lf in sel]
    table["flags"] = [X_BF16 if lf.dtype == torch.bfloat16 else 0 for lf in sel]
    width = np.array([ALIGN // lf.dtype.itemsize for lf in sel], np.int64)
    vec_ok = (table["b"] % width == 0) & (table["last"] % width == 0)
    return Group(tuple(idx), table, sum(lf.rows for lf in sel),
                 np.array([lf.q_off for lf in sel], np.int64),
                 np.array([2 * lf.s_off for lf in sel], np.int64),
                 np.array([lf.out_off for lf in sel], np.int64), vec_ok, width)


def plan_for(leaves, block: int) -> Plan:
    return plan(tuple((tuple(x.shape), x.dtype, block) for x in leaves))


def plan_for_wire(pairs, specs) -> Plan:
    """The plan of a tree's (q, scales) pairs and its (shape, dtype) spec:
    each leaf's block is its q's last dimension, as the JAX package reads
    it; q and scales must hold that blocking's elements."""
    if len(pairs) != len(specs):
        raise ValueError(f"{len(pairs)} (q, scales) pairs for {len(specs)} specs")
    p = plan(tuple((tuple(shape), dtype, q.shape[-1] if q.dim() else 1)
                   for (q, _), (shape, dtype) in zip(pairs, specs)))
    for lf, (q, s) in zip(p.leaves, pairs):
        if q.numel() != lf.rows * lf.b or s.numel() != lf.rows:
            raise ValueError(f"q {tuple(q.shape)} and scales {tuple(s.shape)} do "
                             f"not block a leaf of shape {lf.shape}")
    return p


def device_of(tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"a tree's leaves lie on {len(devices)} devices: "
                         f"{sorted(map(str, devices))}")
    return devices.pop() if devices else torch.device("cpu")


def kernel_inputs(plan_: Plan, leaves) -> list:
    """Each leaf contiguous and in its kernel type (a copy only where it is
    not already: no LeNet leaf needs one)."""
    return [x.to(lf.dtype).contiguous() for lf, x in zip(plan_.leaves, leaves)]


def wire_arenas(plan_: Plan, device):
    """(q int8 (q_bytes,), scales bf16 (n_scales,)): the packed wire."""
    return (torch.empty(plan_.q_bytes, dtype=torch.int8, device=device),
            torch.empty(plan_.n_scales, dtype=torch.bfloat16, device=device))


def wire_views(plan_: Plan, q, s) -> list:
    """Each leaf's (q (*lead, nblocks, b), scales (*lead, nblocks)) as views
    of the wire arenas: ``compression.quantize_last_axis``'s arrays."""
    return [(q.as_strided(lf.q_shape, _strides(lf.q_shape), lf.q_off),
             s.as_strided(lf.s_shape, _strides(lf.s_shape), lf.s_off))
            for lf in plan_.leaves]


def out_views(plan_: Plan, device):
    """(arena, views): one uint8 arena and each leaf's output, in its kernel
    type and shape, as a view at its 16-byte aligned offset."""
    arena = torch.empty(plan_.out_bytes, dtype=torch.uint8, device=device)
    typed = {dt: arena.view(dt) for dt in {lf.dtype for lf in plan_.leaves}}
    return arena, [typed[lf.dtype].as_strided(lf.shape, _strides(lf.shape),
                                              lf.out_off // lf.dtype.itemsize)
                   for lf in plan_.leaves]


def cast_back(outs, dtypes) -> list:
    """Leaves whose own type the kernels do not write, cast from fp32."""
    return [o if o.dtype == dt else o.to(dt) for o, dt in zip(outs, dtypes)]
