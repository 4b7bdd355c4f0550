"""Wrappers for the int8 quantize / dequantize kernels.

One kernel pair (``csrc/quantize.cu``) serves two APIs, both driven by the
segment table of ``table``:

- the tree API, ``quantize_tree`` / ``dequantize_tree`` / ``roundtrip_tree``:
  one launch quantizes, and one dequantizes, a whole tree of up to
  ``table.MAX_SEGMENTS`` leaves (more leaves take one launch per group);
  q and bf16 scales go to the packed wire arenas, the leaves come back as
  views of one output arena;
- the row API, ``quantize_rows`` (R, C <= 256) -> (q, fp32 scales (R, 1))
  and ``dequantize_rows``, the Pallas kernels' counterparts: a one-segment
  table. ``quantize_flat`` / ``dequantize_flat`` cut a flat payload into
  256-column rows as the JAX package's ``quantize/ops.py`` does.

CUDA tensors go to the kernels (or raise), CPU tensors to ``ref``. The
table's shape part is cached by the tree's (shape, dtype) signature; a call
fills in the pointers and passes the table by value (no copy to the card).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.quantize import table
from repro_torch.kernels.quantize.ref import (dequantize_ref, dequantize_tree_ref,
                                              quantize_ref, quantize_tree_ref,
                                              roundtrip_tree_ref)

BLOCK_COLS = 256
MAX_COLS = table.MAX_COLS


def _launch(kind: str, group, tab, device) -> None:
    """One launch of ``kind`` ("quantize" / "dequantize") over the filled
    table ``tab`` of ``group``."""
    fn = getattr(build.load("quantize"), f"{kind}_segments")
    with torch.cuda.device(device):
        status = fn(tab.ctypes.data, len(tab), group.rows,
                    torch.cuda.current_stream(device).cuda_stream)
    build.check(status, f"{kind} ({len(tab)} segments, {group.rows} rows)")
    LAUNCHES[kind] += 1


def _fill(group, x, q, s, flags):
    """The group's table with its pointers (x, q, s: one address a segment)
    and flags; a segment whose x and q are aligned for whole vectors takes
    the 16-byte path."""
    tab = group.table.copy()
    tab["x"], tab["q"], tab["s"] = x, q, s
    vec = group.vec_ok & (tab["x"] % table.ALIGN == 0) & (tab["q"] % group.q_align == 0)
    tab["flags"] |= np.asarray(flags, np.int32) | np.where(vec, table.VEC, 0).astype(np.int32)
    return tab


def _check_cuda(device) -> None:
    if device.type != "cuda":
        raise ValueError(f"the quantize kernels run on CUDA tensors, not {device}")


def _quantize_into(plan, xs, q, s) -> None:
    qb, sb = q.data_ptr(), s.data_ptr()
    for g in plan.groups:
        tab = _fill(g, [xs[i].data_ptr() for i in g.leaves], qb + g.q_offs,
                    sb + g.s_offs, table.S_BF16)
        _launch("quantize", g, tab, q.device)


def quantize_tree(leaves, block: int = BLOCK_COLS):
    """leaves -> [(q (*lead, nblocks, b) int8, scales (*lead, nblocks) bf16)]:
    ``compression.quantize_last_axis`` of every leaf, views of the two wire
    arenas."""
    device = table.device_of(leaves)
    if device.type == "cpu":
        return quantize_tree_ref(leaves, block)
    _check_cuda(device)
    plan = table.plan_for(leaves, block)
    q, s = table.wire_arenas(plan, device)
    _quantize_into(plan, table.kernel_inputs(plan, leaves), q, s)
    return table.wire_views(plan, q, s)


def _dequantize_into_arena(plan, device, wire, dtypes):
    """One dequantize launch a group into a new output arena; ``wire(g)``
    gives the group's q pointers, scale pointers and scale flags. Returns
    the leaves, in ``dtypes``."""
    arena, outs = table.out_views(plan, device)
    for g in plan.groups:
        tab = _fill(g, arena.data_ptr() + g.out_offs, *wire(g))
        _launch("dequantize", g, tab, device)
    return table.cast_back(outs, dtypes)


def dequantize_tree(pairs, specs):
    """[(q, scales)] with [(shape, dtype)] -> the leaves in their own shapes
    and types: ``compression.dequantize_last_axis`` of every pair, views of
    one output arena. Scales may be bf16 (the wire's) or fp32."""
    device = table.device_of([t for pair in pairs for t in pair])
    if device.type == "cpu":
        return dequantize_tree_ref(pairs, specs)
    _check_cuda(device)
    plan = table.plan_for_wire(pairs, specs)
    if any(q.dtype != torch.int8 for q, _ in pairs):
        raise TypeError("dequantize takes int8 q")
    pairs = [(q.contiguous(), (s if s.dtype in table.KERNEL_DTYPES
                               else s.to(torch.float32)).contiguous())
             for q, s in pairs]

    def wire(g):
        sel = [pairs[i] for i in g.leaves]
        return ([q.data_ptr() for q, _ in sel], [s.data_ptr() for _, s in sel],
                [table.S_BF16 if s.dtype == torch.bfloat16 else 0 for _, s in sel])

    return _dequantize_into_arena(plan, device, wire, [dt for _, dt in specs])


def roundtrip_tree(leaves, block: int = BLOCK_COLS):
    """Quantize, then dequantize every leaf back to its own shape and type:
    one launch each way, from the wire arenas straight to the output arena."""
    device = table.device_of(leaves)
    if device.type == "cpu":
        return roundtrip_tree_ref(leaves, block)
    _check_cuda(device)
    plan = table.plan_for(leaves, block)
    q, s = table.wire_arenas(plan, device)
    _quantize_into(plan, table.kernel_inputs(plan, leaves), q, s)
    qb, sb = q.data_ptr(), s.data_ptr()
    return _dequantize_into_arena(
        plan, device, lambda g: (qb + g.q_offs, sb + g.s_offs, table.S_BF16),
        [x.dtype for x in leaves])


def quantize_rows(x):
    """x (R, C) fp32|bf16, C <= 256 -> (q int8 (R, C), scales fp32 (R, 1))."""
    if x.dim() != 2:
        raise ValueError(f"quantize_rows takes (R, C), got {tuple(x.shape)}")
    if not x.is_cuda:
        return quantize_ref(x)
    rows, cols = x.shape
    if x.dtype not in table.KERNEL_DTYPES:
        raise TypeError(f"quantize kernel takes fp32 or bf16, got {x.dtype}")
    if not 1 <= cols <= MAX_COLS:
        raise ValueError(f"quantize kernel takes 1..{MAX_COLS} columns, got {cols}")
    x = x.contiguous()
    q = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scales
    (g,) = table.plan((((rows, cols), x.dtype, cols),)).groups
    _launch("quantize", g, _fill(g, [x.data_ptr()], [q.data_ptr()],
                                 [scales.data_ptr()], 0), x.device)
    return q, scales


def dequantize_rows(q, scales, dtype=torch.float32):
    """q (R, C) int8, scales (R, 1) fp32|bf16 -> (R, C) in ``dtype`` (fp32
    or bf16), the Pallas ``dequantize(q, scales, dtype=...)``."""
    if q.dim() != 2:
        raise ValueError(f"dequantize_rows takes (R, C), got {tuple(q.shape)}")
    if dtype not in table.KERNEL_DTYPES:
        raise TypeError(f"dequantize writes fp32 or bf16, not {dtype}")
    if not q.is_cuda:
        return dequantize_ref(q, scales, dtype)
    rows, cols = q.shape
    if q.dtype != torch.int8:
        raise TypeError(f"dequantize kernel takes int8 q, got {q.dtype}")
    if scales.device != q.device or scales.numel() != rows:
        raise ValueError("scales must be (R, 1) on q's device")
    if not 1 <= cols <= MAX_COLS:
        raise ValueError(f"dequantize kernel takes 1..{MAX_COLS} columns, got {cols}")
    q = q.contiguous()
    if scales.dtype not in table.KERNEL_DTYPES:
        scales = scales.to(torch.float32)
    scales = scales.contiguous()
    out = torch.empty((rows, cols), dtype=dtype, device=q.device)
    if rows == 0:
        return out
    (g,) = table.plan((((rows, cols), dtype, cols),)).groups
    flags = table.S_BF16 if scales.dtype == torch.bfloat16 else 0
    _launch("dequantize", g, _fill(g, [out.data_ptr()], [q.data_ptr()],
                                   [scales.data_ptr()], flags), q.device)
    return out


def quantize_flat(x_flat, block_cols: int = BLOCK_COLS):
    """x (D,) -> (q (R, C) int8, scales (R, 1), orig_len)."""
    d = x_flat.numel()
    pad = (-d) % block_cols
    x = x_flat.reshape(-1)
    if pad:
        x = F.pad(x.to(torch.float32), (0, pad))
    q, s = quantize_rows(x.reshape(-1, block_cols))
    return q, s, d


def dequantize_flat(q, scales, orig_len, dtype=torch.float32):
    return dequantize_rows(q, scales).reshape(-1)[:orig_len].to(dtype)
