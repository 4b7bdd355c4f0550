"""Wrappers for the int8 quantize / dequantize kernels.

``quantize_rows`` / ``dequantize_rows`` work on (R, C) rows with C <= 256;
``quantize_flat`` / ``dequantize_flat`` cut a flat payload into 256-column
rows as the JAX package's ``quantize/ops.py`` does. CUDA tensors go to the
kernel in ``csrc/quantize.cu`` (or raise), CPU tensors to ``ref``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref

BLOCK_COLS = 256
MAX_COLS = 256
_IN_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_rows(x):
    """x (R, C) fp32|bf16, C <= 256 -> (q int8 (R, C), scales fp32 (R, 1))."""
    if x.dim() != 2:
        raise ValueError(f"quantize_rows takes (R, C), got {tuple(x.shape)}")
    if not x.is_cuda:
        return quantize_ref(x)
    rows, cols = x.shape
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"quantize kernel takes fp32 or bf16, got {x.dtype}")
    if not 1 <= cols <= MAX_COLS:
        raise ValueError(f"quantize kernel takes 1..{MAX_COLS} columns, got {cols}")
    x = x.contiguous()
    q = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scales
    fn = getattr(build.load("quantize"), f"quantize_rows_{_IN_DTYPES[x.dtype]}")
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), rows, cols,
                    _stream(x))
    build.check(status, "quantize_rows")
    LAUNCHES["quantize"] += 1
    return q, scales


def dequantize_rows(q, scales):
    """q (R, C) int8, scales (R, 1) fp32 -> (R, C) fp32."""
    if q.dim() != 2:
        raise ValueError(f"dequantize_rows takes (R, C), got {tuple(q.shape)}")
    if not q.is_cuda:
        return dequantize_ref(q, scales)
    rows, cols = q.shape
    if q.dtype != torch.int8:
        raise TypeError(f"dequantize kernel takes int8 q, got {q.dtype}")
    if scales.device != q.device or scales.numel() != rows:
        raise ValueError("scales must be (R, 1) on q's device")
    q = q.contiguous()
    scales = scales.to(torch.float32).contiguous()
    out = torch.empty((rows, cols), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out
    fn = build.load("quantize").dequantize_rows_f32
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), rows, cols,
                    _stream(q))
    build.check(status, "dequantize_rows")
    LAUNCHES["dequantize"] += 1
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
