"""Wrapper for the flash-attention forward kernels.

``flash_attention`` takes the model's layout, q (B, Sq, H, Dh) and k/v
(B, Skv, KH, Dh), strided, and hands the strides to the kernel: no
transpose, no repeat of kv heads, no head-dim pad and no sequence pad (the
Pallas wrapper's TPU artefacts). CPU tensors go to the plain version in
``ref``; CUDA tensors to one of two hand-written kernels, chosen before any
launch by ``_variant`` from dtype, head dim, alignment and strides:

- ``"sm90"`` (``csrc/flash_attention_sm90.cu``): bf16 on the tensor cores
  (wgmma, TMA, a producer warp), for bf16 q, k, v with Dh in 64 / 128 /
  256, 16-byte aligned base pointers and every batch, sequence and head
  stride a positive multiple of 8 elements (what a TMA tensor map takes);
- ``"simt"`` (``csrc/flash_attention.cu``): everything else the wrappers
  take, fp32 (the tensor cores would need TF32) and the other head dims or
  views.

This is routing by shape, not a fallback: a kernel that fails to build,
encode or launch raises, and the call is never retried on the other one.
``LAUNCHES["flash_attention"]`` counts every launch of either kernel,
``LAUNCHES["flash_attention_sm90"]`` the sm90 kernel's alone.

``return_lse=True`` has the kernel also write each row's log-sum-exp,
(B, H, Sq) fp32, ``m + log(max(l, 1e-37))`` from its running max m and
denominator l, which the training backward reads; a call without it passes
a null pointer and the kernel writes none.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.flash_attention.ref import attention_ref

MAX_HEAD_DIM = 256
SM90_HEAD_DIMS = (64, 128, 256)
_ENTRY = {torch.float32: "flash_attention_fwd_f32",
          torch.bfloat16: "flash_attention_fwd_bf16"}


def _variant(q, k, v) -> str:
    """Which kernel a CUDA call launches: "sm90" when the Hopper kernel
    takes q, k, v as they are, else "simt". Pure: reads dtypes, shapes,
    strides and base addresses only."""
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.shape[-1] not in SM90_HEAD_DIMS:
            return "simt"
        if t.data_ptr() % 16 or t.stride(3) != 1:
            return "simt"
        if any(s <= 0 or s % 8 for s in t.stride()[:3]):
            return "simt"
    return "sm90"


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    return_lse=False):
    """Masked softmax attention; query head h reads kv head h // (H // KH).

    ``scale`` defaults to Dh ** -0.5. Returns (B, Sq, H, Dh) in q.dtype;
    with ``return_lse``, (out, lse) with lse (B, H, Sq) fp32."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, Sq, H, Dh), k/v (B, Skv, "
                         f"KH, Dh); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, Dh = q.shape
    KH = k.shape[2]
    if k.shape[0] != B or k.shape[3] != Dh or KH < 1 or H % KH:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    scale = Dh ** -0.5 if scale is None else float(scale)
    if not q.is_cuda:
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                             return_lse=return_lse)
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes fp32 or bf16 q, k, v of one dtype; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if Dh > MAX_HEAD_DIM or Dh % 8:
        raise ValueError(f"flash kernel takes a head dim <= {MAX_HEAD_DIM} and a "
                         f"multiple of 8, got {Dh}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash kernel takes a unit stride along the head dim")
    out = torch.empty((B, Sq, H, Dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B == 0 or Sq == 0 or H == 0:
        return (out, lse) if return_lse else out
    if k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one key")
    variant = _variant(q, k, v)
    if variant == "sm90":
        source, entry = "flash_attention_sm90", "flash_attention_fwd_sm90_bf16"
    else:
        source, entry = "flash_attention", _ENTRY[q.dtype]
    with torch.cuda.device(q.device):
        status = getattr(build.load(source), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr(), B, H, KH, Sq, k.shape[1], Dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(bool(causal)), int(window), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, source)
    LAUNCHES["flash_attention"] += 1
    if variant == "sm90":
        LAUNCHES["flash_attention_sm90"] += 1
    return (out, lse) if return_lse else out
