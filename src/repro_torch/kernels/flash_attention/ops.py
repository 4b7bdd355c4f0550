"""Wrappers for the flash-attention kernels: the forward and its backward.

``flash_attention`` takes the model's layout, q (B, Sq, H, Dh) and k/v
(B, Skv, KH, Dh), strided, and hands the strides to the kernel: no
transpose, no repeat of kv heads, no head-dim pad and no sequence pad (the
Pallas wrapper's TPU artefacts). CPU tensors go to the plain version in
``ref``; CUDA tensors to one of two hand-written kernels, chosen before any
launch by ``_variant`` from dtype, head dim, alignment and strides:

- ``"sm90"`` (``csrc/flash_attention_sm90.cu``): bf16 on the tensor cores
  (wgmma, TMA, a producer warp), for bf16 q, k, v with Dh in 64 / 80 /
  128 / 256, 16-byte aligned base pointers and every batch, sequence and
  head stride a positive multiple of 8 elements (what a TMA tensor map
  takes);
- ``"simt"`` (``csrc/flash_attention.cu``): everything else the wrappers
  take, fp32 (the tensor cores would need TF32) and the other head dims or
  views.

This is routing by shape, not a fallback: a kernel that fails to build,
encode or launch raises, and the call is never retried on the other one.
``LAUNCHES["flash_attention"]`` counts every launch of either kernel,
``LAUNCHES["flash_attention_sm90"]`` the sm90 kernel's alone.

Meta tensors (the dry-run cell report's trace) take neither route: the
wrapper returns empty meta outputs of the kernel's shapes and reports the
kernel's work to ``kernels.report_meta`` (``_report_meta``): 4 B H Dh FLOPs
a kept (query, key) pair, Q.K and P.V, over the pairs the causal mask and
the window keep; q, k, v read once and O (and the lse) written once.

``return_lse=True`` has the kernel also write each row's log-sum-exp,
(B, H, Sq) fp32, ``m + log(max(l, 1e-37))`` from its running max m and
denominator l, which the training backward reads; a call without it passes
a null pointer and the kernel writes none.

``flash_attention_backward`` is the training VJP from (q, k, v, out, lse,
dout). CPU and meta tensors take the plain version (``ref.flash_backward``;
the cell report traces it, as the JAX package's backward is jnp); CUDA
tensors are routed by ``_bwd_variant`` before any launch: ``"sm90"``
(``csrc/flash_attention_bwd_sm90.cu``) for what the sm90 forward takes at
Dh 64 or 128 with a TMA-ready out and dout, ``"plain"`` for the rest.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, build, launch, report_meta
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_backward

MAX_HEAD_DIM = 256
SM90_HEAD_DIMS = (64, 80, 128, 256)
SM90_BWD_HEAD_DIMS = (64, 128)
_ENTRY = {torch.float32: "flash_attention_fwd_f32",
          torch.bfloat16: "flash_attention_fwd_bf16"}

_P, _I, _LL, _F = build.PTR, build.INT, build.LONG, build.FLOAT
# a forward: q, k, v, o, lse (null: none written); batch, H, KH, Sq, Skv, Dh;
# (batch, seq, head) strides of q, k, v, o in elements; causal, window,
# scale; stream
_FORWARD = [_P] * 5 + [_I] * 6 + [_LL] * 12 + [_I, _I, _F, _P]
ENTRIES = {
    "flash_attention": {"flash_attention_fwd_f32": _FORWARD,
                        "flash_attention_fwd_bf16": _FORWARD},
    "flash_attention_sm90": {"flash_attention_fwd_sm90_bf16": _FORWARD,
                             # Dh -> the kernel's dynamic shared memory a block
                             "flash_attention_sm90_smem_bytes": [_I]},
    "flash_attention_bwd_sm90": {
        # q, k, v, out, dout, lse, dq, dk, dv, scratch; the scratch's
        # floats; batch, H, KH, Sq, Skv, Dh; (batch, seq, head) strides of
        # q, k, v, out, dout; causal, window, scale; stream
        "flash_attention_bwd_sm90_bf16": [_P] * 10 + [_LL] + [_I] * 6 + [_LL] * 15
                                         + [_I, _I, _F, _P],
        # batch, H, KH, Sq, Skv, Dh; out: the scratch's 4-byte words
        "flash_attention_bwd_sm90_scratch": [_I] * 6 + [ctypes.POINTER(_LL)],
    },
}


def _tma_ready(t, head_dims) -> bool:
    """A bf16 (B, S, heads, Dh) tensor with Dh in ``head_dims`` that a TMA
    tensor map takes as it is: a 16-byte aligned base, a unit head-dim
    stride and batch, sequence and head strides that are positive multiples
    of 8 elements."""
    return (t.dtype == torch.bfloat16 and t.dim() == 4 and t.shape[-1] in head_dims
            and t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and all(s > 0 and s % 8 == 0 for s in t.stride()[:3]))


def _variant(q, k, v) -> str:
    """Which kernel a CUDA call launches: "sm90" when the Hopper kernel
    takes q, k, v as they are, else "simt". Pure: reads dtypes, shapes,
    strides and base addresses only."""
    return "sm90" if all(_tma_ready(t, SM90_HEAD_DIMS) for t in (q, k, v)) else "simt"


def _bwd_variant(q, k, v, out, lse, dout) -> str:
    """Which backward a CUDA call takes: "sm90" when the Hopper kernel takes
    the tensors as they lie (bf16 q, k, v, out and dout at Dh 64 or 128,
    each as a TMA tensor map takes it, out and dout of q's shape, and the
    forward's contiguous (B, H, Sq) fp32 lse), else "plain": the simt
    forward's shapes and the other head dims. Pure, as the forward's
    ``_variant``: reads dtypes, shapes, strides and base addresses only."""
    ok = (out.shape == q.shape == dout.shape
          and all(_tma_ready(t, SM90_BWD_HEAD_DIMS) for t in (q, k, v, out, dout))
          and lse.dtype == torch.float32 and lse.is_contiguous()
          and tuple(lse.shape) == (q.shape[0], q.shape[2], q.shape[1]))
    return "sm90" if ok else "plain"


def kept_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head keeps: query i (at position i, as the
    kernels place both axes from 0) sees keys j <= i under ``causal`` and
    j > i - ``window`` under a window."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Skv) if causal else np.full_like(i, Skv)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    return int(np.maximum(hi - lo, 0).sum())


def _report_meta(q, k, v, out, lse, causal, window) -> None:
    B, Sq, H, Dh = q.shape
    pairs = kept_pairs(Sq, k.shape[1], causal, window)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    if lse is not None:
        nbytes += lse.numel() * lse.element_size()
    report_meta("flash_attention_sm90" if _variant(q, k, v) == "sm90"
                else "flash_attention", flops=4.0 * B * H * Dh * pairs, nbytes=nbytes)


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
    if q.is_meta:
        out = torch.empty((B, Sq, H, Dh), dtype=q.dtype, device=q.device)
        lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
               if return_lse else None)
        _report_meta(q, k, v, out, lse, causal, window)
        return (out, lse) if return_lse else out
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
    if _variant(q, k, v) == "sm90":
        source, entry = "flash_attention_sm90", "flash_attention_fwd_sm90_bf16"
        count = ("flash_attention", "flash_attention_sm90")
    else:
        source, entry, count = "flash_attention", _ENTRY[q.dtype], "flash_attention"
    launch(build.load(source, ENTRIES[source]), entry, q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           0 if lse is None else lse.data_ptr(), B, H, KH, Sq, k.shape[1], Dh,
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
           int(bool(causal)), int(window), scale, count=count)
    return (out, lse) if return_lse else out


def flash_attention_backward(q, k, v, out, lse, dout, *, causal, window, scale=None):
    """The VJP of ``flash_attention`` from what its training call saved: q,
    out, dout (B, Sq, H, Dh), k/v (B, Skv, KH, Dh) and the lse (B, H, Sq)
    fp32. Returns (dq, dk, dv) in the dtypes of q, k, v; dk and dv hold the
    sum over each kv head's G query heads.

    CPU and meta tensors run ``ref.flash_backward``. For CUDA tensors
    ``_bwd_variant`` picks the route before any launch: "sm90" launches the
    hand-written backward (``csrc/flash_attention_bwd_sm90.cu``: a delta
    and lse pass, the products on the tensor cores, fp32 accumulators
    reduced across blocks in a fixed order, a bf16 pass) or raises; "plain"
    runs ``ref.flash_backward``. ``LAUNCHES["flash_attention_bwd_sm90"]`` counts
    the kernel's calls, ``LAUNCHES["flash_backward_plain"]`` the CUDA calls
    that took the plain route."""
    Dh = q.shape[-1]
    scale = Dh ** -0.5 if scale is None else float(scale)
    if not q.is_cuda or _bwd_variant(q, k, v, out, lse, dout) != "sm90":
        if q.is_cuda:
            LAUNCHES["flash_backward_plain"] += 1
        return flash_backward(q, k, v, out, lse, dout, causal=causal, window=window,
                              scale=scale)
    B, Sq, H, _ = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    dq = torch.empty((B, Sq, H, Dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, KH, Dh), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if B == 0 or Sq == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = build.load("flash_attention_bwd_sm90", ENTRIES["flash_attention_bwd_sm90"])
    words = ctypes.c_longlong()   # the kernel's fp32 accumulators, counters and rows
    build.check(lib.flash_attention_bwd_sm90_scratch(B, H, KH, Sq, Skv, Dh,
                                                     ctypes.byref(words)),
                "flash_attention_bwd_sm90")
    scratch = torch.empty(words.value, dtype=torch.float32, device=q.device)
    launch(lib, "flash_attention_bwd_sm90_bf16", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           scratch.data_ptr(), words.value, B, H, KH, Sq, Skv, Dh,
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
           *dout.stride()[:3], int(bool(causal)), int(window), scale,
           count="flash_attention_bwd_sm90")
    return dq, dk, dv
