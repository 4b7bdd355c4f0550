"""Wrappers for the wfedavg kernel: flat Eq. 3 and tree-level weighted FedAvg.

``weighted_fedavg_tree`` keeps the JAX wrapper's contract: weights are
normalized, the previous model is kept when the total weight is <= EPS
(a ``torch.where``, no host sync), and leaves under 4096 elements or of a
non-float dtype take plain math. Larger float leaves are flattened to
(N, D) and go through ``wfedavg_flat``: the CUDA kernel on CUDA tensors,
the plain version on CPU tensors. No padding: the kernel masks its own
ragged edge.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import fedavg
from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.wfedavg.ref import wfedavg_ref

MIN_KERNEL_ELEMS = 4096


def wfedavg_flat(models, wn, prev):
    """models (N, D) fp32; wn (N,) fp32; prev (D,) fp32 -> (D,) fp32."""
    if models.dim() != 2 or prev.dim() != 1 or wn.dim() != 1:
        raise ValueError("wfedavg_flat takes models (N, D), wn (N,), prev (D,)")
    n, d = models.shape
    if wn.shape[0] != n or prev.shape[0] != d:
        raise ValueError(f"shape mismatch: models {tuple(models.shape)}, "
                         f"wn {tuple(wn.shape)}, prev {tuple(prev.shape)}")
    if not models.is_cuda:
        return wfedavg_ref(models, wn, prev)
    for name, t in (("models", models), ("wn", wn), ("prev", prev)):
        if t.dtype != torch.float32:
            raise TypeError(f"wfedavg kernel takes fp32 {name}, got {t.dtype}")
        if t.device != models.device:
            raise ValueError(f"{name} is on {t.device}, models on {models.device}")
    if n < 1:
        raise ValueError("wfedavg kernel needs N >= 1 models")
    models, wn, prev = models.contiguous(), wn.contiguous(), prev.contiguous()
    out = torch.empty((d,), dtype=torch.float32, device=models.device)
    if d == 0:
        return out
    with torch.cuda.device(models.device):
        status = build.load("wfedavg").wfedavg_f32(
            models.data_ptr(), wn.data_ptr(), prev.data_ptr(), out.data_ptr(),
            n, d, torch.cuda.current_stream(models.device).cuda_stream)
    build.check(status, "wfedavg_flat")
    LAUNCHES["wfedavg"] += 1
    return out


def weighted_fedavg_tree(stacked_models, weights, prev_model):
    """Eq. 3 over a tree with stacked leading dim N (kernel-accelerated)."""
    wn, safe = fedavg.normalized_weights(weights)

    def leaf(ms, prev):
        pf = prev.to(torch.float32)
        if prev.numel() < MIN_KERNEL_ELEMS or not prev.is_floating_point():
            mf = ms.to(torch.float32).reshape(ms.shape[0], -1)
            avg = torch.tensordot(wn, mf, dims=([0], [0]))
            out = 0.5 * (avg.reshape(prev.shape) + pf)
        else:
            n = ms.shape[0]
            out = wfedavg_flat(ms.reshape(n, -1).to(torch.float32), wn,
                               pf.reshape(-1)).reshape(prev.shape)
        return torch.where(safe, out, pf).to(prev.dtype)

    return tree.map(leaf, stacked_models, prev_model)
