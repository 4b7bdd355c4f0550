"""Plain PyTorch version of the wfedavg kernel: Eq. 3 on a parameter block.

    out = 0.5 * (sum_n wn[n] * models[n] + prev)

``wn`` are pre-normalized weights (w / w_T); the tree-level wrapper in
ops.py handles normalization and the zero-total-weight fallback.
"""
from __future__ import annotations

import torch


def wfedavg_ref(models, wn, prev):
    """models (N, ...); wn (N,); prev (...) -> (...) in prev.dtype."""
    acc = torch.tensordot(wn.to(torch.float32), models.to(torch.float32),
                          dims=([0], [0]))
    return (0.5 * (acc + prev.to(torch.float32))).to(prev.dtype)
