"""Wrappers for the clip and AdamW kernels (``csrc/adamw.cu``).

``grad_norm(leaves, max_norm)`` gives the grads' global norm and the clip
scale ``min(1, max_norm / max(norm, 1e-9))``, two 0-d fp32 tensors on the
grads' device. ``adamw_step(g, m, v, p, scale, lr, bc1, bc2, ...)`` makes
one leaf's AdamW step on the grad scaled by ``scale``, writing m, v and p
in place.

CUDA tensors go to the kernels, or raise: g, m, v and p fp32 and
contiguous, the 0-d scale, lr, bc1 and bc2 fp32, all on one device.
``grad_norm`` launches the partial-sum kernel once a non-empty leaf, into
an fp32 scratch of ``sumsq_blocks`` partials a leaf, then the final kernel
once, into a tensor of two floats of its own (a norm that the step's
metrics keep holds 8 bytes, not the scratch); ``LAUNCHES["grad_sumsq"]``
counts both. ``adamw_step`` launches once a non-empty leaf
(``LAUNCHES["adamw_step"]``), writes nothing to g and allocates nothing.
CPU tensors take the plain version (``ref``), which leaves g as it is too.
Meta tensors (the dry-run cell report's trace)
take neither: each launch's work goes to ``kernels.report_meta`` (28 bytes
an element for the update, 4 for the norm and 8 for its result; FLOPs as
the op-cost walker counts them, one a summed element and none for
elementwise work), and only the scratch and the result are allocated, as
on the card. The partial sums' traffic, 4 bytes a block of a leaf (at
most 4 KiB), is left out: it would make a trace's counts step with the
leaves' sizes where the cell report extrapolates them linearly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, launch, report_meta
from repro_torch.kernels.adamw import ref

THREADS = 256          # a partial-sum block's threads (csrc/adamw.cu kThreads)
SUMSQ_BLOCKS = 1024    # the most partial sums a leaf
ADAMW_BYTES = 28       # g, m, v, p read; m, v, p written
SUMSQ_BYTES = 4        # g read

_P, _I, _LL, _F = build.PTR, build.INT, build.LONG, build.FLOAT
ENTRIES = {"adamw": {
    # g, m, v, p, numel; scale, lr, bc1, bc2 (0-d on the card); b1, 1 - b1,
    # b2, 1 - b2, eps, weight decay; stream
    "adamw_step_f32": [_P] * 4 + [_LL] + [_P] * 4 + [_F] * 6 + [_P],
    # g, numel, its partials, their count (blocks); stream
    "grad_sumsq_partial_f32": [_P, _LL, _P, _I, _P],
    # the partials, their count, max_norm, out (norm, scale); stream
    "grad_sumsq_final_f32": [_P, _I, _F, _P, _P],
}}


def sumsq_blocks(n: int) -> int:
    """The partial sums (blocks) of a leaf of ``n`` elements: one a 1024
    elements (a 16-byte load a thread), at most ``SUMSQ_BLOCKS``."""
    return min(-(-n // (4 * THREADS)), SUMSQ_BLOCKS)


def _check(named, device, *, scalar=False):
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"adamw kernels take fp32 {name}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if scalar and t.numel() != 1:
            raise ValueError(f"{name} must hold one element, got {tuple(t.shape)}")
        if not scalar and not t.is_contiguous():
            raise ValueError(f"adamw kernels take a contiguous {name}")


def grad_norm(leaves, max_norm):
    """(the global L2 norm of the grad ``leaves``, the clip scale for
    ``max_norm``), both 0-d fp32 tensors; the grads are left as they are."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("grad_norm takes at least one leaf")
    device = leaves[0].device
    if device.type == "cpu":
        return ref.grad_norm(leaves, max_norm)
    _check([(f"grad {i}", g) for i, g in enumerate(leaves)], device)
    blocks = [sumsq_blocks(g.numel()) for g in leaves]
    total = sum(blocks)
    partial = torch.empty((total,), dtype=torch.float32, device=device)
    out = torch.empty((2,), dtype=torch.float32, device=device)
    if device.type == "meta":
        for g, b in zip(leaves, blocks):
            if b:
                report_meta("grad_sumsq", flops=float(g.numel()),
                            nbytes=float(SUMSQ_BYTES * g.numel()))
        report_meta("grad_sumsq", flops=0.0, nbytes=8.0)
        return out[0], out[1]
    lib = build.load("adamw", ENTRIES["adamw"])
    base, off = partial.data_ptr(), 0
    for g, b in zip(leaves, blocks):
        if b:
            launch(lib, "grad_sumsq_partial_f32", device, g.data_ptr(), g.numel(),
                   base + 4 * off, b, count="grad_sumsq")
            off += b
    launch(lib, "grad_sumsq_final_f32", device, base, total, float(max_norm),
           out.data_ptr(), count="grad_sumsq")
    return out[0], out[1]


def adamw_step(g, m, v, p, scale, lr, bc1, bc2, *, b1, b2, eps, weight_decay):
    """One leaf's AdamW step on ``g * scale``: m, v and p written in place
    (see the module docstring for which tensors each route takes). Returns
    p."""
    hp = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    device = p.device
    if device.type == "cpu":
        return ref.adamw_step(g, m, v, p, scale, lr, bc1, bc2, **hp)
    _check((("g", g), ("m", m), ("v", v), ("p", p)), device)
    _check((("scale", scale), ("lr", lr), ("bc1", bc1), ("bc2", bc2)), device,
           scalar=True)
    if not g.shape == m.shape == v.shape == p.shape:
        raise ValueError(f"shapes differ: g {tuple(g.shape)}, m {tuple(m.shape)}, "
                         f"v {tuple(v.shape)}, p {tuple(p.shape)}")
    n = p.numel()
    if n == 0:
        return p
    if device.type == "meta":
        report_meta("adamw_step", flops=0.0, nbytes=float(ADAMW_BYTES * n))
        return p
    launch(build.load("adamw", ENTRIES["adamw"]), "adamw_step_f32", device,
           g.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(), n, scale.data_ptr(), lr.data_ptr(), bc1.data_ptr(),
           bc2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
           count="adamw_step")
    return p
