"""Hand-written CUDA kernels for Hopper (``sm_90a``), one package per TPU
kernel of the JAX package, each with its plain PyTorch version (``ref.py``)
and its wrapper (``ops.py``).

A wrapper given CUDA tensors launches its kernel (built from
``repro_torch/csrc`` at first use, see ``build``) or raises; given CPU
tensors it runs the plain version. ``LAUNCHES`` counts kernel launches per
wrapper, and nothing else, so a run can show that it went through the
kernels.
"""
from __future__ import annotations

import collections

LAUNCHES: collections.Counter = collections.Counter()


# the op-cost walkers that take report_meta's events while they trace
META_SINKS: list = []


def reset_launches() -> None:
    LAUNCHES.clear()


def report_meta(kernel: str, *, flops: float, nbytes: float) -> None:
    """The work of one wrapper call on meta tensors: ``flops`` and the
    ``nbytes`` the kernel it would launch (named as ``LAUNCHES`` names it)
    would read and write. Given to every walker that is tracing."""
    for sink in META_SINKS:
        sink(kernel, flops=flops, nbytes=nbytes)
