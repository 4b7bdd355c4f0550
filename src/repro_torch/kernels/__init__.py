"""The port's hand-written CUDA kernels for Hopper (``sm_90a``), one package
per kernel family: ``quantize`` (K1/K2), ``wfedavg`` (K3) and
``flash_attention`` (K4 and its backward) stand for the JAX package's TPU
kernels, ``adamw`` (the train step's clip and AdamW) for none. Each holds
its plain PyTorch version (``ref.py``) and its wrapper (``ops.py``), which
declares the C signatures of the library or libraries it calls
(``ENTRIES``: source name -> entry -> argument types).

A wrapper given CUDA tensors launches its kernel (built from
``repro_torch/csrc`` at first use, see ``build``) through ``launch`` or
raises; given CPU tensors it runs the plain version. ``LAUNCHES`` counts
kernel launches per wrapper, and nothing else, so a run can show that it
went through the kernels. Given meta tensors a wrapper launches nothing and
reports its kernel's work to the op-cost walkers that are tracing
(``WALKERS``, ``report_meta``); the gossip exchange reports its bytes there
too (``report_collective``).
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import build

LAUNCHES: collections.Counter = collections.Counter()

# the op-cost walkers (``launch.op_cost.OpCost``) tracing now
WALKERS: list = []


def reset_launches() -> None:
    LAUNCHES.clear()


def launch(lib, entry: str, device, *args, count, what: str = "") -> None:
    """One launch of ``lib``'s C entry ``entry`` on ``device``'s current
    stream (passed after ``args``), its status checked (a failure names
    ``what``, or else the entry); then ``count`` (a ``LAUNCHES`` key, or a
    tuple of keys) goes up by one. No sync, no allocation, no host read."""
    with torch.cuda.device(device):
        status = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    build.check(status, what or entry)
    for key in ((count,) if isinstance(count, str) else count):
        LAUNCHES[key] += 1


def report_meta(kernel: str, *, flops: float, nbytes: float) -> None:
    """The work of one wrapper call on meta tensors: ``flops`` and the
    ``nbytes`` the kernel it would launch (named as ``LAUNCHES`` names it)
    would read and write. Given to every walker that is tracing."""
    for walker in WALKERS:
        walker.kernel(kernel, flops=flops, nbytes=nbytes)


def report_collective(kind: str, nbytes: float) -> None:
    """A collective of ``kind`` ("collective-permute", ...) moving ``nbytes``
    from this device, for every walker that is tracing."""
    for walker in WALKERS:
        walker.collective(kind, nbytes)
