"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU, and never a silent fallback from one to the other."""
from __future__ import annotations

import contextlib

import torch

from repro_torch import tree


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no CUDA
    device is usable (the CPU runs only when asked for explicitly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def of(params) -> torch.device:
    """The device a tensor (or the first leaf of a params tree) lives on."""
    return tree.leaves(params)[0].device


@contextlib.contextmanager
def deterministic():
    """Holds cuDNN to deterministic algorithms for the ``with`` body and
    restores the caller's setting after it: both simulators run inside it,
    so a seeded run gives the same bits on the card every time."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old
