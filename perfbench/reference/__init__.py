"""Plain references: PyTorch and NumPy only, nothing of the program.

They work out again, from the inputs the benchmark handed both sides,
what the program derived, and read the program's outputs only to judge
them. Matrix products run in fp32 with TF32 off unless a control asks for
a lower precision (``precision``).
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """fp32 products (TF32 off) for the body; ``tf32=True`` is the
    control one precision below."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
