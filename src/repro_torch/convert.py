"""Carry parameter trees between the JAX package and the port through numpy.

``params_from_jax`` takes a nested dict of numpy arrays (``jax.tree.map(
np.asarray, params)`` on the JAX side) and returns the same dict of tensors
on ``device``, bit for bit and in the same layouts (LeNet keeps HWIO and
(in, out) weights), so both packages compute the same function.
``params_to_numpy`` goes the other way. Neither imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import tree


def _to_tensor(x, dev):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: widen exactly, narrow back
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def params_from_jax(tree_of_numpy, device="cuda"):
    dev = device_lib.resolve(device)
    return tree.map(lambda x: _to_tensor(x, dev), tree_of_numpy)


def params_to_numpy(params):
    """Tensors -> numpy on the host; bf16 leaves come back as float32 (numpy
    has no bf16 of its own), which is exact."""
    def leaf(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()

    return tree.map(leaf, params)
