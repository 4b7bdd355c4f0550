"""An LM's fp32 training params drawn on the device from the seed, one
call a leaf, in the tree layout the program's model reads (taken from its
abstract params on the meta device, which hold no numbers).

Each leaf has a generator of its own, keyed by the seed and the leaf's
path, so one leaf can be drawn again alone (the reference and the change
after the first steps read the initial params that the program overwrote).
Norm scales are ones, biases zeros, weights a truncated normal (+-2 sigma)
scaled by the fan-in of the dims a weight contracts, embedding tables by
their width.
"""
from __future__ import annotations

import math

import torch

from perfbench.seeds import derive


def leaf_paths(tree, prefix=()):
    """(path, leaf) pairs in sorted-key order (the program's tree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], (*prefix, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, (*prefix, str(i)))
    else:
        yield prefix, tree


def _fan_in(path, shape):
    lead = 1 if path[0] == "units" else 0
    dims = 2 if path[-2] == "o" else 1      # o contracts (heads, head_dim)
    return math.prod(shape[lead:lead + dims])


def draw_leaf(path, shape, seed: int, device) -> torch.Tensor:
    """One fp32 leaf of the params at ``path`` (a tuple of keys)."""
    key = path[-1]
    if key == "scale":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if key in ("b", "bias"):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "lm-params", "/".join(path)))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
    std = shape[-1] ** -0.5 if key == "table" else _fan_in(path, shape) ** -0.5
    return t.mul_(std)


def draw_params(like, seed: int, device):
    """A tree shaped like ``like`` (meta tensors) with every leaf drawn."""
    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(t[k], (*prefix, k)) for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, (*prefix, str(i))) for i, v in enumerate(t))
        return draw_leaf(prefix, tuple(t.shape), seed, device)
    return build(like, ())
