"""LeNet-5 in plain PyTorch over stacks of models, each model's params one
flat fp32 vector (the leaves of ``gen.lenet_data.lenet_leaves`` in order,
each row-major).

conv 5x5 SAME (an unfold and a product) -> tanh -> 2x2 max pool, twice;
the pooled map flattened in (h, w, c) order; three dense layers, tanh
between them. Loss: mean cross entropy. SGD: p - lr * grad, one step a
batch. Accuracy: count of argmax hits over the count of samples.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.gen.lenet_data import lenet_leaves
from perfbench.reference import wire


class Layout:
    """Offsets of each leaf in a model's flat vector."""

    def __init__(self, model: dict):
        self.model = model
        self.leaves = lenet_leaves(model)
        self.offsets, off = {}, 0
        for name, shape, _ in self.leaves:
            size = 1
            for d in shape:
                size *= d
            self.offsets[name] = (off, off + size, shape)
            off += size
        self.size = off

    def split(self, vec):
        """{name: (M, *shape) view} of (M, size) vectors."""
        return {name: vec[:, a:b].reshape(vec.shape[0], *shape)
                for name, (a, b, shape) in self.offsets.items()}

    def flatten(self, tree: dict, rows=None):
        """(M, size) vectors from a {layer: {"b", "w"}} tree of (n, ...)
        leaves (``rows`` of them, when given)."""
        parts = []
        for name, _, _ in self.leaves:
            layer, kind = name.split(".")
            leaf = tree[layer][kind]
            leaf = leaf if rows is None else leaf[rows]
            parts.append(leaf.reshape(leaf.shape[0], -1))
        return torch.cat(parts, 1)


def round_tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest even), held in fp32;
    the gradient passes through unchanged."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return x + (i.view(torch.float32) - x).detach()


_OPERANDS = {None: lambda x: x, "tf32": round_tf32}


def _conv(x, w, b, rnd):
    """x (M, B, C, H, W); w (M, k, k, C, O) HWIO; b (M, O): SAME padding."""
    m, bsz, c, h, wd = x.shape
    k, o = w.shape[1], w.shape[-1]
    cols = F.unfold(x.reshape(m * bsz, c, h, wd), k, padding=k // 2)
    cols = cols.reshape(m, bsz, c * k * k, h * wd)
    wk = w.permute(0, 3, 1, 2, 4).reshape(m, c * k * k, o)       # (c, kh, kw)
    y = torch.einsum("mbkp,mko->mbop", rnd(cols), rnd(wk)) + b[:, None, :, None]
    return y.reshape(m, bsz, o, h, wd)


def _pool(y):
    m, bsz, c, h, w = y.shape
    return F.max_pool2d(y.reshape(m * bsz, c, h, w), 2).reshape(m, bsz, c, h // 2, w // 2)


def _dense(h, w, b, rnd):
    return torch.einsum("mbi,mio->mbo", rnd(h), rnd(w)) + b[:, None, :]


def pool_margin(y):
    """(M,) smallest gap between the largest and the second largest value
    of a 2x2 pooling window of y (M, B, C, H, W), over every window."""
    m, bsz, c, h, w = y.shape
    win = y.detach().reshape(m, bsz, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 3, 5, 4, 6)
    top = win.reshape(m, -1, 4).topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).amin(1)


def forward(p: dict, x, operands=None, margins=None):
    """p from ``Layout.split``; x (M, B, H, W, C) -> logits (M, B, classes).
    ``operands="tf32"`` rounds every product's operands to TF32 (the
    control). ``margins``, a list, gets each pooling's ``pool_margin``."""
    rnd = _OPERANDS[operands]
    h = x.permute(0, 1, 4, 2, 3)
    for layer in ("c1", "c2"):
        y = torch.tanh(_conv(h, p[f"{layer}.w"], p[f"{layer}.b"], rnd))
        if margins is not None:
            margins.append(pool_margin(y))
        h = _pool(y)
    h = h.permute(0, 1, 3, 4, 2).reshape(h.shape[0], h.shape[1], -1)
    h = torch.tanh(_dense(h, p["f1.w"], p["f1.b"], rnd))
    h = torch.tanh(_dense(h, p["f2.w"], p["f2.b"], rnd))
    return _dense(h, p["out.w"], p["out.b"], rnd)


def losses(layout, vec, images, labels, operands=None, margins=None):
    logits = forward(layout.split(vec), images, operands, margins)
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean(-1)


def sgd(layout, vec, images, labels, lr: float, operands=None, margins=None):
    """Plain SGD of M models: step s on images[:, s] (M, steps, B, H, W, C).
    ``margins``, a list, gets every pooling's ``pool_margin``."""
    p = vec
    for s in range(images.shape[1]):
        leaf = p.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = losses(layout, leaf, images[:, s], labels[:, s], operands,
                          margins).sum()
            (grad,) = torch.autograd.grad(loss, leaf)
        p = leaf.detach() - lr * grad
    return p


def accuracy(layout, vec, images, labels, chunk: int = 16, operands=None):
    """(M,) fractions of argmax hits, model m on images[m] (M, B, ...)."""
    out = []
    with torch.no_grad():
        for lo in range(0, vec.shape[0], chunk):
            logits = forward(layout.split(vec[lo:lo + chunk]), images[lo:lo + chunk],
                             operands)
            hits = (logits.argmax(-1) == labels[lo:lo + chunk].long()).sum(-1)
            out.append(hits.to(torch.float32) / labels.shape[-1])
    return torch.cat(out)


def roundtrip(layout, vec):
    """Each model's leaves through the int8 wire: the received vectors."""
    return torch.cat([wire.roundtrip_leaf(leaf)[0].reshape(vec.shape[0], -1)
                      for leaf in layout.split(vec).values()], 1)
