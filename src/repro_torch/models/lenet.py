"""LeNet-5 (paper §VI: MNIST experiments) as functions over a params dict.

conv5x5(6) -> maxpool2 -> conv5x5(16) -> maxpool2 -> fc120 -> fc84 -> fc10,
tanh activations per the Caffe LeNet used by the paper's solver settings.

The public layouts are the JAX package's: images NHWC, conv weights HWIO,
dense weights (in, out). Inside, activations and conv weights are permuted
to PyTorch's NCHW / OIHW for ``F.conv2d`` (5x5 SAME = padding 2) and
``F.max_pool2d``. The pooled (B, 16, 7, 7) map is permuted back to NHWC
before it is flattened, so ``f1.w`` rows keep the JAX (h, w, c) order.

The ``*_stacked`` functions run M models at once, each on its own batch:
params leaves gain a leading model axis (M, ...) and images are
(M, B, H, W, C). The convolutions are one grouped ``F.conv2d`` (the M
models' channels side by side, ``groups=M``), the dense layers ``bmm``.
No model's output depends on another's params, so the gradient of the
sum of per-model losses is each model's own gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init(generator: torch.Generator, cfg, device="cuda"):
    """Truncated-normal (±2 sigma) fan-in-scaled weights, zero biases, drawn
    from ``generator`` (which must live on ``device``'s type)."""
    c1, c2 = cfg.conv_channels
    f1, f2 = cfg.fc_dims
    spatial = cfg.image_size // 4  # two 2x2 pools
    flat = spatial * spatial * c2

    def trunc(shape, fan_in):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w * (1.0 / fan_in ** 0.5)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return {
        "c1": {"w": trunc((5, 5, cfg.in_channels, c1), 25 * cfg.in_channels),
               "b": zeros(c1)},
        "c2": {"w": trunc((5, 5, c1, c2), 25 * c1), "b": zeros(c2)},
        "f1": {"w": trunc((flat, f1), flat), "b": zeros(f1)},
        "f2": {"w": trunc((f1, f2), f1), "b": zeros(f2)},
        "out": {"w": trunc((f2, cfg.num_classes), f2),
                "b": zeros(cfg.num_classes)},
    }


def _conv(p, x):
    """x NCHW; p["w"] HWIO -> NCHW, 5x5 SAME."""
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=2)


def forward(params, x):
    """x (B, H, W, C) float in [0,1] -> logits (B, classes)."""
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(torch.tanh(_conv(params["c1"], h)), 2)
    h = F.max_pool2d(torch.tanh(_conv(params["c2"], h)), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # JAX (h, w, c) order
    h = torch.tanh(h @ params["f1"]["w"] + params["f1"]["b"])
    h = torch.tanh(h @ params["f2"]["w"] + params["f2"]["b"])
    return h @ params["out"]["w"] + params["out"]["b"]


def _accuracy(logits, labels):
    """Fraction correct as (count / n) with an IEEE divide, as jnp.mean
    computes it (PyTorch's CUDA mean multiplies by 1/n instead)."""
    correct = (torch.argmax(logits, -1) == labels).sum().to(torch.float32)
    return correct / correct.new_tensor(labels.shape[0])


def loss_and_acc(params, batch):
    logits = forward(params, batch["images"])
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    return loss, _accuracy(logits, labels)


def accuracy(params, images, labels):
    return _accuracy(forward(params, images), labels.long())


def _conv_stacked(p, x):
    """x (B, M * Cin, H, W); p["w"] (M, 5, 5, Cin, Cout) HWIO ->
    (B, M * Cout, H, W), 5x5 SAME, one group a model."""
    m, kh, kw, cin, cout = p["w"].shape
    w = p["w"].permute(0, 4, 3, 1, 2).reshape(m * cout, cin, kh, kw)
    return F.conv2d(x, w, p["b"].reshape(m * cout), padding=2, groups=m)


def _dense_stacked(p, h):
    """h (M, B, in) @ w (M, in, out) + b (M, out)."""
    return torch.bmm(h, p["w"]) + p["b"][:, None, :]


def forward_stacked(params, x):
    """x (M, B, H, W, C) -> logits (M, B, classes), model m's params on
    its own batch x[m]."""
    m, b, hh, ww, c = x.shape
    h = x.permute(1, 0, 4, 2, 3).reshape(b, m * c, hh, ww)
    h = F.max_pool2d(torch.tanh(_conv_stacked(params["c1"], h)), 2)
    h = F.max_pool2d(torch.tanh(_conv_stacked(params["c2"], h)), 2)
    c2 = params["c2"]["w"].shape[-1]
    h = h.reshape(b, m, c2, h.shape[-2], h.shape[-1])
    h = h.permute(1, 0, 3, 4, 2).reshape(m, b, -1)      # JAX (h, w, c) order
    h = torch.tanh(_dense_stacked(params["f1"], h))
    h = torch.tanh(_dense_stacked(params["f2"], h))
    return _dense_stacked(params["out"], h)


def _accuracy_stacked(logits, labels):
    """(M,) fractions correct, each ``count / n`` with an IEEE divide."""
    correct = (torch.argmax(logits, -1) == labels).sum(-1).to(torch.float32)
    return correct / correct.new_tensor(labels.shape[-1])


def losses_stacked(params, batch):
    """batch images (M, B, H, W, C), labels (M, B) -> (M,) mean
    cross-entropies, model m's on its own batch."""
    logits = forward_stacked(params, batch["images"])
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold, dim=-1)


def accuracy_stacked(params, images, labels):
    """(M,) accuracies of M models, model m on images[m] / labels[m]."""
    return _accuracy_stacked(forward_stacked(params, images), labels.long())
