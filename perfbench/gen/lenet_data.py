"""The LeNet federation's inputs, drawn on the device from the seed.

A frozen, vectorised copy of the §VI-D recipe's generator: SyntheticMnist
(each class a smooth random 28x28 template, a sample its template shifted
by up to 2 pixels each way plus Gaussian noise), Dirichlet(alpha) label
distributions over the nodes, each node's training pool and held-out
receipt set drawn from its own distribution, one I.I.D. test set; and
LeNet-5's stacked initial params (truncated normal at +-2 sigma, scaled by
fan-in, zero biases). All n nodes are drawn at once. It keeps the recipe's
distributions, not its numbers.
"""
from __future__ import annotations

import torch

from perfbench.seeds import derive

CHUNK = 128          # nodes whose images are gathered at once


def lenet_leaves(model: dict):
    """(name, shape, fan_in) of LeNet-5's params in sorted-key order (the
    program's tree order): biases and HWIO / (in, out) weights."""
    size, cin = model["image_size"], model["in_channels"]
    c1, c2 = model["conv_channels"]
    f1, f2 = model["fc_dims"]
    k = model["kernel"]
    flat = (size // 4) ** 2 * c2
    layers = (("c1", (k, k, cin, c1), k * k * cin), ("c2", (k, k, c1, c2), k * k * c1),
              ("f1", (flat, f1), flat), ("f2", (f1, f2), f1),
              ("out", (f2, model["num_classes"]), f2))
    out = []
    for name, shape, fan_in in layers:
        out.append((f"{name}.b", (shape[-1],), 0))
        out.append((f"{name}.w", shape, fan_in))
    return out


def draw_params(model: dict, n: int, seed: int, device) -> dict:
    """Stacked initial params {layer: {"b", "w"}}, leaves (n, ...), one
    draw a leaf."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "lenet-params", n))
    params = {}
    for name, shape, fan_in in lenet_leaves(model):
        layer, kind = name.split(".")
        if kind == "b":
            leaf = torch.zeros((n, *shape), dtype=torch.float32, device=device)
        else:
            leaf = torch.empty((n, *shape), dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(leaf, 0.0, 1.0, -2.0, 2.0, generator=g)
            leaf.mul_(1.0 / fan_in ** 0.5)
        params.setdefault(layer, {})[kind] = leaf
    return params


def _dirichlet_rows(g, n: int, classes: int, alpha: float, device):
    """(n, classes) label distributions: for each class a Dirichlet(alpha)
    over the nodes, then each node's row normalised. Dirichlet(1) is a
    normalised vector of unit exponentials."""
    if alpha != 1.0:
        raise ValueError(f"the generator draws Dirichlet(1) only, not {alpha}")
    u = torch.rand((classes, n), generator=g, device=device, dtype=torch.float64)
    e = -torch.log1p(-u)
    mat = (e / e.sum(1, keepdim=True)).T
    return (mat / mat.sum(1, keepdim=True).clamp_min(1e-9)).to(torch.float32)


def _samples(g, templates, probs, count: int, noise: float):
    """``count`` images a row of ``probs``: (m, count, S, S, 1) fp32 and
    (m, count) int32 labels."""
    m, size = probs.shape[0], templates.shape[-1]
    dev = templates.device
    labels = torch.multinomial(probs, count, replacement=True, generator=g)
    shift = torch.randint(-2, 3, (m, count, 2), generator=g, device=dev)
    ar = torch.arange(size, device=dev)
    images = torch.empty((m, count, size, size), dtype=torch.float32, device=dev)
    for lo in range(0, m, CHUNK):
        hi = min(m, lo + CHUNK)
        rows = (ar - shift[lo:hi, :, 0, None]) % size        # np.roll along H
        cols = (ar - shift[lo:hi, :, 1, None]) % size        # then along W
        images[lo:hi] = templates[labels[lo:hi, :, None, None], rows[..., :, None],
                                  cols[..., None, :]]
    images += noise * torch.randn(images.shape, generator=g, device=dev)
    return images[..., None], labels.to(torch.int32)


def draw_inputs(recipe: dict, model: dict, n: int, seed: int, device) -> dict:
    """The federation's data: train pools, receipt sets and the test set,
    and each node's label distribution."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "lenet-data", n))
    size, classes = model["image_size"], model["num_classes"]
    base = torch.randn((classes, size // 4, size // 4), generator=g, device=device)
    templates = (base.repeat_interleave(4, 1).repeat_interleave(4, 2)
                 .clamp(-2.0, 2.0) * 0.5 + 0.5)
    probs = _dirichlet_rows(g, n, classes, recipe["alpha"], device)
    noise = recipe["noise"]
    tr_i, tr_l = _samples(g, templates, probs, recipe["pool"], noise)
    ev_i, ev_l = _samples(g, templates, probs, recipe["eval_size"], noise)
    uniform = torch.full((1, classes), 1.0 / classes, device=device)
    te_i, te_l = _samples(g, templates, uniform, recipe["test_size"], noise)
    return {"class_probs": probs, "train_images": tr_i, "train_labels": tr_l,
            "eval_images": ev_i, "eval_labels": ev_l,
            "test_images": te_i[0], "test_labels": te_l[0]}
