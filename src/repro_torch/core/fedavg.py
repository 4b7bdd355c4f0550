"""Reputation-weighted federated averaging — the paper's Eq. 2 and Eq. 3.

    weight_n     = reputation_n * accuracy_n                      (Eq. 2)
    model_out    = (sum_n weight_n / weight_T * model_n + model_prev) / 2   (Eq. 3)

Two equivalent forms, as in the JAX package:
* ``weighted_fedavg``       — stacked models (N, ...) tree; the heap node's
  FedAvg buffer (``repro_torch.kernels.wfedavg`` is its kernel form).
* ``streaming_accumulator`` — running (sum_w_model, sum_w) pair.

If the total weight is ~0 (every sender's reputation crushed to 0), the
previous model is kept unchanged. The choice is a ``torch.where`` on a
device tensor, so no path reads the weights back to the host.

The streaming form works in the accumulator's tensors: ``streaming_add``
adds into them and ``streaming_finish`` writes the result there (a state
is consumed by the call that takes it; at LM size each copy is the size of
the model). The arithmetic is the JAX package's, operation for operation.
"""
from __future__ import annotations

import torch

from repro_torch import tree

EPS = 1e-12


def model_weights(reputation, accuracy):
    """Eq. 2. Both in [0, 1]; elementwise product."""
    return reputation * accuracy


def normalized_weights(weights):
    """(wn, safe): ``w / w_T`` in fp32, zeros when ``w_T <= EPS``."""
    w = weights.to(torch.float32)
    w_t = w.sum()
    safe = w_t > EPS
    wn = torch.where(safe, w / torch.clamp_min(w_t, EPS), torch.zeros_like(w))
    return wn, safe


def weighted_fedavg(stacked_models, weights, prev_model):
    """Eq. 3 over stacked models (leading dim N). fp32 math."""
    wn, safe = normalized_weights(weights)

    def leaf(ms, prev):
        mf = ms.to(torch.float32)
        avg = torch.tensordot(wn, mf, dims=([0], [0]))
        pf = prev.to(torch.float32)
        out = 0.5 * (avg + pf)
        return torch.where(safe, out, pf).to(prev.dtype)

    return tree.map(leaf, stacked_models, prev_model)


def streaming_init(model_like):
    acc = tree.map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device), model_like)
    return acc, torch.zeros((), dtype=torch.float32,
                            device=tree.leaves(model_like)[0].device)


def streaming_add(acc_state, model, weight):
    acc, w_t = acc_state
    w = torch.as_tensor(weight, device=w_t.device).to(torch.float32)
    acc = tree.map(lambda a, m: a.add_(w * m.to(torch.float32)), acc, model)
    return acc, w_t + w


def streaming_finish(acc_state, prev_model):
    """Eq. 3 from the running sums."""
    acc, w_t = acc_state
    safe = w_t > EPS

    def leaf(a, prev):
        pf = prev.to(torch.float32)
        out = a.div_(torch.clamp_min(w_t, EPS)).add_(pf).mul_(0.5)
        return torch.where(safe, out, pf, out=out).to(prev.dtype)

    return tree.map(leaf, acc, prev_model)
