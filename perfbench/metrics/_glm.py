"""A dense GQA decoder's counts from its configuration (the benchmark's
own arithmetic)."""
from __future__ import annotations


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal mask keeps in one head of an S x S call."""
    return S * (S + 1) // 2


def flash_fwd_flops(arch: dict, B: int, S: int) -> float:
    """One attention forward of a layer: Q.K and P.V, 2 FLOPs a
    multiply-add, over the causal band."""
    Dh = arch.get("head_dim") or arch["d_model"] // arch["num_heads"]
    return 4.0 * B * arch["num_heads"] * Dh * causal_pairs(S)


def multiplying_params(arch: dict) -> int:
    """Params that multiply: q, k, v, o, gate, up, down a layer and the
    unembedding; the embedding lookup, norms and biases do not."""
    d, H, KH = arch["d_model"], arch["num_heads"], arch["num_kv_heads"]
    Dh = arch.get("head_dim") or d // H
    layer = d * (H + 2 * KH) * Dh + H * Dh * d + 3 * d * arch["d_ff"]
    return arch["num_layers"] * layer + arch["vocab_size"] * d


def step_flops(arch: dict, B: int, S: int) -> float:
    """Model FLOPs of a training step: 6 x multiplying params x tokens, plus
    the causal attention's forward and backward (3 forwards); the remat
    recompute is not counted."""
    return (6.0 * multiplying_params(arch) * B * S
            + 3.0 * arch["num_layers"] * flash_fwd_flops(arch, B, S))
