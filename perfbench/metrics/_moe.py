"""A dropless mixture-of-experts decoder's counts from its configuration
(the benchmark's own arithmetic; Trinity-Mini's AFMoE block): the
multiplying params a token goes through outside the routed experts, the
routed experts' FLOPs a (token, choice) slot, the attention's band."""
from __future__ import annotations

from perfbench.metrics._glm import causal_pairs


def _kinds(arch):
    pat = arch["block_pattern"]
    return [pat[i % len(pat)] for i in range(arch["num_layers"])]


def moe_layers(arch) -> int:
    return arch["num_layers"] - arch["moe"]["first_dense"]


def dense_params(arch) -> int:
    """Params that multiply, a token through all layers, but the routed
    experts: q, k, v, o and the gate of each attention; the dense layers'
    SwiGLU; the MoE layers' router and shared expert; the unembedding."""
    d, H, KH, Dh = arch["d_model"], arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    m = arch["moe"]
    attn = d * (H + 2 * KH) * Dh + H * Dh * d + (d * H * Dh if arch.get("attn_gate") else 0)
    n_moe = moe_layers(arch)
    ffn = (m["first_dense"] * 3 * d * arch["d_ff"]
           + n_moe * (d * m["num_experts"] + 3 * d * m["d_ff_expert"]))
    return arch["num_layers"] * attn + ffn + arch["vocab_size"] * d


def slot_fwd_flops(arch) -> float:
    """One routed (token, choice) slot's expert forward: gate, up, down."""
    return 2.0 * 3 * arch["d_model"] * arch["moe"]["d_ff_expert"]


def kept_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal mask with a ``window`` (0: none) keeps."""
    if not window or window >= S:
        return causal_pairs(S)
    return causal_pairs(window) + (S - window) * window


def attn_fwd_flops(arch, B: int, S: int) -> float:
    """Every layer's attention core forward (Q.K and P.V) over its band."""
    H, Dh = arch["num_heads"], arch["head_dim"]
    pairs = sum(kept_pairs(S, arch["window"] if k == "local_attn" else 0)
                for k in _kinds(arch))
    return 4.0 * B * H * Dh * pairs


def step_flops(arch, B: int, S: int, held_slots: float):
    """Model FLOPs of training, in two parts: a step's dense part (6 x
    dense params x tokens plus 3 x the attention's forward) and the routed
    part of steps whose MoE layers computed ``held_slots`` slots (3 x their
    expert forward). The remat recompute is not counted."""
    return (6.0 * dense_params(arch) * B * S + 3.0 * attn_fwd_flops(arch, B, S)), \
        3.0 * held_slots * slot_fwd_flops(arch)
