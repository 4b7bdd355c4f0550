"""Roofline terms of a dry-run cell, and the model FLOPs (6ND) it is held to.

Port of the JAX package's ``repro.launch.roofline``. Terms, per device:

    compute    = FLOPs / peak FLOP/s                   [op_cost walker]
    memory     = bytes / HBM B/s                       [op_cost walker]
    collective = collective operand bytes / link B/s   [the cell's model]

``H100`` holds datasheet figures, not measurements: an NVIDIA H100 80GB
HBM3 (SXM) at 700 W, 989e12 dense bf16 FLOP/s and 3.35e12 B/s of HBM. The
collective term takes one 50e9 B/s link: a card's NDR 400 Gb/s InfiniBand
port, since a 16 x 16 mesh spans 32 eight-card nodes (NVLink inside a node
is 450e9 B/s a direction), the conservative single-link figure as the JAX
module takes one ICI link. ``hw`` is a parameter, so the same records can
be read under another card's figures.
"""
from __future__ import annotations

H100 = {
    "name": "NVIDIA H100 80GB HBM3 (SXM), 700 W",
    "peak_flops": 989e12,   # dense bf16 FLOP/s, datasheet
    "hbm_bw": 3.35e12,      # B/s, datasheet
    "ici_bw": 50e9,         # B/s: one NDR 400 Gb/s InfiniBand link
}


def terms(cost: dict, raw: dict, hw: dict = H100) -> dict:
    """Roofline terms from a cell's per-device counts (``cost``: flops,
    bytes, collective_bytes, collective_count, scan_trip_counts) with the
    single traced unit's counts (``raw``) kept for cross-reference, as the
    JAX module keeps XLA's loop-bodies-once cost analysis. ``dominant`` is
    the largest of the three seconds, ties to compute: always one of
    "compute", "memory", "collective"."""
    flops = float(cost["flops"])
    byts = float(cost["bytes"])
    coll = {k: float(v) for k, v in cost["collective_bytes"].items()}
    coll_total = sum(coll.values())
    t = {
        "compute_s": flops / hw["peak_flops"],
        "memory_s": byts / hw["hbm_bw"],
        "collective_s": coll_total / hw["ici_bw"],
        "hlo_flops": flops,
        "hlo_bytes": byts,
        "collective_bytes": coll_total,
        "collectives": {k: int(v) for k, v in cost["collective_count"].items()},
        "collective_bytes_by_op": coll,
        "raw_cost_flops": float(raw.get("flops", 0.0)),
        "raw_cost_bytes": float(raw.get("bytes", 0.0)),
        "scan_trip_counts": list(cost.get("scan_trip_counts", [])),
    }
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: t[k])
    t["dominant"] = dom.replace("_s", "")
    bound = max(t["compute_s"], t["memory_s"], t["collective_s"])
    t["roofline_fraction"] = (t["compute_s"] / bound) if bound > 0 else 0.0
    return t


# ------------------------------------------------------------- model FLOPs (6ND)
def effective_param_count(cfg, total_params: int, embed_params: int,
                          active: bool) -> int:
    """N for the 6*N*D model-FLOPs estimate.

    Excludes the input embedding table when untied (lookup, not matmul);
    for MoE archs `active=True` keeps only top_k (+ shared) experts' FFN
    params per MoE layer.
    """
    n = total_params
    if not cfg.tie_embeddings:
        n -= embed_params  # input table: gather only
    if active and cfg.moe is not None:
        m = cfg.moe
        n_moe_layers = sum(1 for i in range(cfg.num_layers) if cfg.layer_is_moe(i))
        # of the held experts, top_k x held / num_experts act a token
        expert_params = 3 * cfg.d_model * m.d_ff_expert * m.num_held
        inactive_frac = (m.num_held - m.top_k * m.num_held / m.num_experts) / m.num_held
        n -= int(n_moe_layers * expert_params * inactive_frac)
    return n


def model_flops(cfg, total_params: int, embed_params: int, shape) -> float:
    n = effective_param_count(cfg, total_params, embed_params, active=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens
