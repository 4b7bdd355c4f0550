"""trinity-mini (Arcee AFMoE, 26B total / 3B active) — sparse MoE with gated,
QK-normed attention over 3:1 sliding-window / global layers.

[hf:arcee-ai/Trinity-Mini config.json, model_type afmoe] 32L d_model=2048
32H (GQA kv=4) head 128, layer_types sliding (window 2048) three layers in
four and full attention every 4th, num_dense_layers 2 (SwiGLU 6144), 128
routed experts of width 1024 top-8 plus 1 shared (of the same width),
sigmoid scores with route_norm (the port's sigmoid router always
renormalizes) and route_scale 2.826, aux-loss-free balancing by an expert
bias (load_balance_coeff 1e-3), RMSNorm eps 1e-5, rope_theta 1e4, vocab
200192, untied, mup_enabled. From the family's description (not keys of the
config): gated attention, QK-norm, RoPE on the sliding layers only (no
positional encoding on the global ones), sandwich norms and the sqrt(d)
embedding scale that muP gives. Not in the JAX package's zoo: a
port-only arch (``configs.PORT_ONLY_IDS``).
"""
from repro_torch.configs.base import ATTN, LOCAL_ATTN, ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="trinity-mini",
    family="moe",
    num_layers=32,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=6144,
    vocab_size=200_192,
    block_pattern=(LOCAL_ATTN, LOCAL_ATTN, LOCAL_ATTN, ATTN),
    window=2048,
    rope="standard",
    rope_theta=10_000.0,
    norm="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1024, shared_expert=True,
                  first_dense=2, router="sigmoid", route_scale=2.826, bias_rate=1e-3),
    qk_norm=True,
    attn_gate=True,
    sandwich_norm=True,
    embed_scale=True,
    rope_kinds=(LOCAL_ATTN,),
    optimizer="adamw",
    source="hf:arcee-ai/Trinity-Mini (afmoe); family description for the assumed parts",
)
