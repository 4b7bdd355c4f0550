"""llama4-maverick-400b-a17b — interleaved MoE, 128 experts top-1 + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1, early fusion. To reach ~400B total /
~17B active we follow the released Maverick layout: MoE FFN on every 2nd layer
(interleave=2) with a shared expert, dense layers use d_ff=16384 (inferred;
noted in DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, ATTN

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=202_048,
    block_pattern=(ATTN,),
    rope="standard",
    rope_theta=500_000.0,
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        interleave=2,
        shared_expert=True,
    ),
    fsdp=True,
    optimizer="adafactor",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
