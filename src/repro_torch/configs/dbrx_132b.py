"""dbrx-132b — fine-grained MoE, 16 experts top-4 on every layer.

[hf:databricks/dbrx-base; unverified] 40L d_model=6144 48H (GQA kv=8)
d_ff=10752 vocab=100352, MoE 16e top-4.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, ATTN

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100_352,
    block_pattern=(ATTN,),
    rope="standard",
    rope_theta=500_000.0,
    norm="layernorm",
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752, interleave=1),
    fsdp=True,
    optimizer="adafactor",
    source="hf:databricks/dbrx-base; unverified",
)
