"""recurrentgemma-2b — Griffin-style hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427; hf] 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.
Pattern per Griffin: (recurrent, recurrent, local_attn) repeating; 26 = 8*3 + 2,
the final two layers are recurrent (pattern prefix). head_dim 256 per the paper.
"""
from repro_torch.configs.base import ArchConfig, LOCAL_ATTN, RGLRU

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    block_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    window=2048,
    rope="standard",
    tie_embeddings=True,
    optimizer="adamw",
    source="arXiv:2402.19427; hf",
)
