"""gemma3-12b — dense decoder, 5 local : 1 global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified] 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144. Gemma3 uses explicit head_dim=256 (16*256=4096 != d_model) and a
1024-token sliding window on local layers; pattern (local x5, global) x 8.
"""
from repro_torch.configs.base import ArchConfig, ATTN, LOCAL_ATTN

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262_144,
    head_dim=256,
    block_pattern=(LOCAL_ATTN, LOCAL_ATTN, LOCAL_ATTN, LOCAL_ATTN, LOCAL_ATTN, ATTN),
    window=1024,
    rope="standard",
    long_context=True,  # 5:1 local:global — global-KV share stays linear
    tie_embeddings=True,
    fsdp=True,
    optimizer="adamw",
    source="hf:google/gemma-3-1b-pt; unverified",
)
