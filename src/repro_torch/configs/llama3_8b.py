"""llama3-8b — dense decoder, GQA kv=8, 128k vocab.

[arXiv:2407.21783; unverified] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256. SwiGLU FFN, RMSNorm, rope theta 500000.
"""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    block_pattern=(ATTN,),
    rope="standard",
    rope_theta=500_000.0,
    fsdp=True,
    optimizer="adamw",
    source="arXiv:2407.21783; unverified",
)
