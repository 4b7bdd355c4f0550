"""command-r-35b — dense decoder, GQA kv=8, no biases.

[hf:CohereForAI/c4ai-command-r-v01; unverified] 40L d_model=8192 64H (GQA kv=8)
d_ff=22528 vocab=256000. Cohere ties embeddings and uses layernorm.
"""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256_000,
    block_pattern=(ATTN,),
    rope="standard",
    norm="layernorm",
    tie_embeddings=True,
    fsdp=True,
    optimizer="adafactor",
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
