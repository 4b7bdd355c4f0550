"""llava-next-mistral-7b — VLM: mistral-7b backbone + anyres vision frontend STUB.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000. The backbone is Mistral-7B-Instruct-v0.2, which dropped
the sliding window (32k full attention, rope theta 1e6). Per the system prompt,
the modality frontend is a stub: input_specs() provides precomputed patch
embeddings (anyres tiling yields up to 2880 patch tokens; we use a 576-token
base-resolution prefix) scattered at the start of the sequence.
"""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    block_pattern=(ATTN,),
    rope="standard",
    rope_theta=1_000_000.0,
    frontend="vision",
    num_patch_tokens=576,
    fsdp=True,
    optimizer="adamw",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
