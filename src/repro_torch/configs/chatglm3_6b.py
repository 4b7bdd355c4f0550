"""chatglm3-6b — dense decoder, GQA kv=2, GLM "2d RoPE" (partial rotary).

[arXiv:2406.12793; hf] 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
GLM applies rotary embedding to half of each head's dims (rotary_dim = head_dim/2);
we model this as rope="partial". QKV uses bias per the released checkpoint.
"""
from repro_torch.configs.base import ArchConfig, ATTN

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    block_pattern=(ATTN,),
    rope="partial",
    use_bias=True,
    optimizer="adamw",
    source="arXiv:2406.12793; hf",
)
