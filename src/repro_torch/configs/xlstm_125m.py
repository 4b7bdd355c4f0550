"""xlstm-125m — sLSTM + mLSTM recurrent blocks.

[arXiv:2405.04517; unverified] 12L d_model=768 4H d_ff=0 vocab=50304. d_ff=0 =>
blocks carry their own up/down projections (xLSTM block style). We use a
(mlstm, mlstm, mlstm, slstm) repeating unit (3:1; the paper's xLSTM[7:1] uses a
similar sparse sLSTM placement — noted in DESIGN.md). head_dim 192.
"""
from repro_torch.configs.base import ArchConfig, MLSTM, SLSTM

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=(MLSTM, MLSTM, MLSTM, SLSTM),
    rope="none",
    norm="layernorm",
    use_bias=True,
    tie_embeddings=True,
    optimizer="adamw",
    source="arXiv:2405.04517; unverified",
)
