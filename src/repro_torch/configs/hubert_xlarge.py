"""hubert-xlarge — encoder-only audio transformer (wav2vec2 arch).

[arXiv:2106.07447; unverified] 48L d_model=1280 16H d_ff=5120 vocab=504
(masked-unit prediction targets). kv=16 => MHA. head_dim = 1280/16 = 80,
kept faithful (not padded to 128; noted in DESIGN.md). The CNN waveform
frontend is a STUB: input_specs() provides precomputed frame embeddings
(B, S, d_model). LayerNorm + biases per fairseq.
"""
from repro_torch.configs.base import ArchConfig, ENC_ATTN

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    block_pattern=(ENC_ATTN,),
    rope="none",
    norm="layernorm",
    use_bias=True,
    encoder_only=True,
    frontend="audio",
    max_seq_len=32_768,
    optimizer="adamw",
    source="arXiv:2106.07447; unverified",
)
