"""Architecture / run configuration dataclasses.

Copy of the JAX package's ``configs/base.py`` (same fields, defaults and
rules). Every architecture is expressed as an :class:`ArchConfig`, a pure
description; ``repro_torch.models.transformer`` consumes it and
``repro_torch.serve`` pairs it with a batch and a prompt length.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

# Layer kinds usable inside a block pattern.
ATTN = "attn"                # global causal self attention
LOCAL_ATTN = "local_attn"    # sliding-window causal self attention
ENC_ATTN = "enc_attn"        # bidirectional (encoder) self attention
RGLRU = "rglru"              # RG-LRU recurrent block (Griffin / RecurrentGemma)
MLSTM = "mlstm"              # xLSTM matrix-memory block
SLSTM = "slstm"              # xLSTM scalar-memory block

LAYER_KINDS = (ATTN, LOCAL_ATTN, ENC_ATTN, RGLRU, MLSTM, SLSTM)
_RECURRENT_KINDS = (RGLRU, MLSTM, SLSTM)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for FFN sublayers."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    # Apply MoE FFN on every `interleave`-th layer (1 = every layer). Non-MoE
    # layers use a dense FFN of width `ArchConfig.d_ff`.
    interleave: int = 1
    shared_expert: bool = False
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ArchConfig:
    """A complete architecture description (one per assigned arch)."""

    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default: d_model // num_heads
    # The repeating unit of layer kinds. num_layers = k*len(pattern) + r; the
    # final r layers reuse the pattern prefix, applied unscanned.
    block_pattern: Sequence[str] = (ATTN,)
    window: int = 0                  # sliding window size for LOCAL_ATTN
    rope: str = "standard"           # standard | partial | none
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    use_bias: bool = False
    tie_embeddings: bool = False
    encoder_only: bool = False
    # Modality frontend stub: None | "audio" | "vision". For "audio" the model
    # input is precomputed frame embeddings (B, S, d_model); for "vision" the
    # input is tokens plus a prefix of precomputed patch embeddings.
    frontend: Optional[str] = None
    num_patch_tokens: int = 0        # vision frontend: patch-embedding prefix len
    moe: Optional[MoEConfig] = None
    max_seq_len: int = 131_072

    # Explicit long-context capability (long_500k decode): recurrent/SSM archs
    # and local-attention-dominant hybrids whose global-KV share stays linear.
    # None => derived from is_subquadratic.
    long_context: bool | None = None

    # --- distribution hints -------------------------------------------------
    fsdp: bool = False               # additionally shard weights over the data axis
    optimizer: str = "adamw"         # adamw | adafactor | sgdm
    remat: str = "full"              # full | dots | none
    # Query-block size for blocked (flash-style) attention at the jnp level.
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    # "flash": custom-VJP recompute backward (O(S) residuals);
    # "naive": plain scan AD (O(S^2) bwd residual traffic) — the recorded
    # pre-hillclimb baseline in EXPERIMENTS.md §Perf.
    attn_impl: str = "flash"
    # Gradient-accumulation microbatches per optimizer step (1 = off).
    # Remat-saved activations shrink by this factor.
    accum_steps: int = 1
    scan_chunk: int = 256            # chunk size for recurrent chunkwise forms

    # --- bookkeeping ---------------------------------------------------------
    source: str = ""                 # provenance note ([arXiv/hf]; tier)

    def __post_init__(self):
        for k in self.block_pattern:
            if k not in LAYER_KINDS:
                raise ValueError(f"unknown layer kind {k!r}")
        if self.encoder_only and any(k != ENC_ATTN for k in self.block_pattern):
            raise ValueError("encoder_only configs must use enc_attn layers")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_subquadratic(self) -> bool:
        """True when per-token decode state does not grow O(seq) for the
        *dominant* layer kind (recurrent/hybrid/local archs)."""
        kinds = set(self.block_pattern)
        return bool(kinds & set(_RECURRENT_KINDS)) or (
            LOCAL_ATTN in kinds and ATTN not in kinds
        )

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    def layer_kinds(self) -> list[str]:
        """Kind of every layer, pattern repeated/truncated to num_layers."""
        pat = list(self.block_pattern)
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return (layer_idx % self.moe.interleave) == (self.moe.interleave - 1)

    def scaled(self, **overrides) -> "ArchConfig":
        """A reduced copy for smoke tests (same family, small dims)."""
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) workload cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


# The four assigned LM shapes.
SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def cell_status(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and the reason when skipped.

    Skip rules follow DESIGN.md §4: decode shapes need an autoregressive step;
    long_500k needs a sub-quadratic arch.
    """
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        capable = cfg.long_context if cfg.long_context is not None else cfg.is_subquadratic
        if not capable:
            return False, "pure full-attention arch; 500k decode KV skipped per DESIGN.md"
    return True, ""
