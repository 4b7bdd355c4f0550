"""Model configurations used by the port: LeNet-5 for the §VI federation
(``lenet_dfl``) and the language models the port serves, with the JAX
package's ``get_config(arch_id)`` / ``smoke_config(arch_id)``."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    InputShape,
    MoEConfig,
    SHAPES,
    cell_status,
)

# arch-id -> module path; only the architectures the port runs so far
_REGISTRY = {
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
}

ARCH_IDS = tuple(_REGISTRY)
# the JAX package's other architectures: their layer kinds and frontends
# come with ROADMAP.md queue 1, 'LM zoo: the other layer kinds and frontends'
UNPORTED = ("chatglm3-6b", "command-r-35b", "dbrx-132b", "hubert-xlarge",
            "llama4-maverick-400b-a17b", "llava-next-mistral-7b",
            "recurrentgemma-2b", "xlstm-125m")
_LAYERS_ITEM = "ROADMAP.md queue 1, 'LM zoo: the other layer kinds and frontends'"


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in UNPORTED:
        raise NotImplementedError(f"arch {arch_id!r} is not ported yet: "
                                  f"{_LAYERS_ITEM}")
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[arch_id]).CONFIG


def smoke_config(arch_id: str) -> ArchConfig:
    """A reduced same-family config for CPU smoke tests.

    Keeps the layer pattern/family intact but shrinks width, depth, vocab and
    expert count so one train step runs on a single CPU device.
    """
    cfg = get_config(arch_id)
    pat = len(cfg.block_pattern)
    n_layers = max(pat, min(cfg.num_layers, pat * 2))
    moe = cfg.moe
    if moe is not None:
        # capacity_factor 4.0 => effectively dropless at smoke scale, so
        # prefill (per-row dispatch) and decode (flat dispatch) agree exactly
        moe = dataclasses.replace(
            moe, num_experts=4, top_k=min(moe.top_k, 2), d_ff_expert=64,
            capacity_factor=4.0,
        )
    return cfg.scaled(
        num_layers=n_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window=min(cfg.window, 32) if cfg.window else 0,
        num_patch_tokens=8 if cfg.frontend == "vision" else 0,
        moe=moe,
        fsdp=False,
        attn_block_q=16,
        attn_block_kv=32,
        scan_chunk=16,
        max_seq_len=512,
    )
