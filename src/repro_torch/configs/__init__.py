"""Model configurations used by the port: LeNet-5 for the §VI federation
(``lenet_dfl``), the ten language models of the JAX package's zoo
(``ARCH_IDS``) and the port's own archs (``PORT_ONLY_IDS``: Trinity-Mini),
with ``get_config(arch_id)`` / ``smoke_config(arch_id)``."""
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

# arch-id -> module path (one module per architecture), in the JAX order
_REGISTRY = {
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
}

ARCH_IDS = tuple(_REGISTRY)

# archs the JAX package lacks (configs with PORT_ONLY fields set)
_PORT_ONLY = {
    "trinity-mini": "repro_torch.configs.trinity_mini",
}
PORT_ONLY_IDS = tuple(_PORT_ONLY)
ALL_IDS = ARCH_IDS + PORT_ONLY_IDS


def get_config(arch_id: str) -> ArchConfig:
    module = _REGISTRY.get(arch_id) or _PORT_ONLY.get(arch_id)
    if module is None:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALL_IDS)}")
    return importlib.import_module(module).CONFIG


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
            capacity_factor=4.0, held=None,
            first_dense=min(moe.first_dense, 1),
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
