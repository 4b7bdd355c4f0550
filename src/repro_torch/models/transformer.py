"""The multi-architecture transformer, serving path: init, prefill, decode.

Port of the JAX package's ``models/transformer.py`` with its param and
cache layout: a config's layer stack is grouped into identical repeating
*units* (``unit_len = lcm(len(block_pattern), moe.interleave)``), each unit
leaf stacked over ``n_units`` in ``params["units"]`` (a tuple, one dict per
layer of the unit), and ``num_layers % unit_len`` trailing layers in
``params["rest"]``. A Python loop over the stacked units takes the place of
``lax.scan``.

Entry points:
    init(generator, cfg, device)                      -> params
    cache_init(cfg, batch, max_seq, device)           -> KV cache
    prefill(params, cfg, batch, cache)                -> (last_logits, cache)
    decode_step(params, cfg, tokens, cache, position) -> (logits, cache)

Caches are written in place: ``prefill`` and ``decode_step`` return the
cache they were given. Attention layers (global, local, encoder) are
ported; the other layer kinds, MoE FFNs, the modality frontends and
training raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch import device as device_lib
from repro_torch import tree
from repro_torch.configs.base import ATTN, ENC_ATTN, LOCAL_ATTN
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

_ATTN_KINDS = (ATTN, LOCAL_ATTN, ENC_ATTN)
LAYERS_ITEM = "ROADMAP.md queue 1, 'LM zoo: the other layer kinds and frontends'"


def unit_len(cfg) -> int:
    base = len(cfg.block_pattern)
    if cfg.moe is not None:
        base = math.lcm(base, cfg.moe.interleave)
    return base


def unit_layout(cfg) -> tuple[int, int, list[tuple[str, bool]]]:
    """(n_units, n_rest, unit_entries) where entries = (kind, is_moe)."""
    ul = unit_len(cfg)
    kinds = cfg.layer_kinds()
    entries = [(kinds[i], cfg.layer_is_moe(i)) for i in range(min(ul, cfg.num_layers))]
    return cfg.num_layers // ul, cfg.num_layers % ul, entries


def check_supported(cfg) -> None:
    """Raise for what the port does not run yet."""
    missing = sorted({k for k in cfg.block_pattern if k not in _ATTN_KINDS})
    if missing:
        raise NotImplementedError(f"layer kinds {missing} are not ported yet: "
                                  f"{LAYERS_ITEM}")
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE FFNs are not ported yet: {LAYERS_ITEM}")
    if cfg.frontend is not None or cfg.encoder_only:
        raise NotImplementedError(
            f"the {cfg.frontend or 'encoder'} frontend is not ported yet: "
            f"{LAYERS_ITEM}")


# ---------------------------------------------------------------------- init
def _unit_init(generator, cfg, entries, device, lead):
    layers = []
    for _ in entries:
        layers.append({
            "norm1": L.norm_init(cfg.d_model, cfg.norm, cfg.use_bias, device, lead),
            "mix": attn.attn_init(generator, cfg, device, lead),
            "norm2": L.norm_init(cfg.d_model, cfg.norm, cfg.use_bias, device, lead),
            "ffn": L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.use_bias,
                              device, lead),
        })
    return tuple(layers)


def init(generator, cfg, device="cuda"):
    """Random fp32 params drawn from ``generator`` (a ``torch.Generator`` on
    ``device``), in the JAX package's tree layout (its init distributions;
    not its numbers)."""
    dev = device_lib.resolve(device)
    check_supported(cfg)
    n_units, n_rest, entries = unit_layout(cfg)
    params: dict[str, Any] = {
        "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = L.embed_init(generator, cfg.vocab_size, cfg.d_model, dev)
    params["final_norm"] = L.norm_init(cfg.d_model, cfg.norm, cfg.use_bias, dev)
    if n_units:
        params["units"] = _unit_init(generator, cfg, entries, dev, (n_units,))
    if n_rest:
        params["rest"] = _unit_init(generator, cfg, entries[:n_rest], dev, ())
    return params


def cast_params(params, dtype):
    """The weights (``w``) and embedding tables in ``dtype``; norms and biases
    are shared as they are. Prefill and decode in ``dtype`` cast every
    weight to it at use, so this one-off copy gives the same numbers and
    spares the casts."""
    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, key) for v in t)
        return t.to(dtype) if key in ("w", "table") else t

    return walk(params)


# --------------------------------------------------------------------- layers
def _layer_apply(p, cfg, kind, h, positions, cache_entry):
    """One layer, full-sequence mode. Returns h (the cache entry is filled
    in place)."""
    hn = L.norm_apply(p["norm1"], h, cfg.norm)
    y, _ = attn.attn_apply(p["mix"], cfg, hn, positions, kind=kind,
                           cache=cache_entry)
    h = h + y
    hn = L.norm_apply(p["norm2"], h, cfg.norm)
    return h + L.mlp_apply(p["ffn"], hn)


def _layer_decode(p, cfg, kind, h, position, cache_entry):
    hn = L.norm_apply(p["norm1"], h, cfg.norm)
    y, _ = attn.attn_decode(p["mix"], cfg, hn, position, cache_entry, kind=kind)
    h = h + y
    hn = L.norm_apply(p["norm2"], h, cfg.norm)
    return h + L.mlp_apply(p["ffn"], hn)


def _stack_forward(params, cfg, h, positions, cache, decode_position=None):
    """Run all layers; cache may be None. Returns h."""
    n_units, n_rest, entries = unit_layout(cfg)

    def run(layer_params, layer_caches, h):
        for i, (kind, _) in enumerate(entries[:len(layer_params)]):
            ce = None if layer_caches is None else layer_caches[i]
            if decode_position is not None:
                h = _layer_decode(layer_params[i], cfg, kind, h, decode_position, ce)
            else:
                h = _layer_apply(layer_params[i], cfg, kind, h, positions, ce)
        return h

    for u in range(n_units):
        unit_params = tree.map(lambda x: x[u], params["units"])
        unit_cache = None if cache is None else tree.map(lambda x: x[u],
                                                         cache["units"])
        h = run(unit_params, unit_cache, h)
    if n_rest:
        h = run(params["rest"], None if cache is None else cache["rest"], h)
    return h


# -------------------------------------------------------------------- embedding
def _embed_inputs(params, cfg, batch, dtype=torch.bfloat16):
    """Token embedding. Returns (h, positions)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = L.embed_apply(params["embed"], tokens, dtype)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    return h, positions


def _unembed(params, cfg, h):
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed_apply(table, h)


# ------------------------------------------------------------------ entrypoints
def prefill(params, cfg, batch, cache, dtype=torch.bfloat16):
    """Process the prompt, fill the cache, return last-token logits (fp32).
    ``dtype`` is the activation/residual dtype (blocks compute in fp32
    internally and cast back to it; fp32 here keeps the whole stack fp32 —
    the numerics oracle for prefill-vs-decode consistency checks)."""
    h, positions = _embed_inputs(params, cfg, batch, dtype=dtype)
    h = _stack_forward(params, cfg, h, positions, cache)
    h_last = L.norm_apply(params["final_norm"], h[:, -1:], cfg.norm)
    return _unembed(params, cfg, h_last)[:, 0], cache


def decode_step(params, cfg, tokens, cache, position: int, dtype=torch.bfloat16):
    """One decode step. tokens (B,1); position an int, the same for every row."""
    check_supported(cfg)
    h = L.embed_apply(params["embed"], tokens, dtype)
    h = _stack_forward(params, cfg, h, None, cache, decode_position=position)
    h = L.norm_apply(params["final_norm"], h, cfg.norm)
    return _unembed(params, cfg, h)[:, 0], cache


# ------------------------------------------------------------------- KV caches
def cache_init(cfg, batch, max_seq, device="cuda", dtype=torch.bfloat16):
    """KV caches mirroring the unit/rest layout: ``{"units": (per layer of
    the unit: {"k", "v"} stacked over n_units), "rest": (...) or None}``."""
    dev = device_lib.resolve(device)
    check_supported(cfg)
    n_units, n_rest, entries = unit_layout(cfg)
    units = tuple(attn.attn_cache_init(cfg, kind, batch, max_seq, dev, dtype,
                                       lead=(n_units,))
                  for kind, _ in entries) if n_units else None
    rest = tuple(attn.attn_cache_init(cfg, kind, batch, max_seq, dev, dtype)
                 for kind, _ in entries[:n_rest]) if n_rest else None
    return {"units": units, "rest": rest}


def param_count(params) -> int:
    return sum(x.numel() for x in tree.leaves(params))
