"""The multi-architecture transformer: init, the training loss, prefill and
decode.

Port of the JAX package's ``models/transformer.py`` with its param and
cache layout: a config's layer stack is grouped into identical repeating
*units* (``unit_len = lcm(len(block_pattern), moe.interleave)``), each unit
leaf stacked over ``n_units`` in ``params["units"]`` (a tuple, one dict per
layer of the unit), and ``num_layers % unit_len`` trailing layers in
``params["rest"]``. A Python loop over the stacked units takes the place of
``lax.scan``.

Entry points:
    init(generator, cfg, device)                      -> params
    train_loss(params, cfg, batch)                    -> (loss, metrics)
    cache_init(cfg, batch, max_seq, device)           -> KV cache
    prefill(params, cfg, batch, cache)                -> (last_logits, cache)
    decode_step(params, cfg, tokens, cache, position) -> (logits, cache)

Caches are written in place: ``prefill`` and ``decode_step`` return the
cache they were given. Attention layers (global, local, encoder) are
ported; the other layer kinds, MoE FFNs and the modality frontends raise
``NotImplementedError``.

Rematerialization (``cfg.remat``, the JAX package's ``jax.checkpoint`` of
each unit): under autograd, ``"full"`` runs each unit through
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so only the
unit-boundary residual is kept and the unit's forward, flash kernel
included, runs again in the backward; ``"none"`` keeps every activation.
Each loss chunk's unembedding and cross entropy is checkpointed too, so
the (B, LOSS_CHUNK, vocab) fp32 logits of only one chunk are alive at a
time.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch import tree
from repro_torch.configs.base import ATTN, ENC_ATTN, LOCAL_ATTN
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

_ATTN_KINDS = (ATTN, LOCAL_ATTN, ENC_ATTN)
LAYERS_ITEM = "ROADMAP.md queue 1, 'LM zoo: the other layer kinds and frontends'"
REMAT_ITEM = "ROADMAP.md queue 1, 'LM training', remat=\"dots\""
LOSS_CHUNK = 2048  # vocab-projection chunk (tokens) to bound logits memory


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


def _remat(fn, cfg):
    """``fn`` under ``cfg.remat`` when autograd records (training)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        raise NotImplementedError(
            f"remat='dots' (save the matmul outputs, recompute the rest) is not "
            f"ported yet: {REMAT_ITEM}")
    if cfg.remat != "full":
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _unit_params(stacked):
    """The stacked units' params, one tree a unit. ``unbind`` views the
    stacked leaves once: autograd then stacks the units' grads in one
    backward op, where indexing each unit would add a zero-padded
    stack-sized grad per unit."""
    leaves = [x.unbind(0) for x in tree.leaves(stacked)]
    return [tree.unflatten(stacked, [x[u] for x in leaves])
            for u in range(len(leaves[0]) if leaves else 0)]


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

    if n_units:
        units = _unit_params(params["units"])
        caches = (None if cache is None
                  else _unit_params(cache["units"]))
        for u in range(n_units):
            if decode_position is None and cache is None:
                h = _remat(lambda h, u=u: run(units[u], None, h), cfg)(h)
            else:
                h = run(units[u], caches[u], h)
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
def train_loss(params, cfg, batch):
    """Next-token cross entropy in bf16 activations. ``batch``: tokens and
    labels (B, S), optional loss_mask. Returns (loss, metrics) with metrics
    ``loss``, ``accuracy`` (token top-1) and ``aux`` (0: no MoE layers)."""
    h, positions = _embed_inputs(params, cfg, batch)
    h = _stack_forward(params, cfg, h, positions, None)
    h = L.norm_apply(params["final_norm"], h, cfg.norm)

    labels = batch["labels"]
    mask = batch.get("loss_mask")
    B, S, _ = h.shape
    chunk = min(LOSS_CHUNK, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the loss "
                         f"chunk {chunk}")
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]

    def chunk_loss(hs, ls, ms):
        logits = L.unembed_apply(table, hs)
        nll, acc = L.xent_terms(logits, ls)
        return (nll * ms).sum(), (acc * ms).sum()

    if torch.is_grad_enabled():
        loss_fn = lambda *a: checkpoint(chunk_loss, *a, use_reentrant=False)
    else:
        loss_fn = chunk_loss
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    tot, totacc, totw = zero, zero, zero
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        ms = (torch.ones(labels[:, sl].shape, dtype=torch.float32, device=h.device)
              if mask is None else mask[:, sl].to(torch.float32))
        nll, acc = loss_fn(h[:, sl], labels[:, sl], ms)
        tot, totacc, totw = tot + nll, totacc + acc, totw + ms.sum()
    totw = torch.clamp_min(totw, 1.0)
    aux = zero
    loss = tot / totw + 0.01 * aux
    return loss, {"loss": (tot / totw).detach(), "accuracy": totacc / totw,
                  "aux": aux}


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
