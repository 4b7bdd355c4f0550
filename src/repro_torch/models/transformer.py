"""The multi-architecture transformer: init, the training loss, prefill and
decode.

Port of the JAX package's ``models/transformer.py`` with its param and
cache layout: a config's layer stack is grouped into identical repeating
*units* (``unit_len = lcm(len(block_pattern), moe.interleave)``), each unit
leaf stacked over ``n_units`` in ``params["units"]`` (a tuple, one dict per
layer of the unit), and ``num_layers % unit_len`` trailing layers in
``params["rest"]``. A Python loop over the stacked units takes the place of
``lax.scan``. A config whose MoE layers start after ``moe.first_dense``
dense layers (Trinity; no arch of the JAX package) keeps those in
``params["lead"]``, unstacked, ahead of the units, which then group the
layers after them.

Entry points:
    init(generator, cfg, device, dtype=None)          -> params
    param_axes(cfg) / cache_axes(cfg)                 -> logical axes trees
    train_loss(params, cfg, batch)                    -> (loss, metrics)
    cache_init(cfg, batch, max_seq, device)           -> KV cache
    prefill(params, cfg, batch, cache)                -> (last_logits, cache)
    decode_step(params, cfg, tokens, cache, position) -> (logits, cache)

Every layer kind of the JAX package runs: attention (global, local,
encoder), RG-LRU (``models.rglru``), mLSTM and sLSTM (``models.xlstm``,
blocks without norm2 and FFN), dense and MoE FFNs (``models.moe``, whose
per-layer load-balancing aux is summed over the stack; the dropless
sigmoid-routed layers instead report each expert's load, a row a layer,
and route by the rows of ``expert_bias``), and the two
modality frontend stubs: ``frontend="audio"`` takes ``frame_embeds``
(B, S, d) in place of tokens, ``frontend="vision"`` writes
``patch_embeds`` over positions [0, num_patch_tokens), and
``encoder_only`` adds learned positions ``pos[:S]``. Caches are written
in place: ``prefill`` and ``decode_step`` return the cache they were
given.

Rematerialization (``cfg.remat``; the JAX package's ``jax.checkpoint``
of each unit): under autograd, ``"full"`` runs each layer through
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so only the
layer-boundary residual is kept and the layer's forward, flash kernel
included, runs again in the backward; ``"dots"`` (JAX's
``checkpoint_dots_with_no_batch_dims``) checkpoints each layer the same way
but saves the outputs of its matrix products without batch dims, the
dense projections (``aten.mm`` / ``aten.addmm``), and recomputes the rest:
attention's score and P.V products, the MoE expert and xLSTM einsums
(batched ``bmm``) and the flash kernel, which is not a product;
``"none"`` keeps every activation. A layer, where JAX takes a unit: the
same recompute inside the units (one layer a unit, as most archs have, is
the same boundary), and the backward holds one layer's activations at a
time; the leading and trailing layers, which JAX keeps whole, are
checkpointed too (Trinity's period of four MoE-heavy layers and its two
trailing ones do not fit the card otherwise).
Each loss chunk's unembedding and cross
entropy is checkpointed too (whatever the policy), so the (B, LOSS_CHUNK,
vocab) fp32 logits of only one chunk are alive at a time.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as device_lib
from repro_torch import sharding as sh
from repro_torch import tree
from repro_torch.configs.base import ATTN, ENC_ATTN, LOCAL_ATTN, MLSTM, RGLRU, SLSTM
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib

_ATTN_KINDS = (ATTN, LOCAL_ATTN, ENC_ATTN)
_XLSTM_KINDS = (MLSTM, SLSTM)     # blocks that carry their own FFN / gating
LOSS_CHUNK = 2048  # vocab-projection chunk (tokens) to bound logits memory


def unit_len(cfg) -> int:
    base = len(cfg.block_pattern)
    if cfg.moe is not None:
        base = math.lcm(base, cfg.moe.interleave)
    return base


def lead_len(cfg) -> int:
    """Layers ahead of the units (``moe.first_dense``, at most all)."""
    return min(cfg.moe.first_dense, cfg.num_layers) if cfg.moe is not None else 0


def lead_layout(cfg) -> list[tuple[str, bool]]:
    """(kind, is_moe) of each leading dense layer."""
    kinds = cfg.layer_kinds()
    return [(kinds[i], False) for i in range(lead_len(cfg))]


def unit_layout(cfg) -> tuple[int, int, list[tuple[str, bool]]]:
    """(n_units, n_rest, unit_entries) where entries = (kind, is_moe), over
    the layers after the leading ones."""
    ul, lead = unit_len(cfg), lead_len(cfg)
    kinds = cfg.layer_kinds()
    n = cfg.num_layers - lead
    entries = [(kinds[lead + i], cfg.layer_is_moe(lead + i)) for i in range(min(ul, n))]
    return n // ul, n % ul, entries


def moe_layers(cfg) -> int:
    """The number of MoE layers (rows of ``expert_bias``)."""
    return sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))


def init_expert_bias(cfg, device):
    """The dropless router's expert bias, zeros (MoE layers, experts) fp32,
    or None for a config without it."""
    if cfg.moe is None or cfg.moe.router != "sigmoid":
        return None
    return torch.zeros((moe_layers(cfg), cfg.moe.num_experts), dtype=torch.float32,
                       device=device_lib.resolve(device))


# ------------------------------------------------------------- weight casts
def _cast_at_use(path) -> bool:
    """Whether the JAX forward casts the leaf at ``path`` (its dict keys,
    outermost first) to the activation dtype at every use: dense weights
    (``w``, but for sLSTM's raw input matrix, used in fp32), embedding
    tables, learned positions, RG-LRU's conv taps and the MoE expert
    stacks (rounded to bf16 at use, which storing in bf16 gives exactly).
    RG-LRU's w_r / w_i, the xLSTM matrices, norms and biases are left
    alone: the first two are used in fp32 whatever the activation dtype.
    ``init(..., dtype)`` stores the same leaves in ``dtype``: each module's
    init passes it to exactly these leaves (held together by
    ``tests/test_torch_zoo.py`` on every arch)."""
    key, parent = path[-1], (path[-2] if len(path) > 1 else None)
    if key in ("table", "pos", "conv_w"):
        return True
    if key == "w":
        return parent != "mix"
    return key in moe_lib.EXPERT_STACKS and parent == "ffn"


def _cast(t, dtype, path=()):
    if isinstance(t, dict):
        return {k: _cast(v, dtype, (*path, k)) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_cast(v, dtype, path) for v in t)
    return t.to(dtype) if path and _cast_at_use(path) else t


def cast_params(params, dtype):
    """The leaves the forward casts at use (``_cast_at_use``) in ``dtype``;
    the others are shared as they are. Prefill and decode in ``dtype``
    cast each of those leaves to it at use, so this one-off copy gives the
    same numbers and spares the casts."""
    return _cast(params, dtype)


# ---------------------------------------------------------------------- init
def _layer_init(generator, cfg, kind, is_moe, device, lead, dtype):
    p = {"norm1": L.norm_init(cfg.d_model, cfg.norm, cfg.use_bias, device, lead)}
    if cfg.sandwich_norm:       # each branch's output normed too
        p["post1"] = L.norm_init(cfg.d_model, cfg.norm, cfg.use_bias, device, lead)
        p["post2"] = L.norm_init(cfg.d_model, cfg.norm, cfg.use_bias, device, lead)
    if kind in _ATTN_KINDS:
        p["mix"] = attn.attn_init(generator, cfg, device, lead, dtype)
    elif kind == RGLRU:
        p["mix"] = rglru_lib.rglru_init(generator, cfg, device, lead, dtype)
    elif kind == MLSTM:     # the xLSTM matrices are used in fp32: nothing cast
        p["mix"] = xlstm_lib.mlstm_init(generator, cfg, device, lead)
    elif kind == SLSTM:
        p["mix"] = xlstm_lib.slstm_init(generator, cfg, device, lead)
    else:
        raise ValueError(kind)
    if kind not in _XLSTM_KINDS:
        p["norm2"] = L.norm_init(cfg.d_model, cfg.norm, cfg.use_bias, device, lead)
        if is_moe:
            p["ffn"] = moe_lib.moe_init(generator, cfg, device, lead, dtype)
        else:
            p["ffn"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.use_bias,
                                  device, lead, dtype)
    return p


def init(generator, cfg, device="cuda", dtype=None):
    """Random fp32 params drawn from ``generator`` (a ``torch.Generator`` on
    ``device``), in the JAX package's tree layout (its init distributions;
    not its numbers).

    Every stacked leaf (n_units, *shape) is allocated once and filled one
    unit's slice at a time (the MoE expert stacks one (unit, expert) slice
    at a time), each slice drawn in fp32 and cast into place
    (``layers.draw_stacked``). With ``dtype``, the leaves ``cast_params``
    casts are stored in it, and the rest in fp32: the same slices are
    drawn in the same order, so the result is bitwise ``cast_params(init(
    generator, cfg, device), dtype)`` from the same generator state. No
    fp32 tensor larger than one slice of a leaf, or than an embedding or
    position table, is alive beside the params: command-r-35b's 40 layers
    build within one card's memory in bf16."""
    dev = device_lib.resolve(device)
    n_units, n_rest, entries = unit_layout(cfg)
    params: dict[str, Any] = {
        "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model, dev, dtype)}
    if not cfg.tie_embeddings:
        params["unembed"] = L.embed_init(generator, cfg.vocab_size, cfg.d_model, dev,
                                         dtype)
    if cfg.encoder_only:  # learned absolute positions (conv-pos stub)
        params["pos"] = L.truncated_normal(generator, (cfg.max_seq_len, cfg.d_model),
                                           1.0, dev, dtype)
    params["final_norm"] = L.norm_init(cfg.d_model, cfg.norm, cfg.use_bias, dev)
    if lead_len(cfg):
        params["lead"] = tuple(
            _layer_init(generator, cfg, kind, is_moe, dev, (), dtype)
            for kind, is_moe in lead_layout(cfg))
    if n_units:
        params["units"] = tuple(
            _layer_init(generator, cfg, kind, is_moe, dev, (n_units,), dtype)
            for kind, is_moe in entries)
    if n_rest:
        params["rest"] = tuple(
            _layer_init(generator, cfg, kind, is_moe, dev, (), dtype)
            for kind, is_moe in entries[:n_rest])
    return params


# ------------------------------------------------------------- logical axes
def _dense_axes(cfg, in_axis, out_axes, use_bias=None):
    a = {"w": (in_axis, *out_axes)}
    if cfg.use_bias if use_bias is None else use_bias:
        a["b"] = tuple(out_axes)
    return a


def _norm_axes(cfg):
    a = {"scale": (L.EMBED,)}
    if cfg.norm == "layernorm" and cfg.use_bias:
        a["bias"] = (L.EMBED,)
    return a


def _mlp_axes(cfg, use_bias):
    return {"gate": _dense_axes(cfg, L.EMBED, (L.FFN,), use_bias),
            "up": _dense_axes(cfg, L.EMBED, (L.FFN,), use_bias),
            "down": _dense_axes(cfg, L.FFN, (L.EMBED,), use_bias)}


def _mix_axes(cfg, kind):
    if kind in _ATTN_KINDS:
        o = _dense_axes(cfg, L.HEADS, (L.EMBED,))
        o["w"] = (L.HEADS, L.HEAD_DIM, L.EMBED)
        a = {"q": _dense_axes(cfg, L.EMBED, (L.HEADS, L.HEAD_DIM)),
             "k": _dense_axes(cfg, L.EMBED, (L.KV_HEADS, L.HEAD_DIM)),
             "v": _dense_axes(cfg, L.EMBED, (L.KV_HEADS, L.HEAD_DIM)),
             "o": o}
        if cfg.attn_gate:
            a["g"] = _dense_axes(cfg, L.EMBED, (L.HEADS, L.HEAD_DIM))
        if cfg.qk_norm:
            a["q_norm"] = {"scale": (L.HEAD_DIM,)}
            a["k_norm"] = {"scale": (L.HEAD_DIM,)}
        return a
    if kind == RGLRU:
        return {"gate": _dense_axes(cfg, L.EMBED, (L.RNN,), False),
                "x": _dense_axes(cfg, L.EMBED, (L.RNN,), False),
                "out": _dense_axes(cfg, L.RNN, (L.EMBED,), False),
                "conv_w": (L.CONV, L.RNN), "conv_b": (L.RNN,),
                "w_r": (L.RNN, L.RNN), "b_r": (L.RNN,),
                "w_i": (L.RNN, L.RNN), "b_i": (L.RNN,), "lam": (L.RNN,)}
    if kind == MLSTM:
        return {"up": (L.EMBED, L.FFN), "down": (L.FFN, L.EMBED),
                "wq": (L.FFN, L.FFN), "wk": (L.FFN, L.FFN), "wv": (L.FFN, L.FFN),
                "wi": (L.FFN, L.HEADS), "wf": (L.FFN, L.HEADS),
                "bi": (L.HEADS,), "bf": (L.HEADS,), "ogate_skip": (L.FFN,)}
    return {"w": (L.EMBED, L.FFN), "b": (L.FFN,),
            "r": (L.CONV, L.HEADS, L.HEAD_DIM, L.HEAD_DIM),
            "ffn_up": (L.EMBED, L.FFN), "ffn_down": (L.FFN, L.EMBED)}


def _layer_axes(cfg, kind, is_moe):
    a = {"norm1": _norm_axes(cfg), "mix": _mix_axes(cfg, kind)}
    if cfg.sandwich_norm:
        a["post1"] = _norm_axes(cfg)
        a["post2"] = _norm_axes(cfg)
    if kind in _XLSTM_KINDS:
        return a
    a["norm2"] = _norm_axes(cfg)
    if is_moe:
        a["ffn"] = {"router": _dense_axes(cfg, L.EMBED, (L.EXPERTS,), False),
                    "gate": (L.EXPERTS, L.EMBED, L.FFN),
                    "up": (L.EXPERTS, L.EMBED, L.FFN),
                    "down": (L.EXPERTS, L.FFN, L.EMBED)}
        if cfg.moe.shared_expert:
            a["ffn"]["shared"] = _mlp_axes(cfg, False)
    else:
        a["ffn"] = _mlp_axes(cfg, cfg.use_bias)
    return a


def _stacked(axes):
    return tree.map(lambda a: (L.STACK, *a), axes, is_leaf=sh.is_axes)


def param_axes(cfg):
    """The logical axes of every param ``init`` draws, a tuple of names a
    leaf in the same tree (the JAX ``init``'s second return value): the
    stacked units' leaves lead with ``STACK``."""
    n_units, n_rest, entries = unit_layout(cfg)
    table = {"table": (L.VOCAB, L.EMBED)}
    axes: dict[str, Any] = {"embed": table}
    if not cfg.tie_embeddings:
        axes["unembed"] = dict(table)
    if cfg.encoder_only:
        axes["pos"] = (sh.SEQ, L.EMBED)
    axes["final_norm"] = _norm_axes(cfg)
    if lead_len(cfg):
        axes["lead"] = tuple(_layer_axes(cfg, kind, is_moe)
                             for kind, is_moe in lead_layout(cfg))
    if n_units:
        axes["units"] = tuple(_stacked(_layer_axes(cfg, kind, is_moe))
                              for kind, is_moe in entries)
    if n_rest:
        axes["rest"] = tuple(_layer_axes(cfg, kind, is_moe)
                             for kind, is_moe in entries[:n_rest])
    return axes


def _entry_cache_axes(kind):
    if kind in _ATTN_KINDS:
        seq = sh.KV_SEQ if kind != LOCAL_ATTN else None
        return {k: (sh.BATCH, seq, L.KV_HEADS, L.HEAD_DIM) for k in ("k", "v")}
    if kind == RGLRU:
        return {"h": (sh.BATCH, L.RNN), "conv": (sh.BATCH, None, L.RNN)}
    if kind == MLSTM:
        return {"C": (sh.BATCH, L.HEADS, None, None),
                "n": (sh.BATCH, L.HEADS, None), "m": (sh.BATCH, L.HEADS)}
    return {k: (sh.BATCH, None) for k in ("c", "n", "h", "m")}


def cache_axes(cfg):
    """The logical axes of ``cache_init``'s tree, leaf by leaf (None where
    the cache holds None)."""
    n_units, n_rest, entries = unit_layout(cfg)
    out = {"units": tuple(_stacked(_entry_cache_axes(kind)) for kind, _ in entries)
           if n_units else None,
           "rest": tuple(_entry_cache_axes(kind) for kind, _ in entries[:n_rest])
           if n_rest else None}
    if lead_len(cfg):
        out["lead"] = tuple(_entry_cache_axes(kind) for kind, _ in lead_layout(cfg))
    return out


# --------------------------------------------------------------------- layers
def _mix_apply(p, cfg, kind, hn, positions, cache_entry):
    if kind in _ATTN_KINDS:
        return attn.attn_apply(p, cfg, hn, positions, kind=kind, cache=cache_entry)[0]
    if kind == RGLRU:
        return rglru_lib.rglru_apply(p, cfg, hn, cache=cache_entry)[0]
    if kind == MLSTM:
        return xlstm_lib.mlstm_apply(p, cfg, hn, cache=cache_entry)[0]
    return xlstm_lib.slstm_apply(p, cfg, hn, cache=cache_entry)[0]


def _mix_decode(p, cfg, kind, hn, position, cache_entry):
    if kind in _ATTN_KINDS:
        return attn.attn_decode(p, cfg, hn, position, cache_entry, kind=kind)[0]
    if kind == RGLRU:
        return rglru_lib.rglru_decode(p, cfg, hn, cache_entry)[0]
    if kind == MLSTM:
        return xlstm_lib.mlstm_decode(p, cfg, hn, cache_entry)[0]
    return xlstm_lib.slstm_decode(p, cfg, hn, cache_entry)[0]


def _layer(p, cfg, kind, is_moe, h, mix, bias=None):
    """One layer around its temporal mix ``mix(hn) -> y`` (the cache entry,
    when there is one, filled in place). Returns (h, aux, load): the MoE
    FFN's load-balancing loss, or None; the dropless MoE FFN's expert
    load (``moe.moe_dropless``), or None. ``bias``: the dropless layer's
    expert bias. With ``cfg.sandwich_norm`` each branch's output is normed
    (``post1``, ``post2``) before its residual add."""
    def norm(key, x):
        return L.norm_apply(p[key], x, cfg.norm, cfg.norm_eps)

    y = mix(norm("norm1", h))
    h = h + (norm("post1", y) if cfg.sandwich_norm else y)
    if kind in _XLSTM_KINDS:
        return h, None, None
    hn = norm("norm2", h)
    aux = load = None
    if not is_moe:
        y = L.mlp_apply(p["ffn"], hn)
    elif cfg.moe.router == "sigmoid":
        y, load = moe_lib.moe_dropless(p["ffn"], cfg, hn, bias)
    else:
        y, aux = moe_lib.moe_apply(p["ffn"], cfg, hn)
    return h + (norm("post2", y) if cfg.sandwich_norm else y), aux, load


# remat="dots": a product without batch dims is ``mm`` / ``addmm``, or a
# ``bmm`` / ``baddbmm`` over a batch of 1, which is how ``torch.einsum``
# lowers a contraction without batch dims; a batched ``bmm`` is recomputed.
# A real batch dim of size 1 looks the same at this level and is saved too
# (more memory than JAX keeps, the same numbers)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_DOTS = {torch.ops.aten.bmm.default: 0, torch.ops.aten.baddbmm.default: 1}


def dots_policy(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"``: save what a
    matrix product without batch dims returns, recompute everything else."""
    if op in _DOTS or (op in _BATCHED_DOTS
                       and args[_BATCHED_DOTS[op]].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """``fn`` under ``cfg.remat`` when autograd records (training)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       dots_policy)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=context_fn)
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


def _add(total, aux):
    """total + aux, None standing for an exact 0 (no MoE layer yet): the
    JAX scan's sums from 0 without a kernel launch for a dense stack."""
    return aux if total is None else total if aux is None else total + aux


def _stack_forward(params, cfg, h, positions, cache, decode_position=None,
                   expert_bias=None):
    """Run all layers; cache may be None. Returns (h, aux, loads): aux the
    MoE layers' load-balancing losses summed a unit at a time, as the JAX
    scan carries it (None without MoE: an exact 0); loads the dropless
    layers' expert loads, one (num_experts + 1,) row a MoE layer in layer
    order, stacked (None without them). ``expert_bias`` (MoE layers,
    num_experts): row j routes the j-th MoE layer (None: zeros). Under
    autograd each layer is its own remat checkpoint (``_remat``)."""
    n_units, n_rest, entries = unit_layout(cfg)
    lead = lead_layout(cfg)
    ul = unit_len(cfg)
    row = {}                              # global layer index -> MoE row
    for i in range(cfg.num_layers):
        if cfg.layer_is_moe(i):
            row[i] = len(row)

    def one(h, p, kind, is_moe, ce, bias):
        if decode_position is not None:
            mix = lambda hn: _mix_decode(p["mix"], cfg, kind, hn, decode_position, ce)
        else:
            mix = lambda hn: _mix_apply(p["mix"], cfg, kind, hn, positions, ce)
        return _layer(p, cfg, kind, is_moe, h, mix, bias)

    def bound(p, kind, is_moe, ce, bias):
        """``one`` with all but the residual bound (a layer's own closure:
        its remat recompute reads these, not the loop's latest)."""
        return lambda h: one(h, p, kind, is_moe, ce, bias)

    training = decode_position is None and cache is None

    def run(layer_params, layer_caches, h, first, layout):
        aux_sum, loads = None, []
        for i, (kind, is_moe) in enumerate(layout[:len(layer_params)]):
            p, ce = layer_params[i], None if layer_caches is None else layer_caches[i]
            bias = (expert_bias[row[first + i]]
                    if is_moe and expert_bias is not None else None)
            layer = bound(p, kind, is_moe, ce, bias)
            h, aux, load = (_remat(layer, cfg) if training else layer)(h)
            aux_sum = _add(aux_sum, aux)
            if load is not None:
                loads.append(load)
        return h, aux_sum, loads

    aux_total, all_loads = None, []
    if lead:
        h, aux, loads = run(params["lead"], None if cache is None else cache["lead"], h,
                            0, lead)
        aux_total = _add(aux_total, aux)
        all_loads += loads
    if n_units:
        units = _unit_params(params["units"])
        caches = (None if cache is None
                  else _unit_params(cache["units"]))
        for u in range(n_units):
            h, aux, loads = run(units[u], None if caches is None else caches[u], h,
                                len(lead) + u * ul, entries)
            aux_total = _add(aux_total, aux)
            all_loads += loads
    if n_rest:
        h, aux, loads = run(params["rest"], None if cache is None else cache["rest"], h,
                            len(lead) + n_units * ul, entries)
        aux_total = _add(aux_total, aux)
        all_loads += loads
    return h, aux_total, torch.stack(all_loads) if all_loads else None


# -------------------------------------------------------------------- embedding
def _embed_inputs(params, cfg, batch, dtype=torch.bfloat16):
    """Token / frontend-stub embedding. Returns (h, positions)."""
    if cfg.frontend == "audio":
        h = batch["frame_embeds"].to(dtype)
        B, S = h.shape[:2]
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        h = L.embed_apply(params["embed"], tokens, dtype)
        if cfg.embed_scale:             # muP: the table times sqrt(d_model)
            h = h * math.sqrt(cfg.d_model)
        if cfg.frontend == "vision" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(dtype)
            h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
    if cfg.encoder_only:
        h = h + params["pos"][:S].to(dtype)
    positions = torch.arange(S, device=h.device).expand(B, S)
    return h, positions


def _unembed(params, cfg, h):
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed_apply(table, h)


# ------------------------------------------------------------------ entrypoints
def train_loss(params, cfg, batch, expert_bias=None):
    """Next-token (or masked-unit) cross entropy in bf16 activations.
    ``batch``: tokens (or, for the audio frontend, frame_embeds) and labels
    (B, S), optional loss_mask and patch_embeds. Returns (loss, metrics):
    loss is the cross entropy plus 0.01 times the MoE aux; metrics
    ``loss`` (the cross entropy), ``accuracy`` (token top-1) and ``aux``,
    and for dropless MoE layers ``expert_load`` (MoE layers, num_experts +
    1) int64 (``moe.moe_dropless``), routed by ``expert_bias``."""
    h, positions = _embed_inputs(params, cfg, batch)
    h, aux, loads = _stack_forward(params, cfg, h, positions, None,
                                   expert_bias=expert_bias)
    h = L.norm_apply(params["final_norm"], h, cfg.norm, cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    aux = zero if aux is None else aux

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
    tot, totacc, totw = zero, zero, zero
    # h split once: the backward of a slice a chunk would write a zero
    # tensor of the whole (B, S, d) residual for every chunk
    for c, h_c in enumerate(h.split(chunk, dim=1)):
        sl = slice(c * chunk, (c + 1) * chunk)
        ms = (torch.ones(labels[:, sl].shape, dtype=torch.float32, device=h.device)
              if mask is None else mask[:, sl].to(torch.float32))
        nll, acc = loss_fn(h_c, labels[:, sl], ms)
        tot, totacc, totw = tot + nll, totacc + acc, totw + ms.sum()
    totw = torch.clamp_min(totw, 1.0)
    loss = tot / totw + 0.01 * aux
    metrics = {"loss": (tot / totw).detach(), "accuracy": totacc / totw,
               "aux": aux.detach()}
    if loads is not None:
        metrics["expert_load"] = loads
    return loss, metrics


def prefill(params, cfg, batch, cache, dtype=torch.bfloat16, expert_bias=None):
    """Process the prompt (or, encoder-only, the frames), fill the cache
    (None: no cache), return last-position logits (fp32).
    ``dtype`` is the activation/residual dtype (blocks compute in fp32
    internally and cast back to it; fp32 here keeps the whole stack fp32 —
    the numerics oracle for prefill-vs-decode consistency checks)."""
    h, positions = _embed_inputs(params, cfg, batch, dtype=dtype)
    h, _, _ = _stack_forward(params, cfg, h, positions, cache, expert_bias=expert_bias)
    h_last = L.norm_apply(params["final_norm"], h[:, -1:], cfg.norm, cfg.norm_eps)
    return _unembed(params, cfg, h_last)[:, 0], cache


def decode_step(params, cfg, tokens, cache, position: int, dtype=torch.bfloat16,
                expert_bias=None):
    """One decode step. tokens (B,1); position an int, the same for every row."""
    if cfg.frontend == "audio":
        raise ValueError("encoder-only arch has no decode step")
    h = L.embed_apply(params["embed"], tokens, dtype)
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    h, _, _ = _stack_forward(params, cfg, h, None, cache, decode_position=position,
                             expert_bias=expert_bias)
    h = L.norm_apply(params["final_norm"], h, cfg.norm, cfg.norm_eps)
    return _unembed(params, cfg, h)[:, 0], cache


# ------------------------------------------------------------------- caches
def _entry_cache(cfg, kind, batch, max_seq, device, dtype, lead):
    if kind in _ATTN_KINDS:
        return attn.attn_cache_init(cfg, kind, batch, max_seq, device, dtype, lead)
    if kind == RGLRU:
        return rglru_lib.rglru_cache_init(cfg, batch, device, dtype, lead)
    if kind == MLSTM:
        return xlstm_lib.mlstm_state_init(cfg, batch, device, lead)
    if kind == SLSTM:
        return xlstm_lib.slstm_state_init(cfg, batch, device, lead)
    raise ValueError(kind)


def cache_init(cfg, batch, max_seq, device="cuda", dtype=torch.bfloat16):
    """Caches mirroring the unit/rest layout: ``{"units": (per layer of the
    unit: its entry stacked over n_units), "rest": (...) or None}``. An
    entry is {"k", "v"} for attention (``dtype``), {"h" (fp32), "conv"
    (``dtype``)} for RG-LRU, {"C", "n", "m"} for mLSTM and {"c", "n", "h",
    "m"} for sLSTM (fp32)."""
    dev = device_lib.resolve(device)
    n_units, n_rest, entries = unit_layout(cfg)
    units = tuple(_entry_cache(cfg, kind, batch, max_seq, dev, dtype, (n_units,))
                  for kind, _ in entries) if n_units else None
    rest = tuple(_entry_cache(cfg, kind, batch, max_seq, dev, dtype, ())
                 for kind, _ in entries[:n_rest]) if n_rest else None
    out = {"units": units, "rest": rest}
    if lead_len(cfg):
        out["lead"] = tuple(_entry_cache(cfg, kind, batch, max_seq, dev, dtype, ())
                            for kind, _ in lead_layout(cfg))
    return out


def param_count(params) -> int:
    return sum(x.numel() for x in tree.leaves(params))
