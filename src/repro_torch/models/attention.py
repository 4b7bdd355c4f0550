"""Attention: GQA projections, flash attention over the prompt, and
one-token decode against a KV cache (full or ring-buffered window).

Port of the JAX package's ``models/attention.py``. Full-sequence attention
goes through ``models.flash`` (the flash kernel and its recompute backward)
with ``attn_impl="flash"``, and through the blocked online-softmax scans
(``_blocked_global``, ``_blocked_local``: plain PyTorch, differentiated by
autograd as JAX AD differentiates them) with ``attn_impl="naive"``;
decode is plain PyTorch (``_sdpa``), as the JAX package does it outside any
kernel. Caches are updated in place: ``attn_apply`` and ``attn_decode``
write the new keys and values into the cache tensors they are given (the
JAX functions return new arrays), which saves a cache-sized copy a step.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ENC_ATTN, LOCAL_ATTN
from repro_torch.models import layers as L
from repro_torch.models.flash import flash_attention_padded

NEG_INF = -2.0e38


def attn_init(generator, cfg, device, lead=(), dtype=None):
    """q, k, v, o dense params; the weights stored in ``dtype``. With
    ``cfg.qk_norm`` an RMSNorm scale a head dim for q and for k
    (``q_norm``, ``k_norm``); with ``cfg.attn_gate`` the output gate ``g``
    (d -> H x Dh)."""
    d, H, KH, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    kw = dict(use_bias=cfg.use_bias, device=device, lead=lead, dtype=dtype)
    p = {"q": L.dense_init(generator, d, (H, Dh), **kw),
         "k": L.dense_init(generator, d, (KH, Dh), **kw),
         "v": L.dense_init(generator, d, (KH, Dh), **kw),
         "o": L.dense_init(generator, H * Dh, (d,), **kw)}
    # o as (H, Dh, d) for a 2-dim contraction
    p["o"]["w"] = p["o"]["w"].reshape(*lead, H, Dh, d)
    if cfg.attn_gate:
        p["g"] = L.dense_init(generator, d, (H, Dh), **kw)
    if cfg.qk_norm:
        p["q_norm"] = L.norm_init(Dh, "rmsnorm", False, device, lead)
        p["k_norm"] = L.norm_init(Dh, "rmsnorm", False, device, lead)
    return p


def _rotary_dim(cfg, kind):
    if not cfg.rope_on(kind):
        return 0
    if cfg.rope == "partial":  # GLM-style 2d rope: rotate half the head dims
        return cfg.resolved_head_dim // 2
    return cfg.resolved_head_dim


def _project_qkv(p, cfg, x, positions, kind):
    q = L.dense_apply(p["q"], x)          # (B,S,H,Dh)
    k = L.dense_apply(p["k"], x)          # (B,S,KH,Dh)
    v = L.dense_apply(p["v"], x)
    if cfg.qk_norm:
        q = L.norm_apply(p["q_norm"], q, "rmsnorm", cfg.norm_eps)
        k = L.norm_apply(p["k_norm"], k, "rmsnorm", cfg.norm_eps)
    rd = _rotary_dim(cfg, kind)
    if rd:
        q = L.apply_rope(q, positions, rotary_dim=rd, theta=cfg.rope_theta)
        k = L.apply_rope(k, positions, rotary_dim=rd, theta=cfg.rope_theta)
    return q, k, v


def _output(p, cfg, x, ctx):
    """ctx (B, S, H, Dh) -> (B, S, d): times sigmoid(x W_g) first with
    ``cfg.attn_gate``."""
    if cfg.attn_gate:
        ctx = ctx * torch.sigmoid(L.dense_apply(p["g"], x))
    return L.dense_apply(p["o"], ctx, contract_dims=2)


def _mask_bias(q_pos, k_pos, *, causal, window, kv_valid=None):
    """Additive fp32 bias (bq, bkv) from absolute positions."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=k_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    if kv_valid is not None:
        ok &= kv_valid[None, :]
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _sdpa(q, k, v, bias):
    """One-shot attention on a (small) KV span. q (B,bq,KH,G,Dh), k/v (B,bkv,KH,Dh).
    Scores in fp32 (the JAX einsum's preferred_element_type), p in v's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32), k.to(torch.float32))
    s = s * scale + bias
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v)


def _blocks(n, block, what):
    b = min(block, n)
    if n % b:
        raise ValueError(f"{what} {n} is not a multiple of its block {b}")
    return b, n // b


def _blocked_global(q, k, v, *, causal, q_offset, block_q, block_kv):
    """Blocked attention with an online softmax (fp32 running max and
    denominator). q (B,Sq,KH,G,Dh); k/v (B,Skv,KH,Dh)."""
    B, Sq, KH, G, Dh = q.shape
    Skv = k.shape[1]
    bq, nq = _blocks(Sq, block_q, "query length")
    bkv, nk = _blocks(Skv, block_kv, "key length")
    scale = Dh ** -0.5
    outs = []
    for i in range(nq):
        q_blk = q[:, i * bq:(i + 1) * bq]
        q_pos = q_offset + i * bq + torch.arange(bq, device=q.device)
        m = torch.full((B, KH, G, bq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KH, G, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KH, G, bq, Dh), dtype=torch.float32, device=q.device)
        for j in range(nk):
            k_blk, v_blk = k[:, j * bkv:(j + 1) * bkv], v[:, j * bkv:(j + 1) * bkv]
            k_pos = j * bkv + torch.arange(bkv, device=q.device)
            bias = _mask_bias(q_pos, k_pos, causal=causal, window=0)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk.to(torch.float32),
                             k_blk.to(torch.float32)) * scale + bias
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_blk.dtype), v_blk)
            acc = acc * alpha[..., None] + pv.to(torch.float32)
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-37)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))   # (B,bq,KH,G,Dh)
    return torch.cat(outs, dim=1)


def _blocked_local(q, k, v, *, window, q_offset, block_q):
    """Exact banded attention: per q block slice KV[band]; O(S*(W+bq)) FLOPs."""
    B, Sq, KH, G, Dh = q.shape
    Skv = k.shape[1]
    bq, nq = _blocks(Sq, block_q, "query length")
    band = min(Skv, window + bq)
    outs = []
    for i in range(nq):
        q_start = q_offset + i * bq
        start = min(max(q_start + bq - band, 0), Skv - band)
        q_pos = q_start + torch.arange(bq, device=q.device)
        k_pos = start + torch.arange(band, device=q.device)
        bias = _mask_bias(q_pos, k_pos, causal=True, window=window)
        outs.append(_sdpa(q[:, i * bq:(i + 1) * bq], k[:, start:start + band],
                          v[:, start:start + band], bias))
    return torch.cat(outs, dim=1)


def attn_apply(p, cfg, x, positions, *, kind, cache=None):
    """Full-sequence attention (training, prefill). Returns (y, cache), the
    cache filled in place."""
    B, S, _ = x.shape
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(p, cfg, x, positions, kind)
    qg = q.reshape(B, S, KH, H // KH, Dh)
    if cfg.attn_impl == "flash":
        causal = kind != ENC_ATTN
        window = cfg.window if kind == LOCAL_ATTN else 0
        ctx = flash_attention_padded(qg, k, v, causal, window)
    elif cfg.attn_impl != "naive":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    elif kind == LOCAL_ATTN:
        ctx = _blocked_local(qg, k, v, window=cfg.window, q_offset=0,
                             block_q=cfg.attn_block_q)
    else:
        ctx = _blocked_global(qg, k, v, causal=kind != ENC_ATTN, q_offset=0,
                              block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv)
    y = _output(p, cfg, x, ctx.reshape(B, S, H, Dh))
    if cache is not None:
        _prefill_cache(cache, k, v, kind, seq_len=S)
    return y, cache


# ------------------------------------------------------------------- KV caching
def attn_cache_init(cfg, kind, batch, max_seq, device, dtype=torch.bfloat16,
                    lead=()):
    KH, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    length = min(max_seq, cfg.window) if kind == LOCAL_ATTN else max_seq
    shape = (*lead, batch, length, KH, Dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _prefill_cache(cache, k, v, kind, seq_len):
    """Write prefill K/V into the cache. Ring layout: slot = pos % length."""
    length = cache["k"].shape[1]
    if kind == LOCAL_ATTN and seq_len > length:
        # keep the trailing `length` positions, placed at their ring slots
        slots = torch.arange(seq_len - length, seq_len, device=k.device) % length
        cache["k"][:, slots] = k[:, -length:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, -length:].to(cache["v"].dtype)
    else:
        n = min(length, seq_len)
        cache["k"][:, :n] = k[:, :n].to(cache["k"].dtype)
        cache["v"][:, :n] = v[:, :n].to(cache["v"].dtype)


def attn_decode(p, cfg, x, position: int, cache, *, kind):
    """One-token decode at ``position`` (the same for every row). x (B,1,d).
    Writes this token's K/V into the cache in place; returns (y, cache)."""
    B = x.shape[0]
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pos = torch.full((B, 1), position, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, pos, kind)  # q (B,1,H,Dh); k/v (B,1,KH,Dh)
    length = cache["k"].shape[1]
    slot = position % length if kind == LOCAL_ATTN else position
    if not 0 <= slot < length:
        raise IndexError(f"decode position {position} is past the cache "
                         f"length {length}")
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)

    qg = q.reshape(B, 1, KH, H // KH, Dh)
    q_pos = torch.full((1,), position, dtype=torch.int64, device=x.device)
    s_idx = torch.arange(length, device=x.device)
    if kind == LOCAL_ATTN:
        # ring buffer: slot s holds absolute position p where p % length == s
        # and p <= position; reconstruct absolute positions for masking.
        k_pos = s_idx + torch.div(position - s_idx, length,
                                  rounding_mode="floor") * length
        kv_valid = (k_pos >= 0) & (k_pos > position - cfg.window)
        bias = _mask_bias(q_pos, k_pos, causal=False, window=0, kv_valid=kv_valid)
    else:
        bias = _mask_bias(q_pos, s_idx, causal=True, window=0)
    ctx = _sdpa(qg, cache["k"], cache["v"], bias).reshape(B, 1, H, Dh)
    return _output(p, cfg, x, ctx), cache
