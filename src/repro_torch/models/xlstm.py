"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, sequential scan).

Port of the JAX package's ``models/xlstm.py`` with its param and state
layout. Everything computes in fp32 whatever the activation dtype, as
there, and the raw fp32 matrices are used as they are (never cast).

mLSTM recurrence per head (stabilized, exponential gating):

    m_t  = max(logsig(f̃_t) + m_{t-1}, ĩ_t)
    C_t  = f'_t C_{t-1} + i'_t v_t k_tᵀ      f' = exp(logf + m_{t-1} - m_t)
    n_t  = f'_t n_{t-1} + i'_t k_t           i' = exp(ĩ - m_t)
    h_t  = C_tᵀ q_t / max(|n_tᵀ q_t|, exp(-m_t))

Prefill runs the chunkwise form: a loop over ``cfg.scan_chunk`` chunks
carrying the stabilized (C, n, m), the quadratic decay-matrix form inside a
chunk. A ragged S is padded to a chunk multiple with gate-neutral
positions (i' = 0: ĩ = -1e30; f' = 1: log f = 0). Decode is one recurrence
step carried in the cache.

sLSTM is a sequential loop over time in prefill as in JAX (its
block-diagonal recurrent weights make a step cheap); xlstm-125m places
one sLSTM per 4 blocks. Caches are written in place.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.core import tracecheck
from repro_torch.models import layers as L

_PF = 2          # mLSTM up-projection factor
_FFN_PF = 4 / 3  # sLSTM trailing-FFN factor
_pt = torch.float32


def _proj(generator, din, dout, device, lead, scale=1.0):
    return L._trunc(generator, (din, dout), scale / math.sqrt(din), device, lead)


def _full(lead, shape, value, device):
    return torch.full((*lead, *shape), value, dtype=_pt, device=device)


# ================================================================= mLSTM block
def mlstm_init(generator, cfg, device, lead=()):
    d = cfg.d_model
    di = _PF * d                      # inner width
    H = cfg.num_heads

    def proj(din, dout, scale=1.0):
        return _proj(generator, din, dout, device, lead, scale)

    return {
        "up": proj(d, 2 * di),
        "down": proj(di, d),
        "wq": proj(di, di),
        "wk": proj(di, di),
        "wv": proj(di, di),
        # scalar-per-head gates from the inner activations
        "wi": proj(di, H, scale=0.1),
        "wf": proj(di, H, scale=0.1),
        "bi": _full(lead, (H,), 0.0, device),
        "bf": (3.0 + torch.arange(H, dtype=_pt, device=device) * 0.5).expand(
            *lead, H).clone(),        # forget-bias init
        "ogate_skip": _full(lead, (di,), 1.0, device),
    }


def _mlstm_qkv_gates(p, cfg, u):
    """u (B,S,di) -> q,k,v (B,S,H,Dh) fp32; logf, logi (B,S,H) fp32."""
    B, S, di = u.shape
    H = cfg.num_heads
    Dh = di // H
    uf = u.to(_pt)
    q = (uf @ p["wq"]).reshape(B, S, H, Dh)
    k = (uf @ p["wk"]).reshape(B, S, H, Dh) * (Dh ** -0.5)
    v = (uf @ p["wv"]).reshape(B, S, H, Dh)
    logi = uf @ p["wi"] + p["bi"]                       # ĩ
    logf = F.logsigmoid(uf @ p["wf"] + p["bf"])         # log f
    return q, k, v, logf, logi


def _mlstm_chunk(carry, inp):
    """One chunk of the chunkwise form. carry: (C (B,H,Dh,Dh), n (B,H,Dh),
    m (B,H)); inp: q,k,v (B,Lc,H,Dh), logf, logi (B,Lc,H)."""
    C, n, m = carry
    q, k, v, logf, logi = inp
    Lc = q.shape[1]
    Fc = torch.cumsum(logf, dim=1)                      # (B,Lc,H)
    # running stabilizer: M_i = max(m_prev, max_{j<=i}(ĩ_j - F_j))
    g = torch.cummax(logi - Fc, dim=1).values
    M = torch.maximum(m[:, None], g)                    # (B,Lc,H)
    m_new = Fc[:, -1] + M[:, -1]

    # intra-chunk: S_ij = (q_i k_j) exp(F_i - F_j + ĩ_j - m_i), j <= i
    logD = (Fc[:, :, None] - Fc[:, None, :] + logi[:, None, :]
            - M[:, :, None])                            # (B,i,j,H)
    mask = torch.ones((Lc, Lc), dtype=torch.bool, device=q.device).tril()
    logD = torch.where(mask[None, :, :, None], logD, -torch.inf)
    qk = torch.einsum("bihd,bjhd->bijh", q, k)
    Smat = qk * torch.exp(logD)
    num_intra = torch.einsum("bijh,bjhd->bihd", Smat, v)
    den_intra = torch.sum(Smat, dim=2)                  # Σ_j S_ij -> (B,i,H)

    # inter-chunk: weight exp(F_i + m_prev - m_i) = exp(m_prev - M_i)
    w_inter = torch.exp(m[:, None] - M)                 # (B,Lc,H)
    num_inter = torch.einsum("bihd,bhde->bihe", q, C) * w_inter[..., None]
    den_inter = torch.einsum("bihd,bhd->bih", q, n) * w_inter

    m_i = Fc + M                                        # absolute stabilizer
    denom = torch.maximum(torch.abs(den_intra + den_inter), torch.exp(-m_i))
    h = (num_intra + num_inter) / denom[..., None]      # (B,Lc,H,Dh)

    # carry update to end of chunk
    w_c = torch.exp(m - m_new)                          # (B,H)
    w_kv = torch.exp(Fc[:, -1][:, None] - Fc + logi - m_new[:, None])  # (B,Lc,H)
    C_new = C * w_c[..., None, None] + torch.einsum(
        "bjh,bjhd,bjhe->bhde", w_kv, k, v)
    n_new = n * w_c[..., None] + torch.einsum("bjh,bjhd->bhd", w_kv, k)
    return (C_new, n_new, m_new), h


def mlstm_state_init(cfg, batch, device, lead=()):
    di = _PF * cfg.d_model
    H = cfg.num_heads
    Dh = di // H
    return {"C": _full(lead, (batch, H, Dh, Dh), 0.0, device),
            "n": _full(lead, (batch, H, Dh), 0.0, device),
            "m": _full(lead, (batch, H), -1e30, device)}


def _write(cache, new):
    for key, value in new.items():
        cache[key].copy_(value)


def mlstm_apply(p, cfg, x, *, cache=None):
    """x (B,S,d). Chunkwise over cfg.scan_chunk. Returns (y, cache), the
    cache (when given) carried in and written in place."""
    B, S, d = x.shape
    up = x.to(_pt) @ p["up"]
    u, gate = torch.chunk(up, 2, dim=-1)                # (B,S,di) each
    q, k, v, logf, logi = _mlstm_qkv_gates(p, cfg, u)
    Lc = min(cfg.scan_chunk, S)
    pad = (-S) % Lc
    if pad:
        zpad = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        q, k, v, logf = zpad(q), zpad(k), zpad(v), zpad(logf)       # log f = 0
        logi = F.pad(logi, (0, 0, 0, pad), value=-1e30)             # i' = 0
    st = cache if cache is not None else mlstm_state_init(cfg, B, x.device)
    carry = (st["C"], st["n"], st["m"])
    hs = []
    # split, not a slice a chunk: the backward of each slice would write a
    # zero tensor of the whole sequence (see _slstm_steps)
    for chunk in zip(*(t.split(Lc, dim=1) for t in (q, k, v, logf, logi))):
        carry, h = _mlstm_chunk(carry, chunk)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S + pad, -1)[:, :S]   # (B,S,di)
    h = h + p["ogate_skip"] * u                         # learnable skip
    y = h * F.silu(gate)
    y = (y @ p["down"]).to(x.dtype)
    if cache is not None:
        _write(cache, dict(zip(("C", "n", "m"), carry)))
    return y, cache


def mlstm_decode(p, cfg, x, cache):
    """Single-token recurrence step. x (B,1,d); the cache is updated in
    place."""
    up = x.to(_pt) @ p["up"]
    u, gate = torch.chunk(up, 2, dim=-1)
    q, k, v, logf, logi = _mlstm_qkv_gates(p, cfg, u)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                 # (B,H,Dh)
    logf, logi = logf[:, 0], logi[:, 0]                 # (B,H)
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(logf + m, logi)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(logi - m_new)
    C_new = C * fp[..., None, None] + ip[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = n * fp[..., None] + ip[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n_new)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(x.shape[0], 1, -1)
    h = h + p["ogate_skip"] * u
    y = h * F.silu(gate)
    _write(cache, {"C": C_new, "n": n_new, "m": m_new})
    return (y @ p["down"]).to(x.dtype), cache


# ================================================================= sLSTM block
def slstm_init(generator, cfg, device, lead=()):
    d = cfg.d_model
    H = cfg.num_heads
    Dh = d // H
    dff = int(d * _FFN_PF)
    w = _proj(generator, d, 4 * d, device, lead)    # z,i,f,o input weights (d, 4d)
    b = torch.cat([_full(lead, (2 * d,), 0.0, device),
                   _full(lead, (d,), 1.0, device),   # forget bias +1
                   _full(lead, (d,), 0.0, device)], dim=-1)
    # block-diagonal recurrent weights per head: (4, H, Dh, Dh)
    r = L.normal(generator, (4, H, Dh, Dh), 0.4 / Dh ** 0.5, device, lead)
    return {"w": w, "b": b, "r": r,
            "ffn_up": _proj(generator, d, dff, device, lead),
            "ffn_down": _proj(generator, dff, d, device, lead)}


def slstm_state_init(cfg, batch, device, lead=()):
    d = cfg.d_model
    return {"c": _full(lead, (batch, d), 0.0, device),
            "n": _full(lead, (batch, d), 1.0, device),
            "h": _full(lead, (batch, d), 0.0, device),
            "m": _full(lead, (batch, d), 0.0, device)}


def _slstm_step(p, cfg, state, wx_t):
    """One timestep. wx_t (B, 4d) precomputed input contribution."""
    H = cfg.num_heads
    B = wx_t.shape[0]
    d = wx_t.shape[1] // 4
    Dh = d // H
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    # the four gates' block-diagonal products in one batched product
    rec = torch.einsum("bhd,ghde->bheg", h.reshape(B, H, Dh), p["r"]).reshape(B, d, 4)
    pre = wx_t.reshape(B, d, 4) + rec + p["b"].reshape(4, d).T
    z = torch.tanh(pre[..., 0])
    itil = pre[..., 1]
    ftil = F.logsigmoid(pre[..., 2])
    o = torch.sigmoid(pre[..., 3])
    m_new = torch.maximum(ftil + m, itil)
    ip = torch.exp(itil - m_new)
    fp = torch.exp(ftil + m - m_new)
    c_new = fp * c + ip * z
    n_new = torch.clamp_min(fp * n + ip, 1e-6)
    h_new = o * (c_new / n_new)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_out(p, h, dtype):
    return (F.gelu(h @ p["ffn_up"], approximate="tanh") @ p["ffn_down"]).to(dtype)


def _slstm_steps(p, cfg, st, wx):
    """The sequential loop over wx's (B, S, 4d) steps from state st.
    Returns (hs (B, S, d), the last state)."""
    hs = []
    # unbind, not wx[:, t]: the backward of a step's index writes a zero
    # tensor of the whole (B, S, 4d) input, O(S^2) bytes over the loop;
    # unbind's backward stacks the steps' grads once
    for wx_t in wx.unbind(1):
        st = _slstm_step(p, cfg, st, wx_t)
        hs.append(st["h"])
    return torch.stack(hs, dim=1), st


def slstm_apply(p, cfg, x, *, cache=None):
    """x (B,S,d) -> (B,S,d). Sequential loop over time. Returns (y, cache),
    the cache (when given) carried in and written in place.

    On the card without autograd (prefill) each run of GRAPH_STEPS steps
    replays one captured CUDA graph (``_StepGraph``: the same kernels, a
    few launches in place of ~25 a step); the remaining steps, the CPU and
    training run the loop eagerly."""
    B, S, d = x.shape
    wx = x.to(_pt) @ p["w"]                             # (B,S,4d)
    st = cache if cache is not None else slstm_state_init(cfg, B, x.device)
    hs = []
    n_graph = S - S % GRAPH_STEPS
    if x.is_cuda and n_graph and not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, p["w"], p["r"], p["b"]))):
        graph = _step_graph(cfg, B, x.device)
        st = graph.load(p, st)
        for t0 in range(0, n_graph, GRAPH_STEPS):
            hs.append(graph(wx[:, t0:t0 + GRAPH_STEPS]))
        st = {k: v.clone() for k, v in st.items()}
        wx = wx[:, n_graph:]
    if wx.shape[1]:
        h, st = _slstm_steps(p, cfg, st, wx)
        hs.append(h)
    y = _slstm_out(p, torch.cat(hs, dim=1), x.dtype)
    if cache is not None:
        _write(cache, st)
    return y, cache


GRAPH_STEPS = 64   # sLSTM steps one captured CUDA graph replays


class _StepGraph:
    """GRAPH_STEPS sLSTM steps captured once as a CUDA graph over static
    buffers: ``load`` copies a layer's recurrent weights and a state in,
    and returns the state buffers (the graph carries them from one replay
    to the next); a call copies GRAPH_STEPS steps' input contributions in,
    replays, and returns a copy of their h. One graph a shape, shared by
    the calls of a process, which run one after another on the current
    stream. Warm-up runs on a side stream before the capture, as CUDA
    graphs require. Each construction is one capture
    (``tracecheck.get_counter("models.xlstm.step_graph")``)."""

    @tracecheck.count_captures(name="models.xlstm.step_graph")
    def __init__(self, cfg, B, device):
        self.cfg = cfg
        d, H = cfg.d_model, cfg.num_heads
        f32 = dict(dtype=_pt, device=device)
        self.p = {"r": torch.zeros((4, H, d // H, d // H), **f32),
                  "b": torch.zeros((4 * d,), **f32)}
        self.state = {k: torch.zeros((B, d), **f32) for k in ("c", "n", "h", "m")}
        self.state["n"].fill_(1.0)
        self.wx = torch.zeros((B, GRAPH_STEPS, 4 * d), **f32)
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._run()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.hs = self._run()

    def _run(self):
        hs, st = _slstm_steps(self.p, self.cfg, self.state, self.wx)
        for k, v in st.items():
            self.state[k].copy_(v)
        return hs

    def load(self, p, st):
        for k in ("r", "b"):
            self.p[k].copy_(p[k])
        for k, v in st.items():
            self.state[k].copy_(v)
        return self.state

    def __call__(self, wx):
        self.wx.copy_(wx)
        self.graph.replay()
        return self.hs.clone()


@functools.lru_cache(maxsize=8)
def _step_graph(cfg, B, device):
    return _StepGraph(cfg, B, device)


def slstm_decode(p, cfg, x, cache):
    wx = (x.to(_pt) @ p["w"])[:, 0]
    st = _slstm_step(p, cfg, cache, wx)
    _write(cache, st)
    return _slstm_out(p, st["h"][:, None], x.dtype), cache
