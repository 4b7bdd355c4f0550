"""Trinity-Mini's (AFMoE) training steps in plain PyTorch, fp32, TF32 off
(the configuration's model as the program runs it, a device's share of it):
token embedding times sqrt(d); per layer an RMSNorm, GQA attention whose q
and k heads are RMS-normed (a scale a head dim), rotated (rotate-half over
the whole head) on the sliding-window layers only, attended causally (a
window on the sliding layers), gated by sigmoid(x W_g) and projected by
W_o, an RMSNorm of that output and a residual; an RMSNorm, the FFN (SwiGLU
on the leading dense layers; on the others the shared expert plus the held
experts' share of the routed ones), an RMSNorm of its output and a
residual; a final RMSNorm, a separate unembedding and the mean token cross
entropy. Then global-norm clipping and AdamW (the optax formulas, warmup-
cosine learning rate), and after each step the expert bias moved toward an
even load.

The router, per token, over all ``num_experts``: s = sigmoid(y W_r); the
top k of s + b (b the layer's expert bias) choose, s weights: w = s over
its sum (+ 1e-20) times ``route_scale``. Only the held experts [lo, hi)
are computed (a loop over them), every (token, choice) pair of theirs
kept: no capacity, nothing dropped. The bias, after each step: n_e the
step's pairs routed to expert e (all experts, this device's tokens),
delta = rate x sign(mean(n) - n), b += delta - mean(delta).

Departures from the description, each as the program runs it: the
description's RMSNorm epsilon is the config's 1e-5 everywhere (the
q / k norms too); the weights are this device's slice (the held experts,
the vocabulary rows kept), drawn from the seed, not the checkpoint's.

Routing decisions at near-ties: given the program's choices
(``choices[step][layer]``, (B x S, k) in (row, position) order), the
reference routes by them and counts as ``route_off`` each chosen expert
whose reference score s + b lies more than ``margin`` under the
reference's own k-th largest; within the margin the program's choice is
taken as its own (rounding decides such ties).

Memory: one sequence at a time (the grads accumulate), each layer and
each block of query rows recomputed in the backward, the logits a chunk
at a time; params, grads and both moments are kept per layer.
``operands="fp8"`` rounds every product's operands to float8 e4m3 with a
per-tensor scale (the control one precision below the program's bf16).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.glm import lr_at, round_fp8

BLOCK_Q = 1024
LOSS_CHUNK = 1024
SMALL = 1 << 20      # leaves kept whole for the element rule (norms)

_OPERANDS = {None: lambda x: x, "fp8": round_fp8}


class Model:
    """The reference's params: per layer, fp32 leaves that require grad.

    ``cfg``: num_layers, d_model, num_heads, num_kv_heads, head_dim,
    window, rope_theta, norm_eps, kinds (each layer's "attn" or
    "local_attn"), first_dense, unit_len, moe (num_experts, top_k, held
    [lo, hi), route_scale, bias_rate) and the program's
    ``leaf_paths``: ("lead", j, ...) is layer j, ("units", j, ...) stacked
    over the units is layer first_dense + u x unit_len + j, ("rest", j,
    ...) follows the units."""

    def __init__(self, cfg: dict, draw):
        """``draw(path)`` gives the fp32 value of the program's leaf at
        ``path``."""
        self.cfg = cfg
        L, lead, ul = cfg["num_layers"], cfg["first_dense"], cfg["unit_len"]
        n_units = (L - lead) // ul
        self.layers = [dict() for _ in range(L)]
        self.where = {}                      # path -> the layers it feeds
        for path in cfg["leaf_paths"]:
            full = draw(path)
            if path[0] in ("lead", "units", "rest"):
                j, key = int(path[1]), "/".join(path[2:])
                if path[0] == "units":
                    idx = [lead + u * ul + j for u in range(n_units)]
                    ts = [full[u].clone().requires_grad_(True) for u in range(n_units)]
                else:
                    idx = [j if path[0] == "lead" else lead + n_units * ul + j]
                    ts = [full.requires_grad_(True)]
                for i, t in zip(idx, ts):
                    self.layers[i][key] = t
                self.where[path] = (key, idx)
            else:
                setattr(self, "_".join(path), full.requires_grad_(True))
                self.where[path] = None
            del full
        self.embed = getattr(self, "embed_table", None)       # None: a layer alone
        self.unembed = getattr(self, "unembed_table", None)
        self.final = getattr(self, "final_norm_scale", None)
        self.moe_row = {}
        for i, lay in enumerate(self.layers):
            if "ffn/router/w" in lay:
                self.moe_row[i] = len(self.moe_row)

    def leaves(self):
        """(program path, [its tensors, one a layer it feeds])."""
        for path, at in self.where.items():
            if at is None:
                yield path, [getattr(self, "_".join(path))]
            else:
                key, idx = at
                yield path, [self.layers[i][key] for i in idx]


def _norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x (S, H, Dh): rotate-half over the whole head."""
    S, Dh = x.shape[0], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float32,
                                         device=x.device) / Dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :Dh // 2], x[..., Dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attend(q, k, v, q0, window):
    """Causal softmax attention of query rows [q0, q0 + bq), a window of
    ``window`` keys (0: all): q (bq, KH, G, Dh); k, v (S, KH, Dh)."""
    bq, Dh = q.shape[0], q.shape[-1]
    k0 = max(0, q0 - window + 1) if window else 0
    keys = slice(k0, q0 + bq)
    s = torch.einsum("qhgd,khd->hgqk", q, k[keys]) * Dh ** -0.5
    qpos = torch.arange(q0, q0 + bq, device=q.device)[:, None]
    kpos = torch.arange(k0, q0 + bq, device=q.device)[None, :]
    drop = kpos > qpos
    if window:
        drop = drop | (kpos <= qpos - window)
    p = torch.softmax(s.masked_fill(drop, float("-inf")), -1)
    return torch.einsum("hgqk,khd->qhgd", p, v[keys])


class Step:
    """One step's forward and backward. ``bias`` (MoE layers, experts) routes
    the MoE layers; ``choices`` [layer] (B x S, k), when given, the
    program's. After ``loss_backward``: ``loads`` (MoE layers, experts),
    ``route_off`` and ``route_lag`` (the largest amount by which a chosen
    expert's reference score lies under the k-th largest)."""

    def __init__(self, model: Model, operands=None, bias=None, choices=None,
                 margin=0.0):
        self.m, self.cfg = model, model.cfg
        self.rnd = _OPERANDS[operands]
        self.bias, self.choices, self.margin = bias, choices, margin
        E = self.cfg["moe"]["num_experts"]
        self.loads = torch.zeros((len(model.moe_row), E), dtype=torch.float64)
        self.route_off, self.route_lag = 0, 0.0
        self._seen = set()

    def _mm(self, x, w):
        return self.rnd(x) @ self.rnd(w)

    def _swiglu(self, x, gate, up, down):
        return self._mm(torch.nn.functional.silu(self._mm(x, gate)) * self._mm(x, up), down)

    def _route(self, y, i, row):
        c = self.cfg["moe"]
        p, j = self.m.layers[i], self.m.moe_row[i]
        S, k = y.shape[0], c["top_k"]
        s = torch.sigmoid(self._mm(y, p["ffn/router/w"]))
        r = s.detach() + (0.0 if self.bias is None else self.bias[j].to(s.device))
        top = torch.sort(r, dim=-1, descending=True, stable=True)
        if self.choices is None:
            chosen = top.indices[:, :k]
        else:
            chosen = self.choices[j][row * S:(row + 1) * S].to(s.device).long()
        if (row, i) not in self._seen:      # once, not again in the recompute
            self._seen.add((row, i))
            lag = top.values[:, k - 1:k] - r.gather(1, chosen)
            self.route_off += int((lag > self.margin).sum())
            self.route_lag = max(self.route_lag, float(lag.max()))
            self.loads[j] += torch.bincount(chosen.reshape(-1).cpu(),
                                            minlength=r.shape[1]).double()
        w = s.gather(1, chosen)
        w = w / (w.sum(-1, keepdim=True) + 1e-20)        # route_norm
        return w * c["route_scale"], chosen

    def _moe(self, y, i, row):
        c, p = self.cfg["moe"], self.m.layers[i]
        w, chosen = self._route(y, i, row)
        out = self._swiglu(y, p["ffn/shared/gate/w"], p["ffn/shared/up/w"],
                           p["ffn/shared/down/w"])
        lo, hi = c["held"]
        for e in range(lo, hi):
            hit = chosen == e                              # (S, k)
            rows = hit.any(1).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            we = (w * hit)[rows].sum(1, keepdim=True)
            ye = self._swiglu(y[rows], p["ffn/gate"][e - lo], p["ffn/up"][e - lo],
                              p["ffn/down"][e - lo])
            out = out.index_add(0, rows, we * ye)
        return out

    def _attention(self, x, i):
        c, p = self.cfg, self.m.layers[i]
        H, KH, Dh, d = c["num_heads"], c["num_kv_heads"], c["head_dim"], c["d_model"]
        S, eps = x.shape[0], c["norm_eps"]
        local = c["kinds"][i] == "local_attn"
        q = self._mm(x, p["mix/q/w"].reshape(d, H * Dh)).reshape(S, H, Dh)
        k = self._mm(x, p["mix/k/w"].reshape(d, KH * Dh)).reshape(S, KH, Dh)
        v = self._mm(x, p["mix/v/w"].reshape(d, KH * Dh)).reshape(S, KH, Dh)
        q, k = _norm(q, p["mix/q_norm/scale"], eps), _norm(k, p["mix/k_norm/scale"], eps)
        if local:
            q, k = _rope(q, c["rope_theta"]), _rope(k, c["rope_theta"])
        qg = self.rnd(q).reshape(S, KH, H // KH, Dh)
        kr, vr = self.rnd(k), self.rnd(v)
        window = c["window"] if local else 0
        ctx = torch.cat([checkpoint(_attend, qg[a:a + BLOCK_Q], kr, vr, a, window,
                                    use_reentrant=False)
                         for a in range(0, S, BLOCK_Q)]).reshape(S, H * Dh)
        gate = torch.sigmoid(self._mm(x, p["mix/g/w"].reshape(d, H * Dh)))
        return self._mm(ctx * gate, p["mix/o/w"].reshape(H * Dh, d))

    def _layer(self, h, i, row):
        p, eps = self.m.layers[i], self.cfg["norm_eps"]
        h = h + _norm(self._attention(_norm(h, p["norm1/scale"], eps), i),
                      p["post1/scale"], eps)
        y = _norm(h, p["norm2/scale"], eps)
        if i in self.m.moe_row:
            f = self._moe(y, i, row)
        else:
            f = self._swiglu(y, p["ffn/gate/w"], p["ffn/up/w"], p["ffn/down/w"])
        return h + _norm(f, p["post2/scale"], eps)

    def hidden(self, tokens, row):
        """The final-normed hidden states of one sequence."""
        c = self.cfg
        h = self.m.embed[tokens.long()] * math.sqrt(c["d_model"])
        for i in range(len(self.m.layers)):
            h = checkpoint(self._layer, h, i, row, use_reentrant=False)
        return _norm(h, self.m.final, c["norm_eps"])

    def logits(self, h):
        return self._mm(h, self.m.unembed.T)

    def _nll(self, h, labels):
        z = self.logits(h)
        return (torch.logsumexp(z, -1) - z.gather(-1, labels[:, None])[:, 0]).sum()

    def loss_backward(self, tokens, labels):
        """The mean token loss of the (B, S) batch; its grads accumulate in
        the params' ``.grad``."""
        B, S = tokens.shape
        total = 0.0
        for row in range(B):
            h = self.hidden(tokens[row], row)
            lab = labels[row].long()
            nll = sum(checkpoint(self._nll, h[a:a + LOSS_CHUNK], lab[a:a + LOSS_CHUNK],
                                 use_reentrant=False)
                      for a in range(0, S, LOSS_CHUNK))
            loss = nll / (B * S)
            loss.backward()
            total += float(loss.detach())
        return total


def stacked(path, ts):
    """The program's leaf at ``path`` from its per-layer tensors, on the
    host: the units' leaves stacked (a unit of one too)."""
    ts = [t.detach().cpu() for t in ts]
    return torch.stack(ts) if path[0] == "units" else ts[0]


def update_bias(bias, loads, rate):
    """The aux-loss-free step: delta = rate x sign(mean(n) - n), bias +=
    delta - mean(delta), each MoE layer's row on its own."""
    n = loads.to(torch.float32)
    delta = rate * torch.sign(n.mean(-1, keepdim=True) - n)
    return bias + (delta - delta.mean(-1, keepdim=True)).to(bias.device)


def train(model: Model, batches, opt: dict, operands=None, choices=None, margin=0.0):
    """``len(batches)`` AdamW steps, each followed by the bias update.
    ``choices[step]``: the program's choices of that step (see ``Step``).
    Returns a dict: ``losses``, ``first`` (the clipped grads' norm a
    program leaf after the first step), ``first_small`` (the whole clipped
    first gradient of each leaf of at most ``SMALL`` elements, on the
    host), ``bias`` (after the last step, on the host), ``route_off`` and
    ``route_lag`` over the steps."""
    c = model.cfg
    params = [t for _, ts in model.leaves() for t in ts]
    m = [torch.zeros_like(t) for t in params]
    v = [torch.zeros_like(t) for t in params]
    bias = torch.zeros((len(model.moe_row), c["moe"]["num_experts"]), dtype=torch.float32)
    out = {"losses": [], "route_off": 0, "route_lag": 0.0}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    for k, (tokens, labels) in enumerate(batches):
        for t in params:
            t.grad = None
        step = Step(model, operands, bias, None if choices is None else choices[k], margin)
        out["losses"].append(step.loss_backward(tokens, labels))
        out["route_off"] += step.route_off
        out["route_lag"] = max(out["route_lag"], step.route_lag)
        bias = update_bias(bias, step.loads, c["moe"]["bias_rate"])
        with torch.no_grad():
            norm = torch.sqrt(sum(t.grad.square().sum() for t in params))
            scale = torch.clamp_max(opt["clip"] / torch.clamp_min(norm, 1e-9), 1.0)
            for t in params:
                t.grad.mul_(scale)
            if k == 0:
                out["first"] = {path: math.sqrt(sum(float(t.grad.double().square().sum())
                                                    for t in ts))
                                for path, ts in model.leaves()}
                out["first_small"] = {path: stacked(path, [t.grad for t in ts])
                                      for path, ts in model.leaves()
                                      if sum(t.numel() for t in ts) <= SMALL}
            lr = lr_at(opt["schedule"], k)
            bc1, bc2 = 1.0 - b1 ** (k + 1), 1.0 - b2 ** (k + 1)
            for t, mt, vt in zip(params, m, v):
                g = t.grad
                mt.mul_(b1).add_((1 - b1) * g)
                vt.mul_(b2).add_((1 - b2) * g.square())
                upd = (mt / bc1) / ((vt / bc2).sqrt() + eps) + wd * t
                t.sub_(lr * upd)
                t.grad = None
    out["bias"] = bias.cpu()
    return out
