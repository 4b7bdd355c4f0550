"""A ChatGLM-style decoder's training steps in plain PyTorch, fp32, TF32
off (the configuration's model as the program runs it): token embedding;
per layer an RMSNorm, GQA attention with biased q / k / v / o projections,
GLM's partial rotary embedding (the first half of each head's dims,
rotate-half form) and a causal softmax, a residual, an RMSNorm, a SwiGLU
MLP with biases, a residual; a final RMSNorm, a separate unembedding and
the mean token cross entropy. Then global-norm clipping and AdamW (the
optax formulas, warmup-cosine learning rate), as the configuration states.

Memory: one sequence at a time (the grads accumulate), each layer and
each block of query rows recomputed in the backward, the logits a chunk
at a time; params, grads and both moments are kept per layer, so the
stacked leaves are never sliced under autograd. ``operands="fp8"`` rounds
every product's operands to float8 e4m3 with a per-tensor scale (the
control one precision below the bf16 products the program runs).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

BLOCK_Q = 1024
LOSS_CHUNK = 1024


def round_fp8(x):
    """x rounded to float8 e4m3 at a per-tensor scale, held in fp32; the
    gradient passes through unchanged."""
    xd = x.detach()
    amax = xd.abs().amax().clamp_min(1e-30)
    y = (xd * (448.0 / amax)).to(torch.float8_e4m3fn).to(torch.float32) * (amax / 448.0)
    return x + (y - xd).detach()


_OPERANDS = {None: lambda x: x, "fp8": round_fp8}


class Model:
    """The reference's params: per layer, fp32 leaves that require grad."""

    def __init__(self, cfg: dict, draw):
        """``draw(path)`` gives the fp32 value of the program's leaf at
        ``path`` (a stacked leaf has the layers on its first dim)."""
        self.cfg = cfg
        L = cfg["num_layers"]
        self.layers = [dict() for _ in range(L)]
        self.paths = {}
        for path in cfg["leaf_paths"]:
            full = draw(path)
            if path[0] == "units":
                key = "/".join(path[2:])
                for i in range(L):
                    self.layers[i][key] = full[i].clone().requires_grad_(True)
                del full
            else:
                setattr(self, "_".join(path), full.requires_grad_(True))
            self.paths[path] = None
        self.embed = getattr(self, "embed_table")
        self.unembed = getattr(self, "unembed_table")
        self.final = getattr(self, "final_norm_scale")

    def leaves(self):
        for path in self.paths:
            if path[0] == "units":
                key = "/".join(path[2:])
                yield path, [lay[key] for lay in self.layers]
            else:
                yield path, [getattr(self, "_".join(path))]


def _norm(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, rotary, theta):
    """x (S, H, Dh): rotate-half on the first ``rotary`` dims."""
    S = x.shape[0]
    freqs = 1.0 / theta ** (torch.arange(0, rotary, 2, dtype=torch.float32,
                                         device=x.device) / rotary)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    half = rotary // 2
    x1, x2, rest = x[..., :half], x[..., half:rotary], x[..., rotary:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


def _attend(q, k, v, q0):
    """Causal softmax attention of query rows [q0, q0 + bq): q (bq, KH, G,
    Dh); k, v (S, KH, Dh)."""
    bq, Dh = q.shape[0], q.shape[-1]
    keys = q0 + bq
    s = torch.einsum("qhgd,khd->hgqk", q, k[:keys]) * Dh ** -0.5
    qpos = torch.arange(q0, q0 + bq, device=q.device)[:, None]
    kpos = torch.arange(keys, device=q.device)[None, :]
    s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(s, -1)
    return torch.einsum("hgqk,khd->qhgd", p, v[:keys])


class Step:
    def __init__(self, model: Model, operands=None):
        self.m, self.cfg = model, model.cfg
        self.rnd = _OPERANDS[operands]

    def _mm(self, x, w, b=None):
        y = self.rnd(x) @ self.rnd(w)
        return y if b is None else y + b

    def _layer(self, h, i):
        c, p = self.cfg, self.m.layers[i]
        H, KH, Dh, d = c["num_heads"], c["num_kv_heads"], c["head_dim"], c["d_model"]
        S = h.shape[0]
        x = _norm(h, p["norm1/scale"])
        q = self._mm(x, p["mix/q/w"].reshape(d, H * Dh), p["mix/q/b"].reshape(-1))
        k = self._mm(x, p["mix/k/w"].reshape(d, KH * Dh), p["mix/k/b"].reshape(-1))
        v = self._mm(x, p["mix/v/w"].reshape(d, KH * Dh), p["mix/v/b"].reshape(-1))
        rot = Dh // 2 if c["rope"] == "partial" else Dh
        q = _rope(q.reshape(S, H, Dh), rot, c["rope_theta"])
        k = _rope(k.reshape(S, KH, Dh), rot, c["rope_theta"])
        v = v.reshape(S, KH, Dh)
        qg = self.rnd(q).reshape(S, KH, H // KH, Dh)
        kr, vr = self.rnd(k), self.rnd(v)
        ctx = torch.cat([checkpoint(_attend, qg[a:a + BLOCK_Q], kr, vr, a,
                                    use_reentrant=False)
                         for a in range(0, S, BLOCK_Q)])
        h = h + self._mm(ctx.reshape(S, H * Dh), p["mix/o/w"].reshape(H * Dh, d),
                         p["mix/o/b"])
        x = _norm(h, p["norm2/scale"])
        g = self._mm(x, p["ffn/gate/w"], p["ffn/gate/b"])
        u = self._mm(x, p["ffn/up/w"], p["ffn/up/b"])
        return h + self._mm(torch.nn.functional.silu(g) * u, p["ffn/down/w"],
                            p["ffn/down/b"])

    def _nll(self, h, labels):
        z = self._mm(h, self.m.unembed.T)
        return (torch.logsumexp(z, -1) - z.gather(-1, labels[:, None])[:, 0]).sum()

    def loss_backward(self, tokens, labels):
        """The mean token loss of the (B, S) batch; its grads accumulate in
        the params' ``.grad``."""
        B, S = tokens.shape
        total = 0.0
        for row in range(B):
            h = self.m.embed[tokens[row].long()]
            for i in range(len(self.m.layers)):
                h = checkpoint(self._layer, h, i, use_reentrant=False)
            h = _norm(h, self.m.final)
            lab = labels[row].long()
            nll = sum(checkpoint(self._nll, h[a:a + LOSS_CHUNK], lab[a:a + LOSS_CHUNK],
                                 use_reentrant=False)
                      for a in range(0, S, LOSS_CHUNK))
            loss = nll / (B * S)
            loss.backward()
            total += float(loss.detach())
        return total


def lr_at(sched: dict, step: int) -> float:
    """Warmup-cosine learning rate at ``step`` (0 first), in fp32."""
    s = torch.tensor(float(step))
    peak, warm, total = sched["peak"], sched["warmup"], sched["total"]
    if step < warm:
        return float(peak * torch.clamp_max((s + 1.0) / torch.tensor(float(max(1, warm))), 1.0))
    frac = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    return peak * (sched["final_frac"] + (1 - sched["final_frac"]) * 0.5
                   * (1 + math.cos(math.pi * frac)))


SMALL = 1 << 20      # leaves kept whole for the element rule (biases, norms)


def stacked(ts):
    """A program leaf's value from its per-layer tensors, on the host."""
    return torch.stack([t.detach().cpu() for t in ts]) if len(ts) > 1 else ts[0].detach().cpu()


def train(model: Model, batches, opt: dict, operands=None):
    """``len(batches)`` AdamW steps. Returns (losses, the clipped grads'
    norm a program leaf after the first step, and the whole clipped first
    gradient of each leaf of at most ``SMALL`` elements, on the host)."""
    step = Step(model, operands)
    params = [t for _, ts in model.leaves() for t in ts]
    m = [torch.zeros_like(t) for t in params]
    v = [torch.zeros_like(t) for t in params]
    losses, first = [], None
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    for k, (tokens, labels) in enumerate(batches):
        for t in params:
            t.grad = None
        losses.append(step.loss_backward(tokens, labels))
        with torch.no_grad():
            norm = torch.sqrt(sum(t.grad.square().sum() for t in params))
            scale = torch.clamp_max(opt["clip"] / torch.clamp_min(norm, 1e-9), 1.0)
            for t in params:
                t.grad.mul_(scale)
            if k == 0:
                first = {path: math.sqrt(sum(float(t.grad.double().square().sum()) for t in ts))
                         for path, ts in model.leaves()}
                first_small = {path: stacked([t.grad for t in ts])
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
    return losses, first, first_small
