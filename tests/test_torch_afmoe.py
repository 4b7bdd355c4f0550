"""Trinity-Mini's AFMoE block in the port against the plain reference
(``perfbench/reference/afmoe.py``: fp32, TF32 off, nothing of the program)
at a small size on the CPU: d 64, 4 heads over 2 KV groups, head 16, 16
experts top-4 plus a shared one, window 8 (3:1 window / global), one
leading dense layer, on seeded random weights.

Checked: the logits in fp32; the loss, every leaf's gradient and one bias
update of the bf16 training step; the expert-parallel share (two ranks'
routed parts plus the shared expert once equal the uncut layer); dropless
routing under a router that sends every token to one expert; the grouped
product against its per-group loop, and the dropless layer through
``torch._grouped_mm``'s undefined rows (on the CPU they hold garbage, as
on the card)."""
import dataclasses
import math
import sys
from pathlib import Path

import torch
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.gen import glm_weights  # noqa: E402
from perfbench.entries.moe_local_steps import reference_config as ref_cfg  # noqa: E402
from perfbench.reference import afmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

SEED = 2 ** 33 + 17
B, S = 2, 32


def small_cfg(held=None, layers=7):
    cfg = get_config("trinity-mini")
    moe = dataclasses.replace(cfg.moe, num_experts=16, top_k=4, d_ff_expert=32,
                              first_dense=1, held=held)
    return cfg.scaled(num_layers=layers, d_model=64, num_heads=4, num_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=256, window=8, moe=moe)


def setup(cfg, seed=SEED):
    meta = transformer.init(None, cfg, "meta")
    shapes = {p: tuple(t.shape) for p, t in glm_weights.leaf_paths(meta)}
    params = glm_weights.draw_params(meta, seed, "cpu")
    model = afmoe.Model(ref_cfg(cfg, list(shapes)),
                        lambda p: glm_weights.draw_leaf(p, shapes[p], seed, "cpu"))
    g = torch.Generator().manual_seed(seed % 2 ** 31)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    return params, model, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Taps:
    """The program's routing choices, layer by layer, the first forward's:
    ``moe.sigmoid_route`` wrapped while the block runs."""

    def __init__(self, layers):
        self.layers, self.got = layers, []

    def __enter__(self):
        self.route = moe_lib.sigmoid_route

        def tapped(*args, **kwargs):
            w, choices = self.route(*args, **kwargs)
            if len(self.got) < self.layers:
                self.got.append(choices.clone())
            return w, choices
        moe_lib.sigmoid_route = tapped
        return self

    def __exit__(self, *exc):
        moe_lib.sigmoid_route = self.route


def _bias(cfg, seed=5):
    g = torch.Generator().manual_seed(seed)
    return 1e-2 * torch.randn((transformer.moe_layers(cfg), cfg.moe.num_experts),
                              generator=g)


def test_logits_match_the_reference_in_fp32():
    """fp32 forward against the fp32 reference, routed by the same bias:
    only summation order differs (the reference's own choices match the
    program's; no decision within 1e-5 of the k-th score)."""
    cfg = small_cfg()
    params, model, batch = setup(cfg)
    bias = _bias(cfg)
    with torch.no_grad(), Taps(transformer.moe_layers(cfg)) as taps:
        h, pos = transformer._embed_inputs(params, cfg, batch, dtype=torch.float32)
        h, _, loads = transformer._stack_forward(params, cfg, h, pos, None,
                                                 expert_bias=bias)
        h = L.norm_apply(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        got = L.unembed_apply(params["unembed"], h)
    step = afmoe.Step(model, bias=bias, margin=1e-5)
    with torch.no_grad():
        ref = torch.stack([step.logits(step.hidden(batch["tokens"][r], r))
                           for r in range(B)])
    assert step.route_off == 0
    assert torch.equal(loads[:, :-1].double(), step.loads)
    assert torch.equal(loads[:, -1], loads[:, :-1].sum(1))      # dropless
    rel = float((got - ref).norm() / ref.norm())
    assert rel < 2e-5, rel         # fp32 against fp32: summation order only


def test_loss_grads_and_bias_update_match_the_reference():
    """The bf16 training step (bf16 activations and expert operands, fp32
    router) against the fp32 reference routed by the program's choices:
    loss within 2e-3 relative, every leaf's gradient within 8% (bf16
    activations through 7 layers and the attention backward's bf16
    products: 2.6-5.4% over the leaves here, 1.0% at most with the
    activations in fp32, where the loss agrees to 1e-7); no choice more
    than 0.02 under the reference's k-th score (bf16 drift of the router's
    input); the bias update exact (the same loads)."""
    cfg = small_cfg()
    params, model, batch = setup(cfg)
    opt = step_lib.make_optimizer(cfg)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32),
             "expert_bias": _bias(cfg)}
    bias0 = state["expert_bias"].clone()
    with Taps(transformer.moe_layers(cfg)) as taps:
        loss, metrics, grads = step_lib.loss_and_grads(params, cfg, batch, bias0)
    step = afmoe.Step(model, bias=bias0, choices=taps.got, margin=0.02)
    ref_loss = step.loss_backward(batch["tokens"], batch["labels"])
    assert step.route_off == 0, step.route_lag
    assert abs(float(loss) - ref_loss) / ref_loss < 2e-3
    got = dict(glm_weights.leaf_paths(grads))
    for path, ts in model.leaves():
        ref = afmoe.stacked(path, [t.grad for t in ts])
        rel = float((got[path] - ref).norm() / ref.norm().clamp_min(1e-12))
        assert rel < 0.08, (path, rel)
    want = afmoe.update_bias(bias0, step.loads, cfg.moe.bias_rate)
    moe_lib.update_expert_bias(state["expert_bias"], metrics["expert_load"],
                               cfg.moe.bias_rate)
    assert torch.equal(state["expert_bias"], want)
    assert not torch.equal(want, bias0)


def _layer_inputs(cfg, seed=3):
    meta = moe_lib.moe_init(None, cfg, "meta")
    p = glm_weights.draw_params({"ffn": meta}, seed, "cpu")["ffn"]
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(seed))
    return p, x


def _ref_moe(cfg, p, x, bias):
    """The reference's layer on (B, S, d) rows, its experts all held."""
    leaves = {("router", "w"): p["router"]["w"], ("gate",): p["gate"],
              ("up",): p["up"], ("down",): p["down"]}
    for k in ("gate", "up", "down"):
        leaves[("shared", k, "w")] = p["shared"][k]["w"]
    rc = ref_cfg(cfg, [("units", "0", "ffn", *k) for k in leaves])
    rc.update(num_layers=1, first_dense=0, unit_len=1)
    model = afmoe.Model(rc, lambda path: leaves[path[3:]][None].clone())
    step = afmoe.Step(model, bias=bias[None])
    with torch.no_grad():
        return torch.stack([step._moe(x[r], 0, r) for r in range(x.shape[0])]), step


def test_expert_parallel_shares_sum_to_the_uncut_layer():
    """Two ranks holding experts 0-7 and 8-15 (the stacks split between
    them): their outputs minus the shared expert counted twice equal the
    reference's layer with all 16 held, in fp32; the loads agree."""
    cfg = small_cfg()
    p, x = _layer_inputs(cfg)
    bias = _bias(cfg)[0]
    ref, step = _ref_moe(cfg, p, x, bias)
    parts = []
    for lo, hi in ((0, 8), (8, 16)):
        rank = small_cfg(held=(lo, hi))
        pr = dict(p, **{k: p[k][lo:hi] for k in moe_lib.EXPERT_STACKS})
        y, load = moe_lib.moe_dropless(pr, rank, x, bias)
        assert int(load[-1]) == int(load[lo:hi].sum())          # none dropped
        parts.append(y)
    shared = L.mlp_apply(p["shared"], x)
    got = parts[0] + parts[1] - shared
    assert torch.equal(load[:-1].double(), step.loads[0])
    assert float((got - ref).norm() / ref.norm()) < 1e-5


def test_dropless_keeps_every_pair_under_a_skewed_router():
    """A router that sends every token to expert 3 (its bias lifted past
    any score): expert 3 gets all N pairs, far past any capacity the
    capacity path would give (1.25 N k / E); the layer still equals the
    reference."""
    cfg = small_cfg()
    p, x = _layer_inputs(cfg, seed=4)
    bias = torch.zeros(cfg.moe.num_experts)
    bias[3] = 2.0
    y, load = moe_lib.moe_dropless(p, cfg, x, bias)
    N, k = B * S, cfg.moe.top_k
    assert int(load[3]) == N and int(load[:-1].sum()) == N * k == int(load[-1])
    assert N > math.ceil(1.25 * N * k / cfg.moe.num_experts)
    ref, _ = _ref_moe(cfg, p, x, bias)
    assert float((y - ref).norm() / ref.norm()) < 1e-5


def test_grouped_product_matches_its_loop():
    """``torch._grouped_mm`` (the card's route) against ``grouped_mm``'s
    per-group loop (the CPU's), uneven and empty groups, in bf16: the
    defined rows and the weight gradient equal; the loop's rows past the
    end are zero."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((40, 32), generator=g).to(torch.bfloat16)
    w = torch.randn((5, 32, 16), generator=g).to(torch.bfloat16)
    offs = torch.tensor([3, 3, 17, 30, 33], dtype=torch.int32)
    dy = torch.randn((40, 16), generator=g).to(torch.bfloat16)
    out = {}
    for name, fn in (("lib", lambda a, b: torch._grouped_mm(a, b, offs=offs)),
                     ("loop", lambda a, b: moe_lib.grouped_mm(a, b, offs))):
        a, b = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(a, b)
        y[:33].backward(dy[:33])
        out[name] = (y[:33].detach().float(), a.grad[:33].float(), b.grad.float(),
                     y[33:].detach())
    for u, v in zip(out["lib"][:3], out["loop"][:3]):
        assert float((u - v).abs().max()) <= 2e-2 * float(v.abs().max())
    assert torch.equal(out["loop"][3], torch.zeros_like(out["loop"][3]))


def test_dropless_layer_survives_the_libraries_undefined_rows(monkeypatch):
    """The layer through ``torch._grouped_mm`` (whose rows past the last
    offset, and their input gradient, hold garbage) against the same layer
    through the loop: output and every gradient equal to bf16 rounding and
    finite, so the undefined rows reach neither the combine nor the
    tokens."""
    cfg = small_cfg(held=(4, 12))
    p, x = _layer_inputs(small_cfg(), seed=6)
    p = dict(p, **{k: p[k][4:12].to(torch.bfloat16) for k in moe_lib.EXPERT_STACKS})
    x = x.to(torch.bfloat16)
    res = {}
    for name in ("loop", "lib"):
        if name == "lib":
            monkeypatch.setattr(moe_lib, "grouped_mm",
                                lambda a, b, offs, rows=None: torch._grouped_mm(a, b, offs=offs))
        leaves = {k: p[k].clone().requires_grad_() for k in ("gate", "up", "down")}
        rw = p["router"]["w"].clone().requires_grad_()
        xx = x.clone().requires_grad_()
        pp = dict(p, router={"w": rw}, **leaves)
        y, _ = moe_lib.moe_dropless(pp, cfg, xx)
        y.float().square().sum().backward()
        res[name] = [y.detach(), xx.grad, rw.grad] + [leaves[k].grad
                                                      for k in ("gate", "up", "down")]
    for u, v in zip(res["lib"], res["loop"]):
        assert torch.isfinite(u.float()).all()
        assert float((u.float() - v.float()).norm()) <= 2e-2 * float(v.float().norm())


def test_cell_report_and_launcher_run_trinity():
    """The normal entry points at the smoke size: the dry-run cell report
    traces a train step on the meta device, the grouped products reporting
    their FLOPs (forward and both backward products); ``launch.train``
    takes two steps on the CPU with the expert bias moving."""
    from repro_torch.configs import SHAPES, smoke_config
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.launch import train as train_lib
    cfg = smoke_config("trinity-mini")
    rec, counts = dryrun.cell_record(cfg, SHAPES["train_4k"],
                                     mesh_lib.AbstractMesh(("data", "model"), (1, 1)))
    assert rec["status"] == "ok" and counts["flops"] > 0
    calls = counts["kernel_calls"]["grouped_mm"]
    # 3 products a layer, each in the forward, the recompute and twice back
    assert calls == 3 * 4 * transformer.moe_layers(cfg)
    state, history = train_lib.run_plain(
        train_lib.parse_args(["--arch", "trinity-mini", "--smoke", "--steps", "2",
                              "--batch", "2", "--seq", "32", "--device", "cpu"]),
        cfg, torch.device("cpu"))
    assert len(history) == 2 and all(math.isfinite(h["loss"]) for h in history)
    assert float(state["expert_bias"].abs().max()) > 0
