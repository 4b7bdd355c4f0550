"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and never
prints its last line):

1. the device, its ``nvidia-smi`` name and power limit, TF32 off for
   convolutions and matrix products;
2. build every CUDA kernel of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together) and print the build time;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it: quantize/dequantize bitwise through the row
   API on every LeNet leaf's last-axis blocking, on flat 256-column rows,
   on a ragged row count, on bf16 and with bf16 output, and through the
   tree API (one launch a direction for a whole tree, against the plain
   version that walks the same segment table) on the LeNet params, an odd
   tree (0-d and zero-size leaves), ragged last axes, bf16 and mixed
   trees, 70 leaves (two launches) and leaves 4 bytes off alignment; the
   tree kernels timed on the LeNet tree beside the same tree through the
   row API one leaf at a time, one broadcast's round trip in turns with
   the parent's per-leaf sequence (device time, CUDA-event time, device
   kernels a call), and both kernels at one llama3-8b decoder layer's
   weights (2.18e8 fp32 elements, bandwidth-bound); wfedavg within rtol/atol 1e-6 at N = 10 and
   D = 94 080 / 10 080 and on ragged and misaligned D; flash attention on
   llama3's and gemma3's local heads at S = 4096, a bidirectional, two
   ragged (S 1000 and 4095), a KH = 1, a KH = H and a hubert (Dh 80,
   bidirectional, S 1000) case, each kernel
   reached through the routing rule and its route read from the launch
   counters: the sm90 kernel (bf16 wgmma + TMA) in bf16 (rtol/atol 1.6e-2,
   one bf16 ulp), the simt kernel in fp32 (1e-5) and in bf16 on views
   8 bytes past an aligned base. Time each one (device time per call from
   the profiler, else CUDA events) beside its bound, its plain version
   and, where one PyTorch call computes the same function, that call: both
   flash kernels in bf16 at the serving path's shape and at gemma3's local
   heads, before the model is on the card, and the simt kernel at phase
   8's fp32 shape, its path's;
4. the LeNet main path: the paper's §VI federation (``lenet_paper_setup``:
   10 nodes, 20% gaussian random-model poisoners, Dirichlet(1) shards,
   kregular(10, 2), ttl 2, 108 ticks) with int8 wire payloads and the
   wfedavg kernel (``use_kernel=True``) on the heap simulator; launch
   counts are zeroed just before it and read just after, every kernel
   must have launched, and quantize and dequantize once a broadcast
   (``tx_sent``);
5. a small federation run on the card (kernels) and on the CPU (plain
   versions) from the same params must agree; two seeded heap runs of the
   main path's recipe (training on, shortened to 36 ticks) must be bitwise
   equal (every param leaf, the reputations, the accuracy histories); one
   ``roundtrip_tree`` of the LeNet params must run exactly two device
   kernels; then a 36-tick window of the main path is profiled (device
   busy/idle share, host split by function);
6. the serving path: ``python -m repro_torch.serve`` with llama3-8b at full
   width and depth (8.03 B random params, drawn in fp32 and stored in bf16
   leaf by leaf), B 4
   prompts x P 4096 tokens, then 32 greedy decode steps; counts zeroed just
   before and read just after, and the sm90 flash kernel must have
   launched 32 times (one per layer), the logits be finite and every
   tensor stay on the card;
7. prefill-then-decode consistency at that size (decode at P - 1 after a
   prefill of P - 1 tokens against the full prefill's logits), then one
   prefill and 8 decode steps under the profiler;
8. ``smoke_config("llama3-8b")`` from the same params on the card (the
   simt flash kernel, Dh 16) and on the CPU (its plain version) must
   agree, in fp32 and bf16; counts zeroed just before each card run and
   read just after, and the simt kernel must have launched once per layer
   (the fp32 run's count is its row's launches);
9. the vectorized engine (``simlax.LaxSimulator``): a small toy and a
   small LeNet federation through the dense, sparse and compact engines on
   the card must agree (integers and reputations exactly, floats within
   rtol 1e-6); the compact engine on the card against the CPU from the
   same params (toy and LeNet); two seeded card runs bitwise equal;
10. the paper's §VI-D federation on the compact engine
   (``lenet_paper_setup(10, compress="int8")``): honest accuracy >= 0.90
   and poisoners' reputation below the honest nodes' by 0.1 (the JAX
   acceptance test's thresholds); counts zeroed just before and read just
   after, quantize and dequantize once a training tick (106);
11. ``lenet_paper_setup(1024, compress="int8")`` at full LeNet width,
   counted the same way: set-up seconds, ticks/s, peak device memory,
   accuracy and reputations (printed), a profiled 24-tick window (device
   busy / idle share, top device ops, host split by function); then both
   wire kernels on its stacked (1024, ...) tree beside their bound and the
   plain version;
12. batched runs (``BatchedFederationSpec``): (a) eight heterogeneous toy
   federations (n 16, 48 ticks, per-member seeds) batched on the card with
   each of the compact, sparse and dense engines, every member bitwise its
   single card run, and the compact batch against the same batch on the
   CPU (fixed intervals, deterministic attacks); (b) the §VI-D sweep at
   full LeNet width: ``lenet_paper_setup(10, compress="int8")``'s scenario,
   topology and config under six role sheets (the recipe's poisoners under
   each of the five attacks, and all honest) x seeds 0-3, 24 federations
   in one run, counted: the (gaussian, seed 0) member bitwise phase 10's
   run and held to its thresholds, three more members bitwise their single
   runs, quantize and dequantize once a training tick for the whole batch;
   wall, federations/s against the single runs', a profiled 24-tick
   window, peak memory, every member's accuracy and reputations; before
   it, the stacked SGD's CUDA-graph route against its eager route (bits
   and time a call at 1, 2 and 8 models); both wire kernels at the batch's
   stacked tree; (c) one ``sweeps.run_sweep`` of a small toy grid on the
   card and its frontier tables;
13. the sharded engine and the production gossip round over
   ``torch.distributed``: (a) ``delivery="sharded"`` in process (one
   shard) on the card, the toy cases of tests/test_sharded.py:163 (the
   wire off and int8, churn) bitwise the compact engine and
   ``lenet_paper_setup(10, "int8")`` bitwise phase 10's run, counted
   (quantize and dequantize once a training tick), timed; (b) 2 and 4
   ranks on cuda:0 under gloo (``launch.mesh.spawn``; the exchanges staged
   through host memory), the toy cases bitwise the compact engine,
   tests/test_torch_sharded.py's LeNet case (n 8, 24 ticks) at S = 2 and
   eight seeds held to the compact engine's events, reputations and test
   accuracies exactly and its params within 1.6e-2, and
   the recipe at S = 2 held to phase 10's events, schedule and broadcasts
   exactly, its params within a relative L2 distance of 0.25 a leaf and to
   the acceptance thresholds (honest accuracy >= 0.90, poisoners'
   reputation below the honest nodes'), with its wall, the exchange's share
   of it, the bytes sent a tick and the wire kernels' launches over the
   ranks; (c) ``core.gossip``'s round at F = 4 on the 4 ranks: LeNet-5 at
   full width, each node's own params and eval set, ring ttl 2, fp32 and
   int8, held to an oracle computed in one process on the card (params
   within rtol 1e-5, reputation rows exactly), the bytes each rank sends
   (the schedule's steps x ``compression.payload_bytes``), ms a round, and
   quantize once a rank and dequantize once a received model a round;
14. LM training and the federated LM launcher, llama3-8b at full width
   (d_model 4096, 32 heads, KV 8, d_ff 14336, vocab 128 256), random
   weights from a seed: (b) both flash kernels' log-sum-exp and output
   against attention_ref's (the sm90 kernel at B 2 x S 4096 x H 32, causal
   and with a 512 window; the simt kernel in fp32 at Dh 16 and in bf16 on
   misaligned views) and the model's backward against autograd through
   attention_ref; the forward timed with and without the lse beside
   cuDNN's and the plain version; the sm90 backward kernel at the training
   shape and at chatglm3-6b's heads (KV 2) against the plain recompute
   backward on the same lse (relative L2 1e-2 a gradient), timed beside
   its bound, the plain backward and cuDNN's backward alone; both wire
   kernels at the depth-1 llama3-8b tree (1.27 B elements) and at the
   sharded engine's (5, ...) LeNet trainers' tree; (a) one step at depth 1,
   B 1 x S 1024 through the kernels against the same step with the
   attention forced through the plain version (loss within 2e-2, each grad
   leaf within 2e-2 relative L2), then the launcher's ``run_plain`` at
   depth 4 (of 32), B 2 x S 4096, 6 AdamW steps with remat full, counted:
   losses, grad norms, wall a step, peak memory, 8 sm90 flash launches a
   step (4 layers x forward and remat recompute) and 4 sm90 backward
   launches (one a layer, none on the plain route), params changed, and one
   more step profiled (device idle share, where the time goes); (c) the
   launcher's ``run_dfl``: F = 2 ranks on cuda:0 under gloo, depth 1,
   B 1 x S 1024, 2 local steps, 2 rounds, ring ttl 1, int8 wire, counted
   in each rank (quantize once a round, dequantize once a valid receipt,
   the wire bytes, per-rank peak memory, ms a round); (d) the launcher's
   ``main`` with ``--dfl --fed 4 --fail-node 1@2 --rounds 4`` at
   ``smoke_config("llama3-8b")`` on cuda:0: F=4, then F=3 over the
   survivors;
15. the rest of the LM zoo: (d) both flash kernels at hubert-xlarge's
   encoder (B 2 x S 4096, H 16 = KH, Dh 80, bidirectional; the sm90 kernel
   on the tensors as made, the simt kernel on ``_simt_view`` copies) and
   the sm90 kernel at recurrentgemma-2b's local layers (B 2 x S 4096, H 10,
   KH 1, Dh 256, window 2048), timed as phase 3 times the others; hubert's
   encoder at full width, depth 2, B 2 x S 4096 through the kernels against
   the same forward under ``models.flash.plain_route()`` (within 5e-2 of
   the output's scale, 2 sm90 launches, no simt); (a) each of
   recurrentgemma-2b, chatglm3-6b, command-r-35b, dbrx-132b,
   llama4-maverick, xlstm-125m, hubert-xlarge and llava-next at
   ``smoke_config`` from the same params on the card (the simt kernel at Dh
   16, one launch a prefill attention layer) and on the CPU (plain), a
   ragged prompt and 4 decode steps in lockstep, fp32 within 1e-4 and bf16
   within 5e-2 of the logits' scale (xLSTM 2e-2 a layer; MoE steps where
   the two runs route a token to other experts at a near tie exempt, fp32
   routing identical); (b) each at full width through ``serve.serve``
   with bf16 weights drawn one unit slice at a time, cast as drawn
   (command-r-35b at its published 40 layers; the depth cut only where
   one card forces it: dbrx 10 of 40, llama4 3 of 48, the deepest whose
   whole 15b run the op-cost walker puts within ZOO_CEILING), B 2 x P
   2048 + 8 decode steps (recurrentgemma P 4096, past its 2048 window;
   llama4 B 1; hubert B 2 x S 4096 frames, the encoder forward only),
   counted (the flash launches of one prefill: one a prefill attention
   layer, sm90 at Dh 80 / 128 / 256, none for xLSTM): the walker's peaks
   traced first on the meta device (init alone, serve, the arch's whole
   run), then the card's: init's within 1% of the prediction;
   init, prefill and decode wall, peak memory, finite logits,
   prefill-then-decode consistency (bf16 within 0.08 of the scale; xLSTM
   in fp32, its two runs within 2.5e-3 of the scale of the CPU's on the
   same weights, tests/test_models.py's 0.06 a layer printed; MoE at a dropless
   capacity), a profiled prefill (idle share, flash time, device time
   under the MoE dispatch, RG-LRU scan and xLSTM blocks) and decode; the
   sLSTM layer's prefill alone, its CUDA-graph route bitwise and timed
   against the eager loop; (c) ``python -m
   repro_torch.launch.train`` with its default arch, xlstm-125m at full
   config, 3 steps at B 2 x S 1024;
16. the dry-run command line's federation runs and remat="dots": (a)
   ``launch.dryrun.main`` with ``--engine lax`` on the card (lenet,
   signflip, 16 nodes, 48 ticks, kregular ttl 2, int8 wire, compact),
   counted: its eight event and byte counters equal to the JAX command
   line's record for the same flags (constants below), honest accuracy and
   the poisoners' reputation within 0.05 of it, quantize and dequantize
   once a training tick; the same run with ``--device cpu``, the same
   counters; (b) ``--delivery sharded --mesh 2`` (2 gloo ranks on the
   card), the same counters; (c) the toy at 64 nodes and the default
   ``--sweep`` grid (12 federations), every outcome finite, federations/s;
   (d) ``remat="dots"`` against ``"full"`` at phase 14a's shape (llama3-8b
   full width, depth 4, B 2 x S 4096): the first step's loss and every
   grad leaf within 1e-6 relative, then 3 timed AdamW steps of each,
   counted (8 sm90 flash launches a step), peak memory, a profiled step's
   idle share; both wire kernels timed at the command line's stacked tree;
18. (after 16, before 17's lines) the dry-run cell report: (a) ``python -m
   repro_torch.launch.dryrun --all``, ``--all --multi-pod`` and
   ``--arch A --shape train_4k --dfl`` for each of the ten archs (ring ttl
   1) and llama3-8b's smallworld ttl 2 int8 round, three processes side by
   side on the host at nice 19 with no card visible, started after the
   build and waited for here (every cell traced on the meta device): every
   record ``ok`` or the ``skip`` that ``cell_status`` gives,
   no None under ``bytes_per_device``, ``dominant`` set, a train cell's
   useful ratio in (0, 1], both tables and ``python -m
   repro_torch.launch.report`` rendered, the single-pod roofline rows of
   llama3-8b, dbrx-132b and llama4-maverick printed; (b) the record of
   phase 14a's step (llama3-8b full width, depth 4, B 2 x S 4096 on a 1 x 1
   mesh) under remat full and dots against phase 16d's measured steps:
   argument bytes within 1% of the allocated state and batch, peak within
   25% of ``max_memory_allocated`` over the steps, the roofline bound
   max(compute, memory) at most 1.05 x the measured step, and the record's
   flash calls (8 a step, sm90) equal to the measured launches;
19. (after 18) Trinity-Mini, the port's mixture of experts: (a) the
   grouped product at the benchmark cell's shape (the held rows of 64
   experts' gate projection, B 4 x S 8192 x top 8 over 128 experts: 131,072
   rows x 2048 x 1024, bf16): ``models.moe.grouped_mm`` against its
   per-expert loop of ``torch.matmul`` (all rows equal to bf16 rounding,
   the rows past the last offset left out), timed with the loop, the
   library call and the FLOP bound; (b) ``perfbench``'s
   ``trinity-mini.local-steps`` cell run once at its own size (stage 1's 8
   layers, 64 of 128 experts, half the vocabulary, B 4 x S 8192, H 2):
   three steps through ``make_local_steps(make_train_step(cfg))`` held to
   the plain reference (``perfbench/reference/afmoe.py``, fp32) on the
   card, every check within its limit, no pair dropped, its tokens/s and
   peak memory;
20. (after 19) the train step's clip and AdamW kernels (``csrc/adamw.cu``)
   at chatglm3-6b's benchmark state (17 layers, 19 fp32 leaves, 4.0 B
   params: g, m, v and p, 64 GB): ``adamw_step`` bitwise its plain version
   (m, v, p; g left as it was) on the largest leaf, (17, 13696, 4096),
   with the clip engaged, and ``grad_sumsq``'s norm within 1e-6 of fp64
   over the whole state; each timed on the largest leaf and over the
   whole state (a launch a leaf) beside its bytes bound at 3.35 TB/s, its
   plain version (with its peak memory above the state) and a library
   call that computes the same (``torch._fused_adamw_``;
   ``torch._foreach_norm`` and a norm of the norms), which the port never
   calls;
17. one JSON line with every kernel's numbers, the ``nvidia-smi`` line, and
   the result line.

It exits non-zero without a result when CUDA is unavailable or when the
repository's ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
PROFILE_PAD_S = 0.02             # idle host time before a profiled body
ABSORB = 64                      # tiny kernels that open a profiled window


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------ phase 19
TRINITY_ROWS, TRINITY_D, TRINITY_FF, TRINITY_HELD = 131_072, 2048, 1024, 64


def time_grouped_product(torch):
    """Phase 19a: ``grouped_mm`` (``torch._grouped_mm``) at the cell's shape
    against its per-expert loop: the defined rows within bf16 rounding,
    then the device time of each and the FLOP bound."""
    from repro_torch.models import moe
    g = torch.Generator(device="cuda").manual_seed(19)
    rows, d, ff, E = TRINITY_ROWS, TRINITY_D, TRINITY_FF, TRINITY_HELD
    x = torch.randn(2 * rows, d, device="cuda", generator=g).to(torch.bfloat16)
    w = (torch.randn(E, d, ff, device="cuda", generator=g) * d ** -0.5).to(torch.bfloat16)
    # uneven groups (the router's load), summing to ``rows``; half the buffer
    # past the last offset, as the dropless layer sizes it
    share = torch.rand(E, device="cuda", generator=g) + 0.5
    counts = torch.floor(share / share.sum() * rows).to(torch.int64)
    counts[-1] += rows - counts.sum()
    offs = torch.cumsum(counts, 0).to(torch.int32)
    ends = offs.tolist()

    def loop():
        out, start = [], 0
        for e, end in enumerate(ends):
            out.append(x[start:end] @ w[e])
            start = end
        return out

    got = moe.grouped_mm(x, w, offs)[:rows].float()
    want = torch.cat(loop()).float()
    err = float((got - want).abs().max())
    if err > 2e-2 * float(want.abs().max()):
        fail(f"grouped_mm against its loop: max error {err}")
    del got, want
    ms, timing, names = device_ms(lambda: moe.grouped_mm(x, w, offs), 20)
    plain, _, _ = device_ms(loop, 5)
    bound, _ = bound_ms(0.0, 2.0 * rows * d * ff, BF16_OPS_PER_S)
    print(f"grouped_mm at {rows} held rows x {d} x {ff}, {E} experts: {ms:.5f} ms "
          f"({timing}; {', '.join(n[:60] for n in names)}), the per-expert loop "
          f"{plain:.5f} ms, bound {bound:.5f} ms ({100 * bound / ms:.1f}%), max error {err:.3g}")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "max_abs_err": err,
            "launches": "6 a MoE layer a step (3 forward, 3 recompute) + 6 backward",
            "shape": f"{rows} rows x {d} x {ff}, {E} groups, bf16",
            "timing": timing}


def run_trinity(torch):
    """Phase 19: 19a's row, then the benchmark cell once at its own size."""
    row = time_grouped_product(torch)
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    if root not in sys.path:
        sys.path.insert(0, root)
    from perfbench import harness
    torch.cuda.reset_peak_memory_stats()
    line, checks = harness.run_cell("trinity-mini.local-steps", 2 ** 33 + 19, 10.0, 0)
    bad = [(k, v, lim) for k, v, lim in checks if not v <= lim]
    if bad or not line["correct"]:
        fail(f"trinity-mini against the reference: {bad}")
    torch.cuda.empty_cache()
    return {"row": row, "checks": line["checks"], "metrics": line["metrics"]}


# ------------------------------------------------------------ phase 20
ADAMW_HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)   # adamw()'s
ADAMW_NORM_TOL = 1e-6        # grad_sumsq's norm against fp64, relative


def _glm_leaf_shapes():
    """chatglm3-6b's param shapes as its benchmark cell trains them."""
    root = os.path.dirname(os.path.abspath(__file__))
    if root not in sys.path:
        sys.path.insert(0, root)
    from perfbench.entries.lm_local_steps import arch_config
    from repro_torch import tree
    from repro_torch.models import transformer
    with open(os.path.join(root, "perfbench", "configs", "chatglm3-6b.json")) as f:
        cfg = arch_config(json.load(f))
    return [tuple(x.shape) for x in tree.leaves(transformer.init(None, cfg, "meta"))]


def _adamw_leaves(torch, shapes, seed):
    """(g, m, v, p) a shape on the card: step-3-like moments."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, std, positive=False):
        x = torch.empty(shape, device="cuda").normal_(0.0, std, generator=gen)
        return x.abs_() if positive else x
    return [(draw(s, 1e-3), draw(s, 1e-3), draw(s, 1e-6, True), draw(s, 0.02))
            for s in shapes]


def _adamw_scalars(torch, step=3):
    from repro_torch.optim import schedules
    s = torch.tensor(step, dtype=torch.int32, device="cuda")
    t = s.to(torch.float32) + 1.0
    return (schedules.warmup_cosine(3e-4, 2000, 100_000)(s),
            1.0 - ADAMW_HP["b1"] ** t, 1.0 - ADAMW_HP["b2"] ** t)


def _peak_above(torch, fn):
    """Device memory ``fn`` allocates above what is allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _time_adamw(torch, leaves, label, iters, plain_iters):
    """Rows 7 (``adamw_step``) and 7n (``grad_sumsq``) over ``leaves``."""
    from repro_torch.kernels.adamw import ops, ref
    from repro_torch.optim import optimizers as opt_lib
    gs = [x[0] for x in leaves]
    n = sum(g.numel() for g in gs)
    lr, bc1, bc2 = _adamw_scalars(torch)
    _, scale = ops.grad_norm(gs, 1.0)
    steps = [torch.full((), 4.0, device="cuda") for _ in leaves]

    def kernel():
        for leaf in leaves:
            ops.adamw_step(*leaf, scale, lr, bc1, bc2, **ADAMW_HP)

    def library():
        g_, m_, v_, p_ = (list(x) for x in zip(*leaves))
        torch._fused_adamw_(p_, g_, m_, v_, [], steps, lr=3e-4, beta1=ADAMW_HP["b1"],
                            beta2=ADAMW_HP["b2"], weight_decay=ADAMW_HP["weight_decay"],
                            eps=ADAMW_HP["eps"], amsgrad=False, maximize=False)

    def norm_library():
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))

    def plain():           # the step's plain path: g scaled in place and consumed
        for g, m, v, p in leaves:
            opt_lib.apply_updates(p, ref.adamw_update(g.mul_(scale), m, v, p, lr, bc1,
                                                      bc2, **ADAMW_HP))

    rows = {}
    k_ms, timing, names = device_ms(kernel, iters)
    lib_ms, _, _ = device_ms(library, iters)
    n_ms, n_timing, n_names = device_ms(lambda: ops.grad_norm(gs, 1.0), iters)
    n_lib, _, _ = device_ms(norm_library, iters)
    n_plain, _, _ = device_ms(lambda: ref.grad_norm(gs, 1.0), plain_iters)
    k_mem = _peak_above(torch, kernel)
    p_mem = _peak_above(torch, plain)
    p_ms, _, _ = device_ms(plain, plain_iters)
    shape = f"{label}: {len(leaves)} fp32 leaves, {n} elements"
    for name, ms, bound, pl, lib, t, nm, per in (
            ("adamw_step", k_ms, 28.0 * n, p_ms, lib_ms, timing, names, 28),
            ("grad_sumsq", n_ms, 4.0 * n, n_plain, n_lib, n_timing, n_names, 4)):
        b_ms, _ = bound_ms(bound, 0.0)
        rows[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": "bytes", "plain_ms": pl,
                      "library_ms": lib, "shape": shape, "timing": t,
                      "bytes_per_element": per, "share": b_ms / ms}
        print(f"{name} over {shape}: {ms:.5f} ms ({t}; {', '.join(x[:50] for x in nm)}), "
              f"bound {b_ms:.5f} ms at {per} B an element ({100 * b_ms / ms:.2f}%), "
              f"plain {pl:.5f} ms, library {lib:.5f} ms")
    rows["adamw_step"].update(kernel_peak_bytes=k_mem, plain_peak_bytes=p_mem)
    print(f"adamw over {label}: memory above the state, kernel {k_mem / 2**30:.4f} GiB, "
          f"plain {p_mem / 2**30:.4f} GiB")
    return rows


def _adamw_state_err(torch, leaves, scale, lr, bc1, bc2, chunk=1 << 27):
    """max |kernel - plain| over m, v and p after one step of ``leaves``,
    ``chunk`` elements of a leaf at a time (the state and its plain copy
    would not fit on the card together; the kernel is elementwise, so a
    chunk's launch computes what the leaf's does there); g left as it was."""
    from repro_torch.kernels.adamw import ops, ref
    err, kept = 0.0, True
    for leaf in leaves:
        flat = [x.view(-1) for x in leaf]
        for i in range(0, flat[0].numel(), chunk):
            part = [x[i:i + chunk] for x in flat]
            want = [x.clone() for x in part]
            ops.adamw_step(*part, scale, lr, bc1, bc2, **ADAMW_HP)
            ref.adamw_step(*want, scale, lr, bc1, bc2, **ADAMW_HP)
            kept &= bool(torch.equal(part[0], want[0]))
            err = max([err] + [float((a - b).abs().max()) for a, b in zip(part[1:], want[1:])])
            del want
    return err, kept


def run_adamw(torch):
    """Phase 20: the clip and AdamW kernels at chatglm3-6b's state."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.adamw import ops, ref
    t_phase = time.perf_counter()
    shapes = _glm_leaf_shapes()
    big = max(shapes, key=lambda s: int(torch.Size(s).numel()))
    # the largest leaf, bitwise, with the clip engaged
    (leaf,) = _adamw_leaves(torch, [big], 20)
    want = [x.clone() for x in leaf]
    g0 = leaf[0].clone()
    lr, bc1, bc2 = _adamw_scalars(torch)
    norm, scale = ops.grad_norm([leaf[0]], 1.0)
    leaf_norm_err = abs(float(norm) - float(ref.grad_norm([leaf[0]], 1.0)[0]))
    reset_launches()
    ops.adamw_step(*leaf, scale, lr, bc1, bc2, **ADAMW_HP)
    torch.cuda.synchronize()
    ref.adamw_step(*want, scale, lr, bc1, bc2, **ADAMW_HP)
    leaf_err = max(float((a - b).abs().max()) for a, b in zip(leaf[1:], want[1:]))
    bitwise = {k: bool(torch.equal(a, b)) for k, a, b in zip("mvp", leaf[1:], want[1:])}
    if not (all(bitwise.values()) and torch.equal(leaf[0], g0)
            and float(scale) < 1.0 and LAUNCHES["adamw_step"] == 1):
        fail(f"adamw_step at {big}: bitwise {bitwise}, g kept "
             f"{torch.equal(leaf[0], g0)}, scale {float(scale)}, launches {dict(LAUNCHES)}")
    del want, g0
    leaf_rows = _time_adamw(torch, [leaf], f"the largest leaf {big}", 20, 5)
    leaf_rows["adamw_step"]["max_abs_err"] = leaf_err
    leaf_rows["grad_sumsq"]["max_abs_err"] = leaf_norm_err
    del leaf
    torch.cuda.empty_cache()
    # the whole state
    leaves = _adamw_leaves(torch, shapes, 21)
    gs = [x[0] for x in leaves]
    reset_launches()
    norm, scale = ops.grad_norm(gs, 1.0)
    want = sum(float(torch.linalg.vector_norm(g, dtype=torch.float64)) ** 2
               for g in gs) ** 0.5
    gap = abs(float(norm) / want - 1)
    norm_err = abs(float(norm) - float(ref.grad_norm(gs, 1.0)[0]))
    again = ops.grad_norm(gs, 1.0)
    if gap > ADAMW_NORM_TOL or not torch.equal(again[0], norm) \
            or LAUNCHES["grad_sumsq"] != 2 * (len(gs) + 1):
        fail(f"grad_sumsq over the state: gap to fp64 {gap}, repeat "
             f"{torch.equal(again[0], norm)}, launches {dict(LAUNCHES)}")
    print(f"grad_sumsq over chatglm3's {len(gs)} leaves: norm {float(norm):.6f}, fp64 "
          f"{want:.6f}, relative gap {gap:.3e} (limit {ADAMW_NORM_TOL}); bitwise "
          f"on a second call; the plain norm's {norm_err:.3e} away")
    lr, bc1, bc2 = _adamw_scalars(torch)
    state_err, kept = _adamw_state_err(torch, leaves, scale, lr, bc1, bc2)
    if state_err or not kept:
        fail(f"adamw_step over the state: max |kernel - plain| {state_err} over m, v "
             f"and p (not bitwise), g kept {kept}")
    print(f"adamw_step over chatglm3's state: m, v and p bitwise the plain version "
          f"(max |kernel - plain| {state_err}), g kept")
    state_rows = _time_adamw(torch, leaves, f"chatglm3-6b's state ({len(shapes)} leaves)",
                             10, 3)
    state_rows["adamw_step"]["max_abs_err"] = state_err
    state_rows["grad_sumsq"].update(max_abs_err=norm_err, fp64_gap=gap)
    del leaves, gs
    torch.cuda.empty_cache()
    print(f"phase 20 took {time.perf_counter() - t_phase:.3f} s")
    return {"leaf": leaf_rows, "state": state_rows, "norm_gap": gap,
            "bitwise": bitwise, "leaves": len(shapes)}


# ----------------------------------------------------------------- timing
def event_ms(fn, iters: int) -> float:
    """Wall time per call on the card's clock: CUDA events around a run of
    back-to-back calls (includes each call's host-side launch cost)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


MEASURED = "chip_smoke.measured"


@contextlib.contextmanager
def profiled():
    """A ``torch.profiler`` window over the CPU and the card whose device
    events are read with ``measured_events``; the code to measure runs in
    the ``with`` body.

    On the H100, once CUDA timing events had been used in the process,
    every profiler session dropped the device records it collected first
    (from a few kernels up to a whole burst). So the window opens with a
    burst of ABSORB tiny kernels, a synchronize and PROFILE_PAD_S of idle
    time, and the body runs inside a ``record_function`` range: only device
    events that start after that range begins are counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad = torch.zeros(1, device="cuda")
        for _ in range(ABSORB):
            pad.add_(1)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        with record_function(MEASURED):
            yield prof


def measured_events(prof):
    """Device events (kernels, copies, memsets) of a ``profiled`` window's
    body. The program's ``dfl.*`` spans (``repro_torch.core.spans``) are
    ``record_function`` ranges, mirrored on the card's timeline as
    annotations over their kernels: not device work, so left out."""
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == MEASURED and e.device_type == cpu)
    return [e for e in events if e.device_type == cuda and e.name != MEASURED
            and not e.name.startswith("dfl.") and e.time_range.start >= start]


def _device_events(fn, calls: int, warmup: int = 10):
    """Device events of ``calls`` calls of ``fn``, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profiled() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return measured_events(prof)


def device_ms(fn, iters: int):
    """(ms, method, kernel names): device time per call, the sum of every
    kernel and copy the profiler saw on the card over ``iters`` calls; CUDA
    events when the profiler records no device time."""
    on_card = _device_events(fn, iters)
    total_us = sum(e.time_range.elapsed_us() for e in on_card)
    names = sorted({e.name for e in on_card})
    if total_us > 0:
        return total_us / 1e3 / iters, "profiler", names
    return event_ms(fn, iters), "events", names


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 3
def check_quantize(torch, lenet_params):
    """Bitwise kernel-vs-plain on every shape the main path gives the pair."""
    from repro_torch import tree
    from repro_torch.core import compression
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref

    g = torch.Generator().manual_seed(1)
    cases = {}
    for path, leaf in zip(("c1.b", "c1.w", "c2.b", "c2.w", "f1.b", "f1.w",
                           "f2.b", "f2.w", "out.b", "out.w"),
                          tree.leaves(lenet_params)):
        _, _, b, _ = compression._last_axis_blocking(tuple(leaf.shape))
        cases[f"lenet {path} C={b}"] = leaf.reshape(-1, b)
    f1 = lenet_params["f1"]["w"]
    cases["flat C=256 (f1.w)"] = torch.nn.functional.pad(
        f1.reshape(-1), (0, (-f1.numel()) % 256)).reshape(-1, 256)
    ragged = torch.randn((1001, 256), generator=g).cuda() * 3.0
    ragged[5] = 0.0                                    # all-zero block
    ragged[6] = 1e-30 * ragged[7]                      # tiny block (SCALE_EPS)
    ragged[8, :6] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    ragged[8, 6:] = 0.0                                # .5 ties: half to even
    cases["ragged R=1001 C=256"] = ragged
    cases["ragged R=1001 C=77"] = ragged[:, :77].contiguous()
    cases["bf16 f1.w C=120"] = f1.to(torch.bfloat16)
    cases["bf16 ragged C=256"] = ragged.to(torch.bfloat16)

    q_err, dq_err = 0, 0.0
    for name, x in cases.items():
        qk, sk = q_ops.quantize_rows(x)
        qr, sr = quantize_ref(x)
        if not (torch.equal(qk, qr) and torch.equal(sk, sr)):
            diff = int((qk.int() - qr.int()).abs().max())
            fail(f"quantize kernel != plain on {name}: max |dq| {diff}, "
                 f"scales equal {torch.equal(sk, sr)}")
        dk = q_ops.dequantize_rows(qk, sk)
        dr = dequantize_ref(qk, sk)
        if not torch.equal(dk, dr):
            fail(f"dequantize kernel != plain on {name}")
        q_err = max(q_err, int((qk.int() - qr.int()).abs().max()))
        dq_err = max(dq_err, float((dk - dr).abs().max()))
        print(f"quantize/dequantize {name:24s} R={x.shape[0]:5d}: bitwise OK")
    # the ties row quantized half-to-even
    q8 = q_ops.quantize_rows(ragged[8:9])[0][0, :6].tolist()
    if q8 != [127, 0, 2, 2, 0, -2]:
        fail(f"half-to-even rounding broken: {q8}")
    # the row API's bf16 output (the Pallas dequantize's dtype=)
    qk, sk = q_ops.quantize_rows(ragged)
    for s_in in (sk, sk.to(torch.bfloat16)):
        if not torch.equal(q_ops.dequantize_rows(qk, s_in, dtype=torch.bfloat16),
                           dequantize_ref(qk, s_in, torch.bfloat16)):
            fail(f"dequantize kernel (bf16 out, {s_in.dtype} scales) != plain")
    print("dequantize rows bf16 out, fp32 and bf16 scales: bitwise OK")
    check_quantize_trees(torch, lenet_params, ragged)
    return q_err, dq_err


def _tree_cases(torch, lenet_params, ragged):
    """The trees phase 3 holds the tree kernels to: the LeNet params (the
    main path's), an odd tree (0-d, zero-size leaves), ragged last axes
    (300, 520, 257: masked tails), a bf16 tree and a mixed one, 70 leaves
    (two launches a direction), and LeNet's leaves 4 bytes past an aligned
    base (the scalar path)."""
    from repro_torch import tree
    g = torch.Generator(device="cuda").manual_seed(7)

    def rnd(*shape, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * 3.0).to(dtype)

    def shifted(x):
        off = 4 // x.element_size()
        return torch.empty(off + x.numel(), dtype=x.dtype,
                           device="cuda")[off:].view(x.shape).copy_(x)

    lenet = tree.leaves(lenet_params)
    return {
        "lenet": lenet,
        "odd": [rnd(), rnd(4, 0), rnd(0, 5), rnd(6)],
        "ragged": [rnd(5, 300), rnd(2, 3, 520), rnd(3, 257), ragged[:, :77]],
        "bf16": [x.to(torch.bfloat16) for x in lenet] + [rnd(4, 520, dtype=torch.bfloat16)],
        "mixed": [rnd(120, dtype=torch.bfloat16), rnd(32, 120), rnd(7, 10),
                  rnd(4, 520, dtype=torch.bfloat16)],
        "70 leaves": [rnd((i % 5) + 1, 4 + 3 * i) for i in range(70)],
        "lenet +4 bytes": [shifted(x) for x in lenet],
    }


def check_quantize_trees(torch, lenet_params, ragged):
    """The tree kernels bitwise against the plain version that walks the
    same segment table, on every tree of ``_tree_cases``."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.quantize import ref as q_ref
    from repro_torch.kernels.quantize import table

    for name, leaves in _tree_cases(torch, lenet_params, ragged).items():
        specs = [(tuple(x.shape), x.dtype) for x in leaves]
        plan = table.plan_for(leaves, 256)
        before = LAUNCHES["quantize"], LAUNCHES["dequantize"]
        pairs = q_ops.quantize_tree(leaves)
        outs = q_ops.dequantize_tree(pairs, specs)
        torch.cuda.synchronize()
        counted = (LAUNCHES["quantize"] - before[0], LAUNCHES["dequantize"] - before[1])
        if counted != (len(plan.groups),) * 2:
            fail(f"tree {name}: {counted} launches for {len(plan.groups)} groups")
        for (q, s), (qr, sr) in zip(pairs, q_ref.quantize_tree_ref(leaves, 256)):
            if not (torch.equal(q, qr) and torch.equal(s, sr)):
                fail(f"quantize tree kernel != plain on tree {name}")
        want = q_ref.dequantize_tree_ref(pairs, specs)
        for got in (outs, q_ops.roundtrip_tree(leaves)):
            for o, w in zip(got, want):
                if o.dtype != w.dtype or not torch.equal(o, w):
                    fail(f"dequantize tree kernel != plain on tree {name}")
        vec = sum(int(v) for g in plan.groups for v in g.vec_ok)
        print(f"quantize/dequantize tree {name:15s} {len(leaves):2d} leaves, "
              f"{plan.n_scales:5d} rows, {len(plan.groups)} launch(es) a "
              f"direction, {vec} segment(s) vector-eligible: bitwise OK")


def _per_leaf_roundtrip(torch, leaves):
    """The parent's wire round trip, rebuilt from the row API: per leaf a
    pad where the last axis is ragged, the quantize kernel, the fp32 scales
    cast to bf16 and back, the dequantize kernel, the slice."""
    from repro_torch.core import compression
    from repro_torch.kernels.quantize import ops as q_ops
    out = []
    for x in leaves:
        lead, last, b, nblocks = compression._last_axis_blocking(tuple(x.shape))
        xf = x.reshape(*lead, last)
        if nblocks * b > last:
            xf = torch.nn.functional.pad(xf.to(torch.float32), (0, nblocks * b - last))
        q, s = q_ops.quantize_rows(xf.reshape(-1, b))
        s16 = s.reshape(*lead, nblocks).to(torch.bfloat16)
        y = q_ops.dequantize_rows(q, s16.to(torch.float32).reshape(-1, 1))
        out.append(y.reshape(*lead, nblocks * b)[..., :last].reshape(x.shape).to(x.dtype))
    return out


def _tree_bytes(plan, leaves):
    """Bytes a tree quantize (or dequantize) must move: every leaf once in
    its own type, the packed q and the bf16 scales once."""
    return sum(x.numel() * x.element_size() for x in leaves) + plan.q_bytes \
        + 2 * plan.n_scales


def check_wfedavg(torch):
    from repro_torch.kernels.wfedavg import ops as wf_ops
    from repro_torch.kernels.wfedavg.ref import wfedavg_ref
    g = torch.Generator().manual_seed(2)
    worst = 0.0
    for name, n, d, offset in (("f1.w", 10, 94080, 0), ("f2.w", 10, 10080, 0),
                               ("ragged", 10, 10081, 0), ("misaligned", 7, 4100, 1),
                               ("N=1", 1, 4096, 0)):
        buf = torch.randn((n, d + offset), generator=g).cuda() * 0.05
        models = buf[:, offset:]
        pbuf = torch.randn((d + offset,), generator=g).cuda() * 0.05
        prev = pbuf[offset:]                      # offset 1: not 16-byte aligned
        wn = torch.softmax(torch.randn((n,), generator=g), 0).cuda()
        out_k = wf_ops.wfedavg_flat(models, wn, prev)
        out_r = wfedavg_ref(models, wn, prev)
        err = float((out_k - out_r).abs().max())
        if not torch.allclose(out_k, out_r, rtol=1e-6, atol=1e-6):
            fail(f"wfedavg kernel != plain on {name}: max |diff| {err}")
        worst = max(worst, err)
        print(f"wfedavg {name:10s} N={n:2d} D={d:6d}: max |kernel - plain| "
              f"{err:.3e} (rtol/atol 1e-6) OK")
    return worst


def time_kernels(torch, lenet_params):
    """Times on the main path's tree (LeNet's params, one broadcast) and
    the f2.w FedAvg leaf, then the tree kernels at a bandwidth-bound size;
    returns the per-kernel rows of the JSON line."""
    from repro_torch import tree
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.quantize import ref as q_ref
    from repro_torch.kernels.quantize import table
    from repro_torch.kernels.wfedavg import ops as wf_ops
    from repro_torch.kernels.wfedavg.ref import wfedavg_ref

    iters = 200
    rows = {}

    def row(name, fn, plain, library, nbytes, ops, shape, **extra):
        ms, method, names = device_ms(fn, iters)
        plain_ms, plain_method, _ = device_ms(plain, iters)
        lib_ms, lib_method = None, "-"
        if library is not None:
            lib_ms, lib_method, _ = device_ms(library, iters)
        b_ms, b_by = bound_ms(nbytes, ops)
        call = event_ms(fn, iters)
        timing = f"{method}/{plain_method}/{lib_method}"
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, call_ms=call,
                          shape=shape, timing=timing, **extra)
        lib = "null" if lib_ms is None else f"{lib_ms:.5f}"
        print(f"time {name:10s} {shape:24s} kernel_ms={ms:.7f} "
              f"plain_ms={plain_ms:.5f} library_ms={lib} bound_ms={b_ms:.7f} "
              f"({b_by}, {nbytes} B) call_ms={call:.5f} [{timing}; kernel "
              f"events {names}]")

    # the LeNet tree: the kernels of one broadcast, beside the same tree
    # through the row API one leaf at a time (what the parent launched)
    leaves = tree.leaves(lenet_params)
    specs = [(tuple(x.shape), x.dtype) for x in leaves]
    plan = table.plan_for(leaves, 256)
    pairs = q_ops.quantize_tree(leaves)
    blocked = [x.reshape(-1, x.shape[-1]) for x in leaves]   # LeNet: b == last
    row_pairs = [q_ops.quantize_rows(x) for x in blocked]
    per_leaf = {
        "quantize": device_ms(lambda: [q_ops.quantize_rows(x) for x in blocked],
                              iters)[0],
        "dequantize": device_ms(lambda: [q_ops.dequantize_rows(q, s)
                                         for q, s in row_pairs], iters)[0]}
    nbytes = _tree_bytes(plan, leaves)
    n = sum(x.numel() for x in leaves)
    shape = f"LeNet tree, {len(leaves)} leaves, {plan.n_scales} rows, fp32"
    row("quantize", lambda: q_ops.quantize_tree(leaves),
        lambda: q_ref.quantize_tree_ref(leaves, 256), None, nbytes, 6 * n, shape,
        per_leaf_ms=per_leaf["quantize"])
    row("dequantize", lambda: q_ops.dequantize_tree(pairs, specs),
        lambda: q_ref.dequantize_tree_ref(pairs, specs), None, nbytes, n, shape,
        per_leaf_ms=per_leaf["dequantize"])
    print(f"per-leaf row API over the LeNet tree (10 launches a direction, "
          f"device time a tree): quantize {per_leaf['quantize']:.7f} ms, "
          f"dequantize {per_leaf['dequantize']:.7f} ms")
    # one leaf through the row API at f1.w, the shape PRs 11-13 timed
    f1 = lenet_params["f1"]["w"].contiguous()
    q1, s1 = q_ops.quantize_rows(f1)
    print(f"row API at f1.w (784, 120): quantize "
          f"{device_ms(lambda: q_ops.quantize_rows(f1), iters)[0]:.7f} ms, "
          f"dequantize {device_ms(lambda: q_ops.dequantize_rows(q1, s1), iters)[0]:.7f} ms"
          f", torch.mul {device_ms(lambda: torch.mul(q1, s1), iters)[0]:.7f} ms")
    time_roundtrip(torch, leaves, iters)
    rows["quantize"]["llama3_layer"], rows["dequantize"]["llama3_layer"] = \
        time_llama3_layer(torch)
    g = torch.Generator().manual_seed(3)
    for name, d in (("wfedavg", 94080), ("wfedavg@f2", 10080)):
        n = 10
        models = (torch.randn((n, d), generator=g) * 0.05).cuda()
        prev = (torch.randn((d,), generator=g) * 0.05).cuda()
        wn = torch.softmax(torch.randn((n,), generator=g), 0).cuda()
        row(name, lambda m=models, w=wn, p=prev: wf_ops.wfedavg_flat(m, w, p),
            lambda m=models, w=wn, p=prev: wfedavg_ref(m, w, p),
            lambda m=models, w=wn, p=prev: torch.addmv(p, m.T, w, beta=0.5,
                                                      alpha=0.5),
            (n + 2) * d * 4 + n * 4, 2 * n * d + 2 * d, f"N={n} D={d} fp32")
    return rows


def _kernels_a_call(torch, fn):
    """Names of the device events (kernels, copies, memsets) the profiler
    sees in one call of ``fn``, after warm-up calls."""
    return [e.name for e in _device_events(fn, 1, warmup=3)]


def time_roundtrip(torch, leaves, iters):
    """One broadcast's wire round trip on the LeNet tree, in turns in this
    run (per-leaf, tree, tree, per-leaf; then the plain version): device
    time a call from the profiler, wall time a call by CUDA events (host
    launch cost included), and the device kernels a call."""
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.quantize import ref as q_ref
    from repro_torch.kernels.quantize import table

    plan = table.plan_for(leaves, 256)
    ways = {"per-leaf": lambda: _per_leaf_roundtrip(torch, leaves),
            "tree": lambda: q_ops.roundtrip_tree(leaves),
            "plain": lambda: q_ref.roundtrip_tree_ref(leaves, 256)}
    for a, b in zip(ways["per-leaf"](), ways["tree"]()):
        if not torch.equal(a, b):
            fail("per-leaf and tree round trips differ")
    got = {}
    for way in ("per-leaf", "tree", "tree", "per-leaf", "plain"):
        dev, _, _ = device_ms(ways[way], iters)
        ev = event_ms(ways[way], iters)
        got.setdefault(way, []).append((dev, ev))
        print(f"roundtrip_tree LeNet {way:8s}: device {dev:.7f} ms, events "
              f"{ev:.5f} ms a call")
    kernels = {way: len(_kernels_a_call(torch, fn)) for way, fn in ways.items()}
    med = {w: (sum(d for d, _ in v) / len(v), sum(e for _, e in v) / len(v))
           for w, v in got.items()}
    b_ms = 2 * _tree_bytes(plan, leaves) / HBM_BYTES_PER_S * 1e3
    print(f"roundtrip LeNet tree, mean of the turns: per-leaf device "
          f"{med['per-leaf'][0]:.7f} ms / events {med['per-leaf'][1]:.5f} ms "
          f"({kernels['per-leaf']} device kernels a call); tree device "
          f"{med['tree'][0]:.7f} ms / events {med['tree'][1]:.5f} ms "
          f"({kernels['tree']} device kernels a call); plain device "
          f"{med['plain'][0]:.7f} ms / events {med['plain'][1]:.5f} ms "
          f"({kernels['plain']}); tree vs per-leaf: {med['per-leaf'][0] / med['tree'][0]:.2f}x "
          f"less device time, {med['per-leaf'][1] / med['tree'][1]:.2f}x by events; "
          f"bound both ways {b_ms:.7f} ms")


def time_llama3_layer(torch):
    """The tree kernels where bandwidth bounds them: random fp32 tensors
    shaped like one llama3-8b decoder layer's weights as
    ``transformer.init`` lays them out (its stacked units without the layer
    axis)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    meta = transformer.init(torch.Generator(), get_config("llama3-8b"), "meta")
    shapes = [tuple(x.shape[1:]) for x in tree.leaves(meta["units"])]
    return time_tree(torch, "llama3-8b layer", shapes, seed=8)


def time_tree(torch, label, shapes, seed):
    """Both tree kernels on random fp32 leaves of ``shapes`` (scaled like
    weights), each held bitwise to the plain version first, then timed
    beside it and the bytes bound; returns the (quantize, dequantize)
    rows."""
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.quantize import ref as q_ref
    from repro_torch.kernels.quantize import table

    g = torch.Generator(device="cuda").manual_seed(seed)
    leaves = [torch.randn(s, generator=g, device="cuda") * 0.02 for s in shapes]
    specs = [(tuple(x.shape), x.dtype) for x in leaves]
    plan = table.plan_for(leaves, 256)
    n = sum(x.numel() for x in leaves)
    pairs = q_ops.quantize_tree(leaves)
    for (q, s), (qr, sr) in zip(pairs, q_ref.quantize_tree_ref(leaves, 256)):
        if not (torch.equal(q, qr) and torch.equal(s, sr)):
            fail(f"quantize tree kernel != plain at the {label}")
    for o, w in zip(q_ops.dequantize_tree(pairs, specs),
                    q_ref.dequantize_tree_ref(pairs, specs)):
        if not torch.equal(o, w):
            fail(f"dequantize tree kernel != plain at the {label}")
    nbytes = _tree_bytes(plan, leaves)
    b_ms, b_by = bound_ms(nbytes, 6 * n)
    out = {}
    for name, fn, plain in (
            ("quantize", lambda: q_ops.quantize_tree(leaves),
             lambda: q_ref.quantize_tree_ref(leaves, 256)),
            ("dequantize", lambda: q_ops.dequantize_tree(pairs, specs),
             lambda: q_ref.dequantize_tree_ref(pairs, specs))):
        ms, method, names = device_ms(fn, 20)
        plain_ms, _, _ = device_ms(plain, 3)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         share=b_ms / ms, bytes=nbytes, elements=n,
                         leaves=len(leaves), rows=plan.n_scales)
        print(f"time {name} {label} ({len(leaves)} leaves, {n} fp32 "
              f"elements, {plan.n_scales} rows, {nbytes} B): kernel_ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by}) -> "
              f"{b_ms / ms:.4f} of its bound, {nbytes / ms / 1e9:.4f} TB/s "
              f"[{method}; {names}]")
    del leaves, pairs
    torch.cuda.empty_cache()
    return out["quantize"], out["dequantize"]


# (name, B, S, H, KH, Dh, causal, window): the serving path's heads and a
# gemma3 local layer's, a bidirectional and two ragged cases (S 4095 is the
# consistency check's length), KH = 1 and KH = H
FLASH_CASES = (
    ("llama3 S=4096 causal", 1, 4096, 32, 8, 128, True, 0),
    ("gemma3 local S=4096 w=1024", 1, 4096, 16, 8, 256, True, 1024),
    ("bidirectional Dh=64", 1, 2048, 16, 4, 64, False, 0),
    ("ragged S=1000", 2, 1000, 32, 8, 128, True, 0),
    ("ragged S=4095", 1, 4095, 32, 8, 128, True, 0),
    ("KH=1 S=1024", 1, 1024, 8, 1, 128, True, 0),
    ("KH=H S=1024", 1, 1024, 8, 8, 128, True, 0),
    ("hubert Dh=80 ragged S=1000", 2, 1000, 16, 16, 80, False, 0),
)
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}   # bf16: one bf16 ulp
# the serving path's flash call: llama3-8b prefill, B 4 x P 4096; and a
# gemma3-12b local layer's at the same batch and length (window 1024)
FLASH_MAIN = (4, 4096, 32, 8, 128)
FLASH_GEMMA_LOCAL = (4, 4096, 16, 8, 256, 1024)
# the kernel symbols whose device time is flash's share of prefill
FLASH_SYMBOLS = ("flash_fwd_kernel", "flash_fwd_sm90_kernel")


def _qkv(torch, g, B, S, H, KH, Dh, dtype):
    return (torch.randn((B, S, H, Dh), generator=g, device="cuda").to(dtype),
            torch.randn((B, S, KH, Dh), generator=g, device="cuda").to(dtype),
            torch.randn((B, S, KH, Dh), generator=g, device="cuda").to(dtype))


def _simt_view(torch, x):
    """The values of ``x`` in a view whose base lies 8 bytes past a 16-byte
    aligned one: ``_variant`` sends bf16 inputs laid out so to the simt
    kernel, at any head dim."""
    off = 8 // x.element_size()
    view = torch.empty(off + x.numel(), dtype=x.dtype, device=x.device)[off:]
    return view.view(x.shape).copy_(x)


def _flash_route(torch, q, k, v, **kw):
    """(out, route): one call of the wrapper, and the kernel that the launch
    counters say it launched."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ops
    before = (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_sm90"])
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    total = LAUNCHES["flash_attention"] - before[0]
    sm90 = LAUNCHES["flash_attention_sm90"] - before[1]
    if total != 1:
        fail(f"one flash call counted {total} launches")
    return out, "sm90" if sm90 else "simt"


def check_flash(torch):
    """Both flash kernels against the plain version on every case, each
    reached through the routing rule and its route read from the launch
    counters: in bf16 the sm90 kernel on the tensors as made and the simt
    kernel on ``_simt_view`` copies of them (one bf16 ulp); in fp32 the
    simt kernel (1e-5). Returns the worst error of each (route, dtype)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device="cuda").manual_seed(4)
    worst = {}
    for name, B, S, H, KH, Dh, causal, window in FLASH_CASES:
        for dtype in ("float32", "bfloat16"):
            q, k, v = _qkv(torch, g, B, S, H, KH, Dh, getattr(torch, dtype))
            want = attention_ref(q, k, v, causal=causal, window=window).float()
            tol = FLASH_TOL[dtype]
            runs = [("simt", (q, k, v))]
            if dtype == "bfloat16":
                runs = [("sm90", (q, k, v)),
                        ("simt", tuple(_simt_view(torch, x) for x in (q, k, v)))]
            for expect, qkv in runs:
                got, used = _flash_route(torch, *qkv, causal=causal, window=window)
                if used != expect:
                    fail(f"flash {name} {dtype} ran the {used} kernel, not {expect}")
                err = float((got.float() - want).abs().max())
                if not torch.allclose(got.float(), want, rtol=tol, atol=tol):
                    fail(f"flash {used} kernel != plain on {name} {dtype}: max "
                         f"|diff| {err}")
                worst[used, dtype] = max(worst.get((used, dtype), 0.0), err)
                print(f"flash {used} {name:28s} {dtype:8s} B={B} H={H} KH={KH} "
                      f"Dh={Dh}: max |kernel - plain| {err:.3e} (rtol/atol {tol}) OK")
                del got, qkv
            del q, k, v, want, runs
    torch.cuda.empty_cache()
    return worst


def _flash_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal mask (and a window) keeps in one head of
    an S x S call."""
    return S * (S + 1) // 2 if not window else sum(min(i + 1, window)
                                                    for i in range(S))


def time_flash(torch, B, S, H, KH, Dh, window=0, dtype="bfloat16",
               plain_iters=3, causal=True):
    """The flash kernels at one shape, each beside the bound, the plain
    version and one PyTorch call for the same function
    (scaled_dot_product_attention, timed here only; with a window it takes
    an explicit boolean mask). In bf16 at an sm90 head dim (64, 80, 128,
    256) the sm90 kernel runs on the tensors as made and the simt kernel on
    ``_simt_view`` copies of the same values; at another head dim and in
    fp32 only the simt kernel takes them, as made. Each is held against
    the plain version first. Returns {route: row}."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = _qkv(torch, g, B, S, H, KH, Dh, getattr(torch, dtype))
    inputs = {"simt": (q, k, v)}
    if dtype == "bfloat16" and Dh in ops.SM90_HEAD_DIMS:
        inputs = {"sm90": (q, k, v),
                  "simt": tuple(_simt_view(torch, x) for x in (q, k, v))}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))    # (B, heads, S, Dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window:
        i = torch.arange(S, device="cuda")
        keep = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

        def library():
            return sdpa(qt, kt, vt, attn_mask=keep, enable_gqa=True)
    else:
        def library():
            return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    want = attention_ref(q, k, v, causal=causal, window=window).float()
    lib_err = float((want - library().transpose(1, 2).float()).abs().max())
    errs = {}
    for kern, qkv in inputs.items():
        got, used = _flash_route(torch, *qkv, causal=causal, window=window)
        errs[kern] = float((got.float() - want).abs().max())
        if used != kern or not torch.allclose(got.float(), want, rtol=FLASH_TOL[dtype],
                                              atol=FLASH_TOL[dtype]):
            fail(f"flash {kern} timing inputs ran {used}, max |diff| {errs[kern]}")
        del got
    del want
    plain_ms, plain_method, _ = device_ms(
        lambda: attention_ref(q, k, v, causal=causal, window=window), plain_iters)
    lib_ms, lib_method, lib_names = device_ms(library, 10)
    pairs = _flash_pairs(S, window) if causal else S * S
    ops_count = 4 * Dh * pairs * B * H   # Q.K and P.V
    nbytes = q.element_size() * (2 * B * S * H * Dh + 2 * B * S * KH * Dh)
    b_ms, b_by = bound_ms(nbytes, ops_count, BF16_OPS_PER_S if dtype == "bfloat16"
                          else FP32_OPS_PER_S)
    shape = (f"B={B} S={S} H={H} KH={KH} Dh={Dh} {dtype} "
             + ("causal" if causal else "bidirectional")
             + (f" w={window}" if window else ""))
    rows = {}
    for kern, qkv in inputs.items():
        iters = {"sm90": 20, "simt": 5 if S >= 1024 else 200}[kern]
        fn = (lambda qkv=qkv: ops.flash_attention(*qkv, causal=causal, window=window))
        ms, method, names = device_ms(fn, iters)
        call = event_ms(fn, iters)
        timing = f"{method}/{plain_method}/{lib_method}"
        rows[kern] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                          bound_by=b_by, call_ms=call, shape=shape, timing=timing,
                          max_abs_err=errs[kern])
        print(f"time flash {kern} {shape} kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={lib_ms:.5f} bound_ms={b_ms:.6f} ({b_by}; "
              f"{ops_count:.4e} FLOP, {nbytes:.4e} B) call_ms={call:.5f} "
              f"max |kernel - plain| {errs[kern]:.3e} "
              f"[{timing}; kernel events {names}; library events {lib_names}]")
        print(f"flash {kern} at {shape}: {ops_count / ms / 1e9:.2f} TFLOP/s, "
              f"{b_ms / ms:.4f} of its bound, {ms / lib_ms:.3f}x the library call")
    print(f"scaled_dot_product_attention vs plain at {shape}: max |diff| "
          f"{lib_err:.3e}")
    del q, k, v, qt, kt, vt, inputs
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phases 4-5
def run_main_path(torch):
    from repro_torch.chain import scenarios
    from repro_torch.chain.network import mean_reputation
    from repro_torch.core.reputation import IMPL2
    from repro_torch.kernels import LAUNCHES, reset_launches

    sc, spec, topo, cfg = scenarios.lenet_paper_setup(n=10, compress="int8")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    sim = scenarios.make_heap_simulator(sc, topo, spec, IMPL2, cfg,
                                        use_kernel=True, device="cuda")
    t1 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(LAUNCHES)

    nodes = list(sim.nodes.values())
    honest = [nd for nd in nodes if not nd.malicious]
    attackers = [nd for nd in nodes if nd.malicious]
    first = sum(nd.accuracy_history[0][1] for nd in honest) / len(honest)
    last = sum(nd.accuracy_history[-1][1] for nd in honest) / len(honest)
    rep_att = sum(mean_reputation(nodes, a.info.address) for a in attackers) \
        / len(attackers)
    rep_hon = sum(mean_reputation(nodes, h.info.address) for h in honest) \
        / len(honest)
    st = sim.stats
    print(f"main path: lenet_paper_setup(n=10, compress='int8') "
          f"ticks={cfg.ticks} heap simulator, use_kernel=True, device=cuda")
    print(f"main path stats: tx_sent={st['tx_sent']} "
          f"tx_delivered={st['tx_delivered']} blocks={st['blocks']} "
          f"fedavg_rounds={st['fedavg_rounds']}")
    print(f"main path honest mean test accuracy: first record "
          f"(tick {honest[0].accuracy_history[0][0]}) {first:.4f}, last record "
          f"(tick {honest[0].accuracy_history[-1][0]}) {last:.4f}")
    print(f"main path mean reputation: attackers {rep_att:.4f}, "
          f"honest {rep_hon:.4f}")
    print(f"main path wall seconds: build {t1 - t0:.3f}, run {t2 - t1:.3f}")
    print(f"main path launches: {json.dumps(launches, sort_keys=True)}")

    for k in ("quantize", "dequantize", "wfedavg"):
        if launches.get(k, 0) <= 0:
            fail(f"kernel {k} was not launched on the main path")
    for k in ("quantize", "dequantize"):       # one launch a broadcast
        if launches[k] != st["tx_sent"]:
            fail(f"{k} launched {launches[k]} times for {st['tx_sent']} "
                 "broadcasts, not once each")
    if st["fedavg_rounds"] <= 0:
        fail("no FedAvg round on the main path")
    for nd in nodes:
        for leaf in _leaves(nd.params):
            if leaf.device.type != "cuda":
                fail(f"{nd.name} params left the card ({leaf.device})")
            if not bool(torch.isfinite(leaf).all()):
                fail(f"{nd.name} params are not finite")
        if not nd.ledger.verify_chain(1):
            fail(f"{nd.name}'s ledger does not verify")
    if not all(len(nd.ledger.blocks) >= 1 for nd in nodes):
        fail("a ledger lost its genesis block")
    return launches


def _leaves(params):
    from repro_torch import tree
    return tree.leaves(params)


def check_small_federation(torch):
    """A 5-node federation from the same params on the card (kernels) and on
    the CPU (plain versions): identical event stream, params within the
    int8-boundary rule of tests/test_torch_federation.py."""
    from repro_torch import convert
    from repro_torch.chain import attacks, scenarios, simlax
    from repro_torch.core import topology
    from repro_torch.core.reputation import IMPL2

    n = 5
    sc = scenarios.lenet_scenario(n, malicious=(0,), train_steps=0, pool=16,
                                  eval_size=16, test_size=64, batch=8)
    spec = attacks.FederationSpec.build(n, malicious=(0,), attack="signflip",
                                        initial_countdown=[1 + i % 2 for i in range(n)])
    cfg = simlax.SimLaxConfig(ticks=16, train_interval=(2, 2), latency=1, ttl=2,
                              record_every=5, compress="int8")
    sims = {dev: scenarios.make_heap_simulator(
        sc, topology.kregular(n, 2), spec, IMPL2, cfg, use_kernel=True,
        device=dev) for dev in ("cuda", "cpu")}
    for gpu_node, cpu_node in zip(sims["cuda"].nodes.values(),
                                  sims["cpu"].nodes.values()):
        cpu_node.params = convert.params_from_jax(
            convert.params_to_numpy(gpu_node.params), "cpu")
    for sim in sims.values():
        sim.run()
    torch.cuda.synchronize()
    if sims["cuda"].stats != sims["cpu"].stats:
        fail(f"small federation stats differ: {sims['cuda'].stats} vs "
             f"{sims['cpu'].stats}")
    worst, flips = 0.0, 0.0
    for gpu_node, cpu_node in zip(sims["cuda"].nodes.values(),
                                  sims["cpu"].nodes.values()):
        acc_g = [a for _, a in gpu_node.accuracy_history]
        acc_c = [a for _, a in cpu_node.accuracy_history]
        if max(abs(a - b) for a, b in zip(acc_g, acc_c)) > 2 / 64:
            fail(f"{gpu_node.name} test accuracy differs: {acc_g} vs {acc_c}")
        for a, b in zip(_leaves(gpu_node.params), _leaves(cpu_node.params)):
            diff = (a.cpu() - b).abs()
            off = diff > 1e-5
            if bool(off.any()):
                step = float(b.abs().max()) / 127.0
                if float(off.float().mean()) > 1e-4 or float(diff.max()) > step:
                    fail(f"{gpu_node.name} params differ beyond the int8 "
                         f"boundary rule: max {float(diff.max())}")
                flips = max(flips, float(off.float().mean()))
            worst = max(worst, float(diff.max()))
    print(f"small federation cuda vs cpu: stats equal {sims['cuda'].stats}, "
          f"max |param diff| {worst:.3e}, boundary-flip fraction {flips:.2e} OK")


def check_heap_twice(torch, ticks: int = 36):
    """Two seeded heap runs of the main path's recipe (training on, the int8
    wire, the kernels), cut to its first ``ticks`` ticks: every node's param
    leaves, reputations and accuracy history bitwise equal. Node addresses
    come from fresh RSA keys, so reputations are compared by node name."""
    from repro_torch.chain import scenarios
    from repro_torch.core.reputation import IMPL2

    def run():
        sc, spec, topo, cfg = scenarios.lenet_paper_setup(
            n=10, ticks=ticks, compress="int8")
        sim = scenarios.make_heap_simulator(sc, topo, spec, IMPL2, cfg,
                                            use_kernel=True, device="cuda")
        sim.run()
        torch.cuda.synchronize()
        names = {nd.info.address: nd.name for nd in sim.nodes.values()}
        return sim, names

    (a, names_a), (b, names_b) = run(), run()
    if a.stats != b.stats:
        fail(f"heap twice: stats differ {a.stats} vs {b.stats}")
    if a.stats["fedavg_rounds"] <= 0:
        fail("heap twice: no FedAvg round")
    for na, nb in zip(a.nodes.values(), b.nodes.values()):
        for x, y in zip(_leaves(na.params), _leaves(nb.params)):
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                fail(f"heap twice: {na.name} params differ (max "
                     f"{float((x - y).abs().max())})")
        if na.accuracy_history != nb.accuracy_history:
            fail(f"heap twice: {na.name} accuracy histories differ")
        rep_a = {names_a[k]: v for k, v in na.reputation.items()}
        rep_b = {names_b[k]: v for k, v in nb.reputation.items()}
        if rep_a != rep_b:
            fail(f"heap twice: {na.name} reputations differ")
    print(f"heap twice: lenet_paper_setup(n=10, compress='int8') cut to "
          f"{ticks} ticks, training on, kernels: params, reputations and "
          f"accuracy histories bitwise equal (stats {json.dumps(a.stats)})")


def check_roundtrip_kernels(torch, lenet_params):
    """One broadcast's wire round trip runs exactly two device kernels."""
    from repro_torch.core import compression
    names = _kernels_a_call(torch, lambda: compression.roundtrip_tree(lenet_params))
    print(f"device kernels in one roundtrip_tree of the LeNet params: "
          f"{len(names)} {names}")
    if len(names) != 2:
        fail(f"roundtrip_tree ran {len(names)} device kernels, not 2")


def profile_window(torch, ticks: int = 36):
    """Where the main path's time goes, on two fresh runs of its first
    ``ticks`` ticks (after the main path warmed the card): the device's busy
    and idle share from the profiler, and the host's split by function from
    cProfile. Both profilers slow the host, so the shares are approximate."""
    import cProfile
    import pstats

    from repro_torch.chain import scenarios
    from repro_torch.core.reputation import IMPL2

    def fresh():
        sc, spec, topo, cfg = scenarios.lenet_paper_setup(
            n=10, ticks=ticks, compress="int8")
        return scenarios.make_heap_simulator(sc, topo, spec, IMPL2, cfg,
                                             use_kernel=True, device="cuda")

    sim = fresh()
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in measured_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    busy = sum(by_name.values())
    print(f"profile window ({ticks} ticks, profiler on): wall {wall:.3f} s, "
          f"device busy {busy:.4f} s, device idle share {1 - busy / wall:.4f}")
    for name, sec in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  device {sec:.4f} s ({sec / busy:.3f} of busy)  {name[:90]}")

    sim = fresh()
    torch.cuda.synchronize()
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    sim.run()
    torch.cuda.synchronize()
    pr.disable()
    wall = time.perf_counter() - t0
    cum = {}
    for (path, _, func), (_, _, _, ct, _) in pstats.Stats(pr).stats.items():
        key = f"{os.path.basename(path)}:{func}"
        cum[key] = cum.get(key, 0.0) + ct
    print(f"host window ({ticks} ticks, cProfile on): wall {wall:.3f} s; "
          "cumulative share of wall (nested entries overlap):")
    for key in ("node.py:train_local", "scenarios.py:train_fn",
                "compression.py:roundtrip_tree", "node.py:receive_transaction",
                "scenarios.py:eval_fn", "node.py:maybe_update_model",
                "ops.py:weighted_fedavg_tree", "network.py:_maybe_block",
                "crypto.py:sign", "crypto.py:verify",
                "crypto.py:fingerprint_tree", "scenarios.py:test_fn"):
        if key in cum:
            print(f"  {key:32s} {cum[key]:8.3f} s  {cum[key] / wall:.3f}")


# ------------------------------------------------------------ phases 6-9
SERVE_ARGS = ["--arch", "llama3-8b", "--batch", "4", "--prompt-len", "4096",
              "--gen", "33"]                    # 32 decode steps after prefill
CONSISTENCY_TOL = 0.08   # of the logits' scale (tests/test_models.py's 0.08)


def run_serving(torch):
    """The serving path: ``python -m repro_torch.serve`` at llama3-8b's full
    width and depth, counted."""
    from repro_torch import serve, tree
    from repro_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    sec = out["seconds"]
    steps = out["tokens"].shape[1] - 1
    print(f"serving path: python -m repro_torch.serve {' '.join(SERVE_ARGS)} "
          f"(device cuda)")
    print(f"serving wall seconds: init {sec['init']:.3f}, prefill "
          f"{sec['prefill']:.4f}, decode {sec['decode']:.4f} for {steps} steps = "
          f"{sec['decode'] / steps * 1e3:.3f} ms/token")
    print(f"serving first row tokens: {out['tokens'][0].tolist()}")
    print(f"serving peak device memory: {peak / 2**30:.3f} GiB "
          f"({peak} bytes); bf16 weights (drawn leaf by leaf) + KV cache")
    print(f"serving launches: {json.dumps(launches, sort_keys=True)}")
    for kname in ("flash_attention", "flash_attention_sm90"):
        if launches.get(kname, 0) != 32:
            fail(f"{kname} launched {launches.get(kname, 0)} times on the "
                 "serving path, not 32 (one per layer of prefill)")
    for name in ("prefill_logits", "logits"):
        if not bool(torch.isfinite(out[name]).all()):
            fail(f"serving {name} are not finite")
    for what in ("weights", "cache"):
        for leaf in tree.leaves(out[what]):
            if leaf is not None and leaf.device.type != "cuda":
                fail(f"serving {what} left the card ({leaf.device})")
    return out, launches


def _scale_gap(torch, got, want):
    return float((got - want).abs().max()), float(want.abs().max())


def check_serving_consistency(torch, out):
    """Decode at position P - 1 after prefilling P - 1 tokens (a ragged
    length) against the full prefill's last logits (tests/test_models.py's
    check), at full size on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("llama3-8b")
    prompts, weights = out["inputs"]["tokens"], out["weights"]
    P = prompts.shape[1]
    cache = transformer.cache_init(cfg, prompts.shape[0], P + 1, "cuda")
    _, cache = transformer.prefill(weights, cfg, {"tokens": prompts[:, :P - 1]},
                                   cache)
    logits_d, _ = transformer.decode_step(weights, cfg, prompts[:, P - 1:], cache,
                                          P - 1)
    want = out["prefill_logits"]
    gap, scale = _scale_gap(torch, logits_d, want)
    agree = float((logits_d.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"prefill-then-decode consistency (llama3-8b, P-1 = {P - 1}): max "
          f"|decode - prefill| {gap:.4f} on logits up to {scale:.4f} "
          f"({gap / scale:.4f} of the scale; limit {CONSISTENCY_TOL}), argmax "
          f"agreement {agree:.2f}")
    if not gap <= CONSISTENCY_TOL * scale:
        fail("prefill-then-decode logits disagree beyond the bf16 tolerance")
    del cache
    torch.cuda.empty_cache()


def profile_serving(torch, out, steps: int = 8):
    """Where the serving path's time goes: one prefill, then ``steps``
    decode steps, each window under the profiler (device busy/idle share,
    top device ops, the flash kernel's share of prefill device time)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("llama3-8b")
    prompts, weights = out["inputs"]["tokens"], out["weights"]
    B, P = prompts.shape
    cache = transformer.cache_init(cfg, B, P + steps, "cuda")
    shares = {}

    def window(name, fn):
        torch.cuda.synchronize()
        with profiled() as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = {}
        for e in measured_events(prof):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
        busy = sum(by_name.values())
        flash = sum(t for n, t in by_name.items()
                    if any(sym in n for sym in FLASH_SYMBOLS))
        print(f"profile {name} (profiler on): wall {wall:.4f} s, device busy "
              f"{busy:.4f} s, device idle share {1 - busy / wall:.4f}, flash "
              f"kernel {flash:.4f} s = {flash / busy if busy else 0.0:.4f} of busy")
        for n, sec in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  device {sec:.4f} s ({sec / busy:.3f} of busy)  {n[:90]}")
        shares[name] = dict(wall=wall, busy=busy, idle=1 - busy / wall,
                            flash_share=flash / busy if busy else 0.0)

    state = {}

    def prefill():
        state["logits"], _ = transformer.prefill(weights, cfg, {"tokens": prompts},
                                                 cache)

    def decode():
        tok = state["logits"].argmax(-1)[:, None]
        for i in range(steps):
            logits, _ = transformer.decode_step(weights, cfg, tok, cache, P + i)
            tok = logits.argmax(-1)[:, None]

    window("prefill (B 4, P 4096)", prefill)
    window(f"decode ({steps} steps)", decode)
    if shares["prefill (B 4, P 4096)"]["flash_share"] <= 0:
        fail(f"no flash kernel ({', '.join(FLASH_SYMBOLS)}) in the prefill profile")
    del cache
    torch.cuda.empty_cache()
    return shares


SMOKE_PROMPTS = (2, 40)       # phase 8: B x P of smoke_config("llama3-8b")


def smoke_flash_shape():
    """(B, S, H, KH, Dh) of phase 8's flash calls: smoke_config("llama3-8b")
    (Dh 16, the simt kernel's) prefilling SMOKE_PROMPTS."""
    from repro_torch.configs import smoke_config
    cfg = smoke_config("llama3-8b")
    return (*SMOKE_PROMPTS, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)


def check_smoke_card_vs_cpu(torch):
    """smoke_config("llama3-8b") from the same params on the card (the flash
    kernel) and on the CPU (its plain version): prefill of a ragged prompt
    and 4 decode steps, fp32 logits within rtol/atol 1e-4, bf16 within
    5e-2 of the logits' scale (tests/test_torch_transformer.py's limits).
    Counts are zeroed just before each card run and read just after; at Dh
    16 every flash launch is the simt kernel's. Returns the fp32 run's."""
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer

    cfg = smoke_config("llama3-8b")
    g = torch.Generator(device="cuda").manual_seed(6)
    params = {"cuda": transformer.init(g, cfg, "cuda")}
    params["cpu"] = convert.params_from_jax(convert.params_to_numpy(params["cuda"]),
                                            "cpu")
    B, P = SMOKE_PROMPTS
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device="cuda")
    counted = {}
    for dtype in (torch.float32, torch.bfloat16):
        logits = {}
        for dev in ("cuda", "cpu"):
            if dev == "cuda":
                torch.cuda.synchronize()
                reset_launches()
            cache = transformer.cache_init(cfg, B, P + 8, dev, dtype=dtype)
            lg, cache = transformer.prefill(params[dev], cfg,
                                            {"tokens": prompts.to(dev)}, cache,
                                            dtype=dtype)
            seq = [lg]
            tok = prompts[:, -1:].to(dev)
            for i in range(4):
                lg, cache = transformer.decode_step(params[dev], cfg, tok, cache,
                                                    P + i, dtype=dtype)
                seq.append(lg)
            logits[dev] = torch.stack(seq).cpu()
            if dev == "cuda":
                counted[dtype] = dict(LAUNCHES)
        simt = counted[dtype].get("flash_attention", 0)
        if simt != cfg.num_layers or counted[dtype].get("flash_attention_sm90", 0):
            fail(f"smoke prefill on the card launched flash {simt} times, sm90 "
                 f"{counted[dtype].get('flash_attention_sm90', 0)}, not "
                 f"{cfg.num_layers} simt launches")
        gap, scale = _scale_gap(torch, logits["cuda"], logits["cpu"])
        if dtype == torch.float32:
            ok = torch.allclose(logits["cuda"], logits["cpu"], rtol=1e-4, atol=1e-4)
        else:
            ok = gap <= 5e-2 * scale
        print(f"smoke llama3-8b card vs CPU ({dtype}, prefill P=40 + 4 decode "
              f"steps): max |diff| {gap:.3e} on logits up to {scale:.3f}")
        if not ok:
            fail(f"smoke llama3-8b logits differ between card and CPU ({dtype})")
    print(f"smoke launches (card, fp32): "
          f"{json.dumps(counted[torch.float32], sort_keys=True)}")
    return counted[torch.float32]["flash_attention"]


# ------------------------------------------------------------------ main
# ------------------------------------------------------------ phases 9-11
LAX_INT_KEYS = ("arrive", "buf_cnt", "next_train", "min_sender")
LAX_STATS = ("broadcasts", "deliveries", "fedavg_rounds", "max_tick_deliveries")


def _lax_toy(engine, device, *, n=14, ticks=90, fixed=False, attack="gaussian",
             seed=1):
    """tests/test_torch_simlax.py's kregular case: degree 3, ttl 2, a dead
    node, a straggler; random train intervals unless ``fixed``."""
    from repro_torch.chain import attacks, scenarios, simlax
    from repro_torch.core import topology
    from repro_torch.core.reputation import IMPL2
    spec = attacks.FederationSpec.build(
        n, malicious=(2, 9), attack=attack, dead=(5,), stragglers={1: 4},
        initial_countdown=[1 + (3 * i) % 4 for i in range(n)])
    cfg = simlax.SimLaxConfig(ticks=ticks, train_interval=(4, 4 if fixed else 8),
                              latency=1, ttl=2, record_every=18, seed=seed,
                              delivery=engine, compress="int8")
    sc = scenarios.toy_scenario(n, dim=8, malicious=(2, 9))
    return simlax.LaxSimulator(sc, topology.make("kregular", n, degree=3), spec,
                               IMPL2, cfg, device=device).run()


def _lax_lenet_scenario(n=6, train_steps=0):
    from repro_torch.chain import scenarios
    return scenarios.lenet_scenario(n, malicious=(0,), train_steps=train_steps,
                                    pool=32, eval_size=16, test_size=64, batch=8)


def _lax_lenet(engine, device, *, n=6, ticks=24, train_steps=0, attack="signflip",
               fixed=True, params0=None, seed=0):
    """A small LeNet federation: full width, small data, int8 wire."""
    from repro_torch.chain import attacks, simlax
    from repro_torch.core import topology
    from repro_torch.core.reputation import IMPL2
    sc = _lax_lenet_scenario(n, train_steps)
    spec = attacks.FederationSpec.build(
        n, malicious=(0,), attack=attack,
        initial_countdown=[1 + i % 3 for i in range(n)])
    cfg = simlax.SimLaxConfig(ticks=ticks, train_interval=(3, 3 if fixed else 5),
                              latency=1, ttl=2, record_every=4, seed=seed,
                              delivery=engine, compress="int8")
    sim = simlax.LaxSimulator(sc, topology.kregular(n, 2), spec, IMPL2, cfg,
                              device=device)
    return sim.run(params0)


def _lax_same(a, b, what, *, floats):
    """Two vectorized-engine results: stats, per-node broadcasts, the integer
    final state and reputations exactly; floats by ``floats`` ("bitwise",
    "rtol" = 1e-6, or "int8" = the int8 boundary-flip rule on params, test
    accuracies within 2 of 64). Returns the largest float difference."""
    import numpy as np
    for k in LAX_STATS:
        if a.stats[k] != b.stats[k]:
            fail(f"{what}: stats[{k}] {a.stats[k]} != {b.stats[k]}")
    if not np.array_equal(a.stats["broadcasts_per_node"],
                          b.stats["broadcasts_per_node"]):
        fail(f"{what}: broadcasts per node differ")
    for k in LAX_INT_KEYS:
        if not np.array_equal(a.final_state[k], b.final_state[k]):
            fail(f"{what}: final {k} differs")
    if not np.array_equal(a.reputation, b.reputation):
        fail(f"{what}: reputations differ")
    pairs = [(a.final_state[k], b.final_state[k]) for k in ("w_sum", "min_acc")]
    pairs += list(zip(_leaves(a.params), _leaves(b.params)))
    worst = 0.0
    for x, y in pairs:
        with np.errstate(invalid="ignore"):
            diff = np.abs(x.astype(np.float64) - y.astype(np.float64))
        diff = np.where(x == y, 0.0, diff)
        worst = max(worst, float(diff.max()) if diff.size else 0.0)
        if floats == "bitwise" and not np.array_equal(x, y):
            fail(f"{what}: floats differ (max {float(diff.max())})")
        if floats == "rtol" and not np.allclose(x, y, rtol=1e-6, atol=0):
            fail(f"{what}: floats differ beyond rtol 1e-6")
        if floats == "int8":
            off = diff > 1e-5
            if off.any() and (off.mean() > 1e-4
                              or diff.max() > np.abs(y).max() / 127.0):
                fail(f"{what}: params differ beyond the int8 boundary rule")
    acc = np.abs(a.acc_history - b.acc_history)
    if floats == "int8" and acc.size and acc.max() > 2 / 64:
        fail(f"{what}: test accuracies differ by {acc.max()}")
    if floats != "int8" and not np.allclose(a.acc_history, b.acc_history,
                                            rtol=0 if floats == "bitwise" else 1e-6,
                                            atol=0):
        fail(f"{what}: test accuracies differ")
    return worst


def check_lax_engines(torch):
    """Phase 9: the vectorized engine's delivery engines agree on the card,
    the card agrees with the CPU, and two seeded card runs are bitwise
    equal."""
    from repro_torch import convert
    toy = {e: _lax_toy(e, "cuda") for e in ("compact", "sparse", "dense")}
    lenet = {e: _lax_lenet(e, "cuda", train_steps=1, attack="gaussian",
                           fixed=False)
             for e in ("compact", "sparse", "dense")}
    for name, runs in (("toy", toy), ("lenet", lenet)):
        if runs["compact"].stats["deliveries"] <= 0:
            fail(f"{name}: no deliveries")
        gap = max(_lax_same(runs["compact"], runs[e], f"{name} compact vs {e}",
                            floats="rtol") for e in ("sparse", "dense"))
        print(f"lax engines on the card, {name}: compact == sparse == dense "
              f"(stats {json.dumps({k: runs['compact'].stats[k] for k in LAX_STATS})}; "
              f"max float gap {gap:.3e})")
    params0 = convert.params_to_numpy(
        _lax_lenet_scenario().init_params_stacked("cuda"))
    card = _lax_lenet("compact", "cuda", params0=params0)
    host = _lax_lenet("compact", "cpu", params0=params0)
    gap = _lax_same(card, host, "lenet compact cuda vs cpu", floats="int8")
    print(f"lax compact, lenet cuda vs cpu from the same params: events and "
          f"reputations equal, max float gap {gap:.3e}")
    gap = _lax_same(_lax_toy("compact", "cuda", fixed=True, attack="signflip"),
                    _lax_toy("compact", "cpu", fixed=True, attack="signflip"),
                    "toy compact cuda vs cpu", floats="rtol")
    print(f"lax compact, toy cuda vs cpu: events and reputations equal, max "
          f"float gap {gap:.3e}")
    for name, run in (("toy", lambda: _lax_toy("compact", "cuda")),
                      ("lenet", lambda: _lax_lenet(
                          "compact", "cuda", train_steps=2, attack="gaussian",
                          fixed=False, seed=3))):
        a, b = run(), run()
        _lax_same(a, b, f"{name} compact twice", floats="bitwise")
        for x, y in zip(_leaves(a.sent), _leaves(b.sent)):
            if not (x == y).all():
                fail(f"{name} compact twice: broadcasts differ")
        print(f"lax compact, {name}: two seeded card runs bitwise equal")


def _training_ticks(spec, cfg):
    """Ticks on which some node trains, from the role sheet alone (fixed
    interval, no churn): the wire's launches on the lax path, one
    round trip a training tick."""
    lo, hi = cfg.train_interval
    if lo != hi or spec.membership is not None or spec.dead:
        fail("the launch count needs a fixed interval and static membership")
    strag = dict(spec.stragglers)
    nxt = list(spec.initial_countdown)
    ticks = 0
    for _ in range(cfg.ticks):
        nxt = [c - 1 for c in nxt]
        trained = [i for i, c in enumerate(nxt) if c <= 0]
        for i in trained:
            nxt[i] = lo * strag.get(i, 1)
        ticks += bool(trained)
    return ticks


def run_lax_paper(torch, n, *, profile_ticks=0):
    """Phases 10-11: ``lenet_paper_setup(n, compress="int8")`` on the compact
    engine, counted; quantize and dequantize must launch once a training
    tick. With ``profile_ticks``, fresh runs of the first ticks under the
    profilers."""
    import numpy as np

    from repro_torch.chain import scenarios, simlax
    from repro_torch.core.reputation import IMPL2
    from repro_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    sc, spec, topo, cfg = scenarios.lenet_paper_setup(n, compress="int8")
    t1 = time.perf_counter()
    sim = simlax.LaxSimulator(sc, topo, spec, IMPL2, cfg, device="cuda")
    params0 = sc.init_params_stacked("cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t3 = time.perf_counter()
    res = sim.run(params0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t3
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = _training_ticks(spec, cfg)
    mal = list(spec.malicious)
    honest = [i for i in range(n) if i not in mal]
    acc = res.acc_history[:, honest].mean(1)
    rep_mal = float(np.mean([res.mean_reputation(i) for i in mal]))
    rep_hon = float(np.mean([res.mean_reputation(i) for i in honest]))
    st = res.stats
    print(f"lax paper run n={n}: lenet_paper_setup(n={n}, compress='int8') "
          f"compact engine, ticks={cfg.ticks}, device=cuda; W bound "
          f"{st['compact_budget']}, slot width {st['delivery_budget']}")
    print(f"lax n={n} set-up seconds: scenario data {t1 - t0:.3f}, simulator "
          f"+ params on the card {t2 - t1:.3f}")
    print(f"lax n={n} run: wall {wall:.3f} s, {cfg.ticks / wall:.3f} ticks/s, "
          f"peak device memory {peak:.3f} GiB")
    print(f"lax n={n} stats: " + json.dumps(
        {k: st[k] for k in LAX_STATS + ("wire_bytes",)}))
    print(f"lax n={n} honest mean test accuracy by record tick "
          f"{res.record_ticks.tolist()}: {[round(float(a), 4) for a in acc]}")
    # a node's reputation moves only in the views of the nodes that hear
    # it: its ttl-ball (at n = 1024 most of a ring never does)
    from repro_torch.core import topology
    dist = topology.hop_distance_from_adj(topo.adj, max_hops=cfg.ttl)
    ball = (dist >= 1) & (dist <= cfg.ttl)
    ball_mal, ball_hon = (float(np.mean([res.reputation[ball[:, j], j].mean()
                                         for j in ids])) for ids in (mal, honest))
    print(f"lax n={n} mean reputation: poisoners {rep_mal:.4f}, honest "
          f"{rep_hon:.4f}; in the views of their ttl-balls: poisoners "
          f"{ball_mal:.4f}, honest {ball_hon:.4f}")
    print(f"lax n={n} launches: {json.dumps(launches, sort_keys=True)} "
          f"(training ticks {want})")
    for k in ("quantize", "dequantize"):
        if launches.get(k, 0) != want:
            fail(f"lax n={n}: {k} launched {launches.get(k, 0)} times, not "
                 f"once for each of the {want} training ticks")
    for leaf in _leaves(res.params):
        if not np.isfinite(leaf).all():
            fail(f"lax n={n}: params are not finite")
    out = dict(n=n, wall_s=wall, ticks=cfg.ticks, ticks_per_s=cfg.ticks / wall,
               peak_gib=peak, launches=launches, training_ticks=want,
               honest_acc=float(acc[-1]), rep_mal=rep_mal, rep_hon=rep_hon,
               ball_rep_mal=ball_mal, ball_rep_hon=ball_hon, setup_s=t2 - t0,
               result=res)
    if profile_ticks:
        profile_lax(torch, sc, spec, topo, cfg, profile_ticks)
    return out


def profile_lax(torch, sc, spec, topo, cfg, ticks, label=None):
    """Where the vectorized engine's time goes, on fresh runs of its first
    ``ticks`` ticks (``spec`` one role sheet or a batch of them): device
    busy / idle share and top device ops from the profiler, the host's
    split by function from cProfile. Returns the profiled window's wall,
    busy and idle share."""
    import cProfile
    import dataclasses
    import pstats

    from repro_torch.chain import simlax
    from repro_torch.core.reputation import IMPL2

    short = dataclasses.replace(cfg, ticks=ticks)

    def fresh():
        sim = simlax.LaxSimulator(sc, topo, spec, IMPL2, short, device="cuda")
        return sim, sc.init_params_stacked("cuda")

    sim, p0 = fresh()
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        sim.run(p0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in measured_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    busy = sum(by_name.values())
    label = label or f"n={sc.num_nodes}"
    window = dict(wall_s=wall, busy_s=busy, idle=1 - busy / wall)
    print(f"lax profile window {label} ({ticks} ticks, profiler on): "
          f"wall {wall:.3f} s, device busy {busy:.4f} s, device idle share "
          f"{1 - busy / wall:.4f}")
    for name, sec in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  device {sec:.4f} s ({sec / busy:.3f} of busy)  {name[:90]}")
    sim, p0 = fresh()
    torch.cuda.synchronize()
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    sim.run(p0)
    torch.cuda.synchronize()
    pr.disable()
    wall = time.perf_counter() - t0
    cum = {}
    for (path, _, func), (_, _, _, ct, _) in pstats.Stats(pr).stats.items():
        key = f"{os.path.basename(path)}:{func}"
        cum[key] = cum.get(key, 0.0) + ct
    print(f"lax host window {label} ({ticks} ticks, cProfile on): wall "
          f"{wall:.3f} s; cumulative share of wall (nested entries overlap):")
    for key in ("simlax.py:_run", "simlax.py:_reduce", "simlax.py:_eval",
                "scenarios.py:eval_stacked", "simlax.py:_train_and_send",
                "scenarios.py:train_stacked", "scenarios.py:sgd_stacked",
                "attacks.py:apply", "attacks.py:attack_key_at",
                "compression.py:roundtrip_tree", "simlax.py:_items_compact",
                "scenarios.py:test_stacked", "{method 'cpu' of 'torch._C.TensorBase' objects}",
                "{method 'item' of 'torch._C.TensorBase' objects}"):
        if key in cum:
            print(f"  {key:48s} {cum[key]:8.3f} s  {cum[key] / wall:.3f}")
    return window


def time_lax_wire(torch, n, label=None):
    """K1 / K2 where the vectorized engine puts them: the stacked (n, ...)
    LeNet tree, one launch a direction."""
    from repro_torch.configs.lenet_dfl import CONFIG
    from repro_torch.models import lenet
    meta = lenet.init(torch.Generator(device="cpu"), CONFIG, "meta")
    shapes = [(n,) + tuple(x.shape) for x in _leaves(meta)]
    return time_tree(torch, label or f"stacked LeNet tree n={n}", shapes, seed=9)


# ------------------------------------------------------------ phase 12
LAX_ENGINES = ("compact", "sparse", "dense")
SWEEP_ATTACKS = ("signflip", "gaussian", "scaled", "freerider", "intermittent")
SWEEP_SEEDS = (0, 1, 2, 3)
SWEEP_SINGLES = (("signflip", 1), ("intermittent", 2), ("honest", 3))


def _hetero_specs(n, deterministic=False):
    """tests/test_batched.py's eight federations, no two alike: mixed
    attacks, a dead node, a straggler, an explicit countdown, honest
    baselines; ``deterministic`` swaps the random attacks for signflip."""
    from repro_torch.chain import attacks
    gauss = "signflip" if deterministic else "gaussian"
    inter = (attacks.make("intermittent", inner="signflip") if deterministic
             else "intermittent")
    build = attacks.FederationSpec.build
    return [
        build(n, malicious=(0,), attack=gauss),
        build(n, malicious={2: "signflip", 5: gauss}, stragglers={7: 2}),
        build(n, malicious=(1, 3), attack="scaled", dead=(n - 1,)),
        build(n),
        build(n, malicious=(4,), attack="freerider"),
        build(n, malicious=(0, 2), attack=inter,
              initial_countdown=[1 + (3 * i) % 7 for i in range(n)]),
        build(n, dead=(2, 5)),
        build(n, malicious=(6,), attack="signflip", stragglers={1: 3}),
    ]


def _member_same(a, b, what):
    """A batch member against a single run: everything ``_lax_same``
    compares, and the last broadcasts, bitwise."""
    import numpy as np
    _lax_same(a, b, what, floats="bitwise")
    for x, y in zip(_leaves(a.sent), _leaves(b.sent)):
        if not np.array_equal(x, y):
            fail(f"{what}: broadcasts differ")


def check_batched_toy(torch):
    """Phase 12a: eight heterogeneous toy federations batched on the card,
    every member bitwise its single card run on each engine; the compact
    batch on the card against the CPU."""
    from repro_torch.chain import attacks, scenarios, simlax
    from repro_torch.core import topology
    from repro_torch.core.reputation import IMPL2
    n, ticks = 16, 48
    sc, topo = scenarios.toy_scenario(n, dim=8), topology.kregular(n, 2)
    seeds = [3 * b + 1 for b in range(8)]

    def cfg(engine, seed=0, interval=(8, 12)):
        return simlax.SimLaxConfig(ticks=ticks, train_interval=interval,
                                   latency=2, ttl=2, record_every=10,
                                   seed=seed, delivery=engine)

    specs = _hetero_specs(n)
    for engine in LAX_ENGINES:
        t0 = time.perf_counter()
        batch = simlax.LaxSimulator(
            sc, topo, attacks.BatchedFederationSpec.build(specs, seeds), IMPL2,
            cfg(engine), device="cuda").run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b, (spec, seed) in enumerate(zip(specs, seeds)):
            single = simlax.LaxSimulator(sc, topo, spec, IMPL2,
                                         cfg(engine, seed), device="cuda").run()
            _member_same(batch[b], single, f"toy batch member {b} ({engine})")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"batched toy on the card, {engine}: 8 members (n {n}, {ticks} "
              f"ticks) bitwise their single card runs; batch {t1 - t0:.3f} s, "
              f"8 singles {t2 - t1:.3f} s; deliveries "
              f"{[r.stats['deliveries'] for r in batch]}")
    det = attacks.BatchedFederationSpec.build(_hetero_specs(n, True), seeds)
    runs = {dev: simlax.LaxSimulator(sc, topo, det, IMPL2,
                                     cfg("compact", interval=(8, 8)),
                                     device=dev).run()
            for dev in ("cuda", "cpu")}
    gap = max(_lax_same(a, b, f"toy batch member {i} cuda vs cpu", floats="rtol")
              for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])))
    print(f"batched toy compact, cuda vs cpu (fixed intervals, deterministic "
          f"attacks): events and reputations equal, max float gap {gap:.3e}")


def check_sgd_graph(torch):
    """The stacked SGD's CUDA-graph route (``scenarios.GRAPH_MODELS``)
    against its eager route on the card, on the paper recipe's data at 1, 2
    and 8 models (8 steps of 16 images): whether the two give the same bits,
    and the wall time a call of each by CUDA events."""
    from repro_torch import device as device_lib
    from repro_torch import tree
    from repro_torch.chain import scenarios
    sc = scenarios.lenet_paper_setup(10)[0]
    params, data = sc.init_params_stacked("cuda"), sc.train_data("cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    with device_lib.deterministic():
        for m in (1, 2, 8):
            rows = torch.arange(m, device="cuda")
            idx = torch.randint(0, data["labels"].shape[1],
                                (m, sc.train_steps, sc.batch), generator=g,
                                device="cuda")
            models = tree.map(lambda x: x[rows], params)

            def graphed():
                return sc.sgd_stacked(models, data, rows, idx)

            def eager():
                return sc._sgd_steps(models, lambda s: {
                    "images": data["images"][rows[:, None], idx[:, s]],
                    "labels": data["labels"][rows[:, None], idx[:, s]]},
                    idx.shape[1])

            a, b = graphed(), eager()
            same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(tree.leaves(a), tree.leaves(b)))
            gap = max(float((x - y).abs().max())
                      for x, y in zip(tree.leaves(a), tree.leaves(b)))
            ms = {"graph": event_ms(graphed, 20), "eager": event_ms(eager, 20)}
            out[m] = dict(bitwise=same, max_gap=gap, **ms)
            print(f"stacked SGD, {m} model(s) x {sc.train_steps} steps: graph "
                  f"{ms['graph']:.3f} ms, eager {ms['eager']:.3f} ms a call; "
                  f"graph vs eager bitwise {same} (max |diff| {gap:.3e})")
    return out


def _sweep_sheets(spec):
    """The §VI-D sweep's six role sheets on the recipe's spec: its poisoners
    under each attack, and all honest; every sheet keeps the recipe's
    initial countdown."""
    from repro_torch.chain import attacks
    sheets = {a: attacks.FederationSpec.build(
        spec.num_nodes, malicious=spec.malicious, attack=a,
        initial_countdown=spec.initial_countdown) for a in SWEEP_ATTACKS}
    sheets["honest"] = attacks.FederationSpec.build(
        spec.num_nodes, initial_countdown=spec.initial_countdown)
    return sheets


def run_lax_sweep(torch, lax10):
    """Phase 12b: the §VI-D sweep, 24 federations at full LeNet width in one
    batched run, counted; members held to their single runs (phase 10's
    among them) and the recipe's member to the JAX acceptance thresholds."""
    import dataclasses

    import numpy as np

    from repro_torch.chain import attacks, scenarios, simlax
    from repro_torch.core.reputation import IMPL2
    from repro_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    sc, spec, topo, cfg = scenarios.lenet_paper_setup(10, compress="int8")
    sheets = _sweep_sheets(spec)
    members = [(a, seed) for a in sheets for seed in SWEEP_SEEDS]
    bspec = attacks.BatchedFederationSpec.build(
        [sheets[a] for a, _ in members], [seed for _, seed in members])
    sim = simlax.LaxSimulator(sc, topo, bspec, IMPL2, cfg, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bsz = len(members)
    want = _training_ticks(spec, cfg)
    print(f"lax sweep: lenet_paper_setup(10, compress='int8') x "
          f"{len(sheets)} role sheets x seeds {list(SWEEP_SEEDS)} = {bsz} "
          f"federations in one batched run, compact engine, device=cuda")
    print(f"lax sweep run: set-up {setup:.3f} s, wall {wall:.3f} s, "
          f"{cfg.ticks / wall:.3f} ticks/s, {bsz / wall:.4f} federations/s, "
          f"peak device memory {peak:.3f} GiB")
    print(f"lax sweep launches: {json.dumps(launches, sort_keys=True)} "
          f"(training ticks {want})")
    for k in ("quantize", "dequantize"):
        if launches.get(k, 0) != want:
            fail(f"lax sweep: {k} launched {launches.get(k, 0)} times, not "
                 f"once for each of the {want} training ticks of the batch")
    recipe = members.index(("gaussian", 0))
    _member_same(res[recipe], lax10["result"], "sweep (gaussian, 0) vs phase 10")
    walls = [lax10["wall_s"]]
    for key in SWEEP_SINGLES:
        t1 = time.perf_counter()
        single = simlax.LaxSimulator(sc, topo, sheets[key[0]], IMPL2,
                                     dataclasses.replace(cfg, seed=key[1]),
                                     device="cuda").run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        _member_same(res[members.index(key)], single, f"sweep {key}")
    print(f"lax sweep: the (gaussian, 0) member is bitwise phase 10's run; "
          f"members {list(SWEEP_SINGLES)} bitwise their single card runs "
          f"(single walls {[round(w, 3) for w in walls]} s)")
    fed_s, single_fed_s = bsz / wall, len(walls) / sum(walls)
    print(f"lax sweep federations/s: batched {fed_s:.4f}, the {len(walls)} "
          f"single runs {single_fed_s:.4f} -> {fed_s / single_fed_s:.3f}x")
    mal = list(spec.malicious)
    rows = []
    for (name, seed), r in zip(members, res):
        bad = mal if name != "honest" else []
        honest = [i for i in range(spec.num_nodes) if i not in bad]
        acc = float(r.acc_history[-1][honest].mean())
        rep_p = float(np.mean([r.mean_reputation(i) for i in mal]))
        rep_h = float(np.mean([r.mean_reputation(i) for i in honest]))
        for leaf in _leaves(r.params):
            if not np.isfinite(leaf).all():
                fail(f"lax sweep ({name}, {seed}): params are not finite")
        rows.append(dict(sheet=name, seed=seed, honest_acc=acc,
                         rep_poisoners=rep_p, rep_honest=rep_h))
        print(f"  sweep member {name:12s} seed {seed}: honest acc {acc:.4f}, "
              f"reputation nodes {mal} {rep_p:.4f}, honest {rep_h:.4f}")
    g0 = rows[recipe]
    if g0["honest_acc"] < 0.90:
        fail(f"lax sweep (gaussian, 0): honest accuracy {g0['honest_acc']:.4f} < 0.90")
    if not g0["rep_poisoners"] < g0["rep_honest"] - 0.1:
        fail(f"lax sweep (gaussian, 0): poisoners' reputation "
             f"{g0['rep_poisoners']:.4f} is not below the honest "
             f"{g0['rep_honest']:.4f} by 0.1")
    window = profile_lax(torch, sc, bspec, topo, cfg, 24,
                         label=f"batch of {bsz} x n=10")
    return dict(batch=bsz, wall_s=wall, setup_s=setup, ticks=cfg.ticks,
                ticks_per_s=cfg.ticks / wall, federations_per_s=fed_s,
                single_walls_s=walls, single_federations_per_s=single_fed_s,
                peak_gib=peak, launches=launches, training_ticks=want,
                window=window, members=rows)


def run_sweep_smoke(torch):
    """Phase 12c: one ``sweeps.run_sweep`` of a small toy grid on the card
    (its default devices: every visible CUDA device), and its frontier
    tables."""
    import numpy as np

    from repro_torch.chain import simlax, sweeps
    cells = sweeps.expand_grid(sizes=[12], attacks=[None, "gaussian"],
                               seeds=[0, 1])
    cfg = simlax.SimLaxConfig(ticks=30, train_interval=(6, 8), ttl=2,
                              record_every=6)
    t0 = time.perf_counter()
    outcomes = sweeps.run_sweep(cells, cfg=cfg, target_acc=0.4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(outcomes) != len(cells) or any(
            o.stats["batch_size"] != len(cells) for o in outcomes):
        fail("run_sweep: not one batch of every cell")
    for o in outcomes:
        if not 0.0 <= o.final_honest_acc <= 1.0 or not np.isfinite(
                o.honest_reputation):
            fail(f"run_sweep: bad outcome {o.row()}")
    tables = sweeps.frontier_tables(outcomes, target_acc=0.4)
    print(f"run_sweep on the card: {len(cells)} cells (n 12, attacks none / "
          f"gaussian x seeds 0, 1) in one batch, {wall:.3f} s")
    print("run_sweep frontier tables: " + json.dumps(tables, sort_keys=True))


# ------------------------------------------------------------ phase 13
# the sharded engine and the production gossip round, over torch.distributed
SHARD_WORLDS = (2, 4)                 # ranks on cuda:0 under gloo (one card)
GOSSIP_F, GOSSIP_TTL, GOSSIP_ROUNDS = 4, 2, 10
SHARD_REL_L2 = 0.25   # S = 2 LeNet params against phase 10's, a leaf
# S = 2 LeNet against compact at tests/test_torch_sharded.py's size (n 8,
# 24 ticks), a run a seed: events, reputations and test accuracies exactly,
# params within twice the largest gap read on an H100 at these seeds
# (7.8e-3: cuDNN picks kernels by the stacked shape, so the CPU test's 1e-3
# does not hold here); a run that ignores the train rows' node ids changes
# the test accuracies and moves params by more than ten times the bound
SHARD_SMALL_SEEDS = tuple(range(8))
SHARD_SMALL_ATOL = 1.6e-2
SPAWN_TIMEOUT_S = 300


def _shard_toy_cases():
    """tests/test_sharded.py:163's case: n 16, kregular(16, 3), attackers
    (0, 5), ttl 2, 48 ticks, fixed interval 6; the wire off and int8, then
    churn. Compact configs."""
    from repro_torch.chain import scenarios, simlax
    from repro_torch.chain.attacks import FederationSpec, MembershipSchedule
    from repro_torch.core import topology
    n = 16
    sc = scenarios.toy_scenario(n, dim=8, malicious=(0, 5))
    topo = topology.kregular(n, 3)
    cd = [3 + (7 * i) % 6 for i in range(n)]

    def cfg(compress=None):
        return simlax.SimLaxConfig(ticks=48, train_interval=(6, 6), latency=1,
                                   ttl=2, record_every=8, seed=0,
                                   compress=compress)

    ms = MembershipSchedule.build(
        [(7, (), (3, 11)), (19, (3,), ()), (29, (11,), ()), (37, (), (6,))],
        rejoin_decay=0.5, initial_offline=(9,))
    return [(sc, topo, FederationSpec.build(n, malicious=(0, 5),
                                            initial_countdown=cd), cfg(c))
            for c in (None, "int8")] + [
        (sc, topo, FederationSpec.build(n, malicious=(0, 5),
                                        initial_countdown=cd, membership=ms),
         cfg())]


def _shard_lenet_small(seed=0):
    """tests/test_torch_sharded.py's LeNet case: n 8, node 0 poisoning,
    kregular(8, 2), 24 ticks, one SGD step of batch 8 a training. Compact
    config."""
    from repro_torch.chain import scenarios, simlax
    from repro_torch.chain.attacks import FederationSpec
    from repro_torch.core import topology
    n, interval = 8, 6
    sc = scenarios.lenet_scenario(n, malicious=(0,), pool=32, eval_size=8,
                                  test_size=32, train_steps=1, batch=8)
    spec = FederationSpec.build(
        n, malicious=(0,),
        initial_countdown=[3 + (7 * i) % interval for i in range(n)])
    cfg = simlax.SimLaxConfig(ticks=24, train_interval=(interval, interval),
                              latency=1, ttl=2, record_every=8, seed=seed)
    return sc, topology.kregular(n, 2), spec, cfg


def _same_events(a, b, what):
    """Two LeNet runs of one schedule: the event counts, per-node broadcasts
    and the integer final state exactly."""
    import numpy as np
    for k in LAX_STATS:
        if a.stats[k] != b.stats[k]:
            fail(f"{what}: stats[{k}] {a.stats[k]} != {b.stats[k]}")
    if not np.array_equal(a.stats["broadcasts_per_node"],
                          b.stats["broadcasts_per_node"]):
        fail(f"{what}: broadcasts per node differ")
    for k in ("arrive", "buf_cnt", "next_train"):
        if not np.array_equal(a.final_state[k], b.final_state[k]):
            fail(f"{what}: final {k} differs")


def _sharded(cfg):
    import dataclasses
    return dataclasses.replace(cfg, delivery="sharded")


def _run_toy_cases(device, sharded):
    from repro_torch.chain import simlax
    from repro_torch.core.reputation import IMPL2
    return [simlax.LaxSimulator(sc, topo, spec, IMPL2,
                                _sharded(cfg) if sharded else cfg,
                                device=device).run()
            for sc, topo, spec, cfg in _shard_toy_cases()]


def _all_ranks(obj):
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _lenet_sharded(torch, device):
    """``lenet_paper_setup(10, "int8")`` on the sharded engine, counted and
    timed on this process: (result, wall s, launches, exchange counters)."""
    from repro_torch.chain import scenarios, simlax
    from repro_torch.core import gossip
    from repro_torch.core.reputation import IMPL2
    from repro_torch.kernels import LAUNCHES, reset_launches
    sc, spec, topo, cfg = scenarios.lenet_paper_setup(10, compress="int8")
    sim = simlax.LaxSimulator(sc, topo, spec, IMPL2, _sharded(cfg),
                              device=device)
    params0 = sc.init_params_stacked(device)
    torch.cuda.synchronize()
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
    reset_launches()
    gossip.reset_wire()
    t0 = time.perf_counter()
    res = sim.run(params0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, dict(LAUNCHES), dict(gossip.WIRE)


def _gossip_nodes(torch, device):
    """Phase 13c's federation: F LeNet-5 models at full width (each from its
    own seed), each node's own eval set (64 images of its Dirichlet shard)
    and reputation rows in [0.5, 1]."""
    import numpy as np

    from repro_torch.chain import scenarios
    from repro_torch.configs.lenet_dfl import CONFIG
    from repro_torch.models import lenet
    sc = scenarios.lenet_scenario(GOSSIP_F, pool=8, eval_size=64,
                                  test_size=8, train_steps=0)
    params = [lenet.init(torch.Generator(device=device).manual_seed(100 + i),
                         CONFIG, device) for i in range(GOSSIP_F)]
    vbs = [{"images": torch.as_tensor(sc.eval_images[i], device=device),
            "labels": torch.as_tensor(sc.eval_labels[i], device=device)}
           for i in range(GOSSIP_F)]
    rep = np.random.RandomState(5).uniform(0.5, 1.0, (GOSSIP_F, GOSSIP_F))
    return params, vbs, torch.as_tensor(rep.astype(np.float32), device=device)


def _receipt(params, vb):
    from repro_torch.models import lenet
    return lenet.accuracy(params, vb["images"], vb["labels"])


def _gossip_rank(torch, rank, device):
    """Phase 13c on one rank: the round at F = 4 in fp32 and int8 (the
    checked round, one counted round, then GOSSIP_ROUNDS timed ones)."""
    from repro_torch import convert
    from repro_torch.core import gossip, topology
    from repro_torch.core.reputation import IMPL2
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_fed_mesh(GOSSIP_F)
    params, vbs, rep = _gossip_nodes(torch, device)
    out = {}
    for comp in (None, "int8"):
        round_ = gossip.make_gossip_round(
            _receipt, fed_size=GOSSIP_F, ttl=GOSSIP_TTL, rep_impl=IMPL2,
            compress=comp, mesh=mesh, topology=topology.ring(GOSSIP_F))
        new, new_rep, met = round_(params[rank], rep[rank], vbs[rank])
        torch.cuda.synchronize()
        reset_launches()
        gossip.reset_wire()
        round_(params[rank], rep[rank], vbs[rank])
        torch.cuda.synchronize()
        launches, wire = dict(LAUNCHES), dict(gossip.WIRE)
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(GOSSIP_ROUNDS):
            round_(params[rank], rep[rank], vbs[rank])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / GOSSIP_ROUNDS * 1e3
        out[comp] = dict(params=convert.params_to_numpy(new),
                         rep=new_rep.cpu().numpy(),
                         metrics={k: float(v) for k, v in met.items()},
                         launches=launches, wire=wire, ms=ms)
    return out


def _shard_rank(rank, device, world):
    """One rank of phase 13b (and 13c at 4 ranks); ``spawn``'s target."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"transport": f"{torch.distributed.get_backend()}, {world} ranks on "
                        f"{device}",
           "toy": _run_toy_cases(device, sharded=True)}
    if world == 2:
        from repro_torch.chain import simlax
        from repro_torch.core.reputation import IMPL2
        out["lenet_small"] = []
        for seed in SHARD_SMALL_SEEDS:
            sc, topo, spec, cfg = _shard_lenet_small(seed)
            out["lenet_small"].append(simlax.LaxSimulator(
                sc, topo, spec, IMPL2, _sharded(cfg), device=device).run())
        res, wall, launches, wire = _lenet_sharded(torch, device)
        out["lenet"] = res
        out["lenet_ranks"] = _all_ranks(dict(wall=wall, launches=launches,
                                             wire=wire))
    if world == GOSSIP_F:
        out["gossip"] = _all_ranks(_gossip_rank(torch, rank, device))
    return out


def _same_toy(ref, got, what):
    for i, (a, b) in enumerate(zip(ref, got)):
        if a.stats["deliveries"] <= 0:
            fail(f"{what} case {i}: no deliveries")
        _member_same(a, b, f"{what} case {i}")


def _gossip_oracle(torch, comp):
    """Each node's round in one process on the card, as the paper states
    it: every in-ball sender's model (through the int8 round trip with
    ``comp``) weighted by reputation x the receiver's receipt, Eq. 3 in
    float64, the lowest receipt(s) punished. Returns (params a node as
    float64 leaves, reputation rows, receipts received a node)."""
    import numpy as np

    from repro_torch.core import compression, topology
    from repro_torch.core.reputation import IMPL2
    params, vbs, rep = _gossip_nodes(torch, "cuda")
    topo = topology.ring(GOSSIP_F)
    dist = topo.hop_distance()
    sent = [compression.roundtrip_tree(p) if comp else p for p in params]
    out_p, out_r, received = [], [], []
    for i in range(GOSSIP_F):
        ball = [j for j in range(GOSSIP_F) if 1 <= dist[i, j] <= GOSSIP_TTL]
        acc = torch.stack([_receipt(sent[j], vbs[i]).float() for j in ball])
        w = (rep[i, ball] * acc).double().cpu().numpy()
        models = [[x.double().cpu().numpy() for x in _leaves(sent[j])]
                  for j in ball]
        own = [x.double().cpu().numpy() for x in _leaves(params[i])]
        out_p.append([0.5 * (sum(wk * m[k] for wk, m in zip(w, models)) / w.sum()
                             + own[k]) for k in range(len(own))])
        out_r.append(IMPL2.update_row(rep[i], torch.tensor(ball, device="cuda"),
                                      acc).cpu().numpy())
        received.append(len(ball))
    return out_p, out_r, received


def run_sharded_and_gossip(torch, lax10_result, lax10_wall):
    """Phase 13: (a) the sharded engine in process (S = 1) on the card; (b)
    S = 2 and 4 ranks on cuda:0 under gloo; (c) the production gossip round
    at F = 4 on the 4 ranks. Returns the launch counts and numbers for the
    report."""
    import numpy as np

    from repro_torch.chain import scenarios, simlax
    from repro_torch.core import compression, topology
    from repro_torch.core.reputation import IMPL2
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    # (a) one shard, in process
    compact_toy = _run_toy_cases("cuda", sharded=False)
    _same_toy(compact_toy, _run_toy_cases("cuda", sharded=True),
              "sharded S=1 toy vs compact")
    s1, s1_wall, s1_launches, _ = _lenet_sharded(torch, "cuda")
    _member_same(lax10_result, s1, "sharded S=1 lenet vs phase 10")
    if s1.stats["shards"] != 1:
        fail("sharded S=1: stats say another shard count")
    _, spec, _, cfg = scenarios.lenet_paper_setup(10)
    want = _training_ticks(spec, cfg)
    for k in ("quantize", "dequantize"):
        if s1_launches.get(k, 0) != want:
            fail(f"sharded S=1: {k} launched {s1_launches.get(k, 0)} times, "
                 f"not once for each of the {want} training ticks")
    print(f"sharded S=1 on the card: the toy cases (None, int8, churn) bitwise "
          f"compact; lenet_paper_setup(10, 'int8') bitwise phase 10's compact "
          f"run; wall {s1_wall:.3f} s for 108 ticks (phase 10 compact "
          f"{lax10_wall:.3f} s); launches {json.dumps(s1_launches, sort_keys=True)}")

    # (b, c) ranks on the one card, gloo
    spawned = {}
    for world in SHARD_WORLDS:
        t0 = time.perf_counter()
        spawned[world] = mesh_lib.spawn(_shard_rank, world, device="cuda:0",
                                        backend="gloo", timeout=SPAWN_TIMEOUT_S,
                                        args=(world,))
        print(f"spawn of {world} ranks: {time.perf_counter() - t0:.3f} s "
              f"(start, CUDA init, the cases); transport "
              f"{spawned[world]['transport']}, exchanges staged through host "
              "memory")
        _same_toy(compact_toy, spawned[world]["toy"],
                  f"sharded S={world} toy vs compact")
        print(f"sharded S={world} toy cases (None, int8, churn): bitwise the "
              "compact engine on the card")

    # LeNet at S = 2, first at the CPU test's size against compact on the card
    gaps8 = []
    for seed, s8 in zip(SHARD_SMALL_SEEDS, spawned[2]["lenet_small"]):
        what = f"sharded S=2 lenet n=8 seed {seed} vs compact"
        sc8, topo8, spec8, cfg8 = _shard_lenet_small(seed)
        c8 = simlax.LaxSimulator(sc8, topo8, spec8, IMPL2, cfg8,
                                 device="cuda").run()
        if c8.stats["deliveries"] <= 0:
            fail(f"{what}: no deliveries")
        _same_events(c8, s8, what)
        if not np.array_equal(c8.reputation, s8.reputation):
            fail(f"{what}: reputations differ")
        if not np.array_equal(c8.acc_history, s8.acc_history):
            fail(f"{what}: test accuracies differ")
        gaps8.append(max(float(np.abs(x - y).max())
                         for x, y in zip(_leaves(c8.params), _leaves(s8.params))))
        if not gaps8[-1] <= SHARD_SMALL_ATOL:
            fail(f"{what}: params differ by {gaps8[-1]:.3e} > "
                 f"{SHARD_SMALL_ATOL}")
    print(f"sharded S=2 lenet n=8, 24 ticks (the CPU test's case), seeds "
          f"{list(SHARD_SMALL_SEEDS)}: events, reputations and test "
          f"accuracies equal compact's on the card; params max |diff| "
          f"{[float(f'{g:.4e}') for g in gaps8]} (bound {SHARD_SMALL_ATOL})")

    s2, ranks = spawned[2]["lenet"], spawned[2]["lenet_ranks"]
    _same_events(lax10_result, s2, "sharded S=2 lenet vs phase 10")
    rel = [float(np.linalg.norm(a - b) / np.linalg.norm(a))
           for a, b in zip(_leaves(lax10_result.params), _leaves(s2.params))]
    bitwise = all(np.array_equal(a, b) for a, b in zip(
        _leaves(lax10_result.params), _leaves(s2.params)))
    if max(rel) > SHARD_REL_L2 or not all(
            np.isfinite(x).all() for x in _leaves(s2.params)):
        fail(f"sharded S=2 lenet: params' relative L2 distance from phase "
             f"10's {max(rel):.4f} > {SHARD_REL_L2}")
    mal = list(spec.malicious)
    honest = [i for i in range(10) if i not in mal]
    acc = float(s2.acc_history[-1][honest].mean())
    rep_mal = float(np.mean([s2.mean_reputation(i) for i in mal]))
    rep_hon = float(np.mean([s2.mean_reputation(i) for i in honest]))
    if acc < 0.90:
        fail(f"sharded S=2 lenet: honest accuracy {acc:.4f} < 0.90")
    if not rep_mal < rep_hon:
        fail(f"sharded S=2 lenet: poisoners' reputation {rep_mal:.4f} is not "
             f"below the honest {rep_hon:.4f}")
    s2_launches = {k: sum(r["launches"].get(k, 0) for r in ranks)
                   for k in ("quantize", "dequantize")}
    if min(s2_launches.values()) <= 0:
        fail("sharded S=2 lenet: the wire kernels were not launched")
    walls = [r["wall"] for r in ranks]
    share = [r["wire"].get("seconds", 0.0) / r["wall"] for r in ranks]
    per_tick = [r["wire"].get("bytes", 0) / cfg.ticks for r in ranks]
    print(f"sharded S=2 lenet_paper_setup(10, 'int8'): events, schedule and "
          f"broadcasts equal phase 10's; params bitwise {bitwise}, relative L2 "
          f"a leaf max {max(rel):.4e} (bound {SHARD_REL_L2}); honest accuracy "
          f"{acc:.4f}, reputation poisoners {rep_mal:.4f} < honest "
          f"{rep_hon:.4f}")
    print(f"sharded S=2 timing (gloo, host-staged, {cfg.ticks} ticks): wall a "
          f"rank {[round(w, 3) for w in walls]} s; exchange share of the wall "
          f"{[round(x, 4) for x in share]}; exchanges a rank "
          f"{[r['wire'].get('messages', 0) for r in ranks]}; bytes sent a tick "
          f"a rank {[round(b, 1) for b in per_tick]}; launches "
          f"{json.dumps(s2_launches, sort_keys=True)} summed over ranks "
          f"(training ticks {want})")

    # (c) the production round, F = 4 ranks, LeNet-5 at full width
    ranks4 = spawned[GOSSIP_F]["gossip"]
    nodes = _gossip_nodes(torch, "cuda")[0]
    # every rank sends in every step of the ring's schedule
    steps = topology.gossip_schedule(topology.ring(GOSSIP_F),
                                     GOSSIP_TTL).num_collectives
    gossip_out = {}
    for comp in (None, "int8"):
        want_p, want_r, want_n = _gossip_oracle(torch, comp)
        gap = 0.0
        for i, r in enumerate(ranks4):
            got = r[comp]
            for x, y in zip(_leaves(got["params"]), want_p[i]):
                if not np.allclose(x, y, rtol=1e-5, atol=1e-7):
                    fail(f"gossip round ({comp}): node {i}'s params differ "
                         "from the oracle")
                gap = max(gap, float(np.abs(x - y).max()))
            if not np.array_equal(got["rep"], want_r[i]):
                fail(f"gossip round ({comp}): node {i}'s reputation row "
                     f"{got['rep']} != the oracle's {want_r[i]}")
            if got["metrics"]["models_received"] != want_n[i]:
                fail(f"gossip round ({comp}): node {i} received "
                     f"{got['metrics']['models_received']} models, not {want_n[i]}")
        payload = compression.payload_bytes(nodes[0], comp)
        for i, r in enumerate(ranks4):
            if (r[comp]["wire"]["bytes"] != steps * payload
                    or r[comp]["wire"]["messages"] != steps):
                fail(f"gossip round ({comp}): rank {i} sent "
                     f"{r[comp]['wire']['bytes']} bytes, not {steps} x {payload}")
        k1 = sum(r[comp]["launches"].get("quantize", 0) for r in ranks4)
        k2 = sum(r[comp]["launches"].get("dequantize", 0) for r in ranks4)
        if comp == "int8" and (k1 != GOSSIP_F or k2 != sum(want_n)):
            fail(f"gossip round (int8): {k1} quantize / {k2} dequantize "
                 f"launches a round, not {GOSSIP_F} / {sum(want_n)}")
        ms = [r[comp]["ms"] for r in ranks4]
        wire_ms = [r[comp]["wire"]["seconds"] * 1e3 for r in ranks4]
        gossip_out[comp or "fp32"] = dict(
            ms_per_round=max(ms), ms_by_rank=ms, exchange_ms_by_rank=wire_ms,
            payload_bytes=payload,
            bytes_per_round_a_rank=steps * payload, messages_a_rank=steps,
            quantize_a_round=k1, dequantize_a_round=k2, max_abs_gap=gap)
        print(f"gossip round F={GOSSIP_F} ({comp or 'fp32'}), ring ttl "
              f"{GOSSIP_TTL}, LeNet-5: params within rtol 1e-5 of the oracle "
              f"(max |diff| {gap:.3e}), reputations exact; {steps} messages of "
              f"{payload} B a rank a round; {max(ms):.3f} ms a round (slowest "
              f"rank; {[round(x, 3) for x in ms]}), of which the exchanges "
              f"{[round(x, 3) for x in wire_ms]} ms (the counted round); "
              f"launches a round over the ranks: quantize {k1}, dequantize {k2}")
    ratio = gossip_out["int8"]["payload_bytes"] / gossip_out["fp32"]["payload_bytes"]
    print(f"gossip wire: int8 payload {ratio:.4f} of fp32's; phase 13 took "
          f"{time.perf_counter() - t_phase:.3f} s")
    return dict(s1_wall_s=s1_wall, s1_launches=s1_launches,
                s2_walls_s=walls, s2_exchange_share=share,
                s2_bytes_a_tick=per_tick, s2_launches=s2_launches,
                s2_rel_l2_max=max(rel), s2_bitwise=bitwise, s2_honest_acc=acc,
                s2_small_max_abs=gaps8,
                s2_rep_mal=rep_mal, s2_rep_hon=rep_hon, gossip=gossip_out,
                transport=spawned[2]["transport"])


# ------------------------------------------------------------ phase 14
# LM training and the federated LM launcher, llama3-8b at full width
# (d_model 4096, 32 heads, KV 8, d_ff 14336, vocab 128 256), depth cut
TRAIN_DEPTH = 4          # of 32: 1.92 B params, ~29 GiB of fp32 params + AdamW
TRAIN_ARGS = ["--arch", "llama3-8b", "--steps", "6", "--batch", "2", "--seq",
              "4096", "--device", "cuda"]   # train_4k's length, B cut from 256
TRAIN_FLASH_A_STEP = 2 * TRAIN_DEPTH          # forward + remat recompute a layer
CHECK_SHAPE = (1, 1, 1024)        # depth, B, S of the kernels-vs-plain step
CHECK_LOSS_TOL = 2e-2
# each grad leaf's relative L2 distance, kernels vs plain route (the plain
# route's backward is autograd through attention_ref in fp32; the flash
# backward rounds p, dout and ds to bf16, as the JAX one does): twice the
# largest read on an H100 (9.2e-3, the embedding table; median 7.5e-3)
CHECK_GRAD_TOL = 2e-2
DFL_F = 2                # two full-width nodes on one 80 GB card (~20 GiB each)
DFL_ARGS = ["--arch", "llama3-8b", "--dfl", "--fed", str(DFL_F), "--rounds", "2",
            "--local-steps", "2", "--ttl", "1", "--batch", "1", "--seq", "1024",
            "--compress", "int8", "--device", "cuda:0", "--backend", "gloo",
            "--timeout", "900"]
ELASTIC_ARGS = ["--arch", "llama3-8b", "--smoke", "--dfl", "--fed", "4",
                "--fail-node", "1@2", "--rounds", "4", "--local-steps", "1",
                "--batch", "2", "--seq", "64", "--device", "cuda:0",
                "--backend", "gloo", "--timeout", "600"]
# (name, B, S, H, KH, Dh, causal, window, dtype, route): the training
# forward's heads (sm90), a windowed case, the simt kernel in fp32 at
# Dh 16 (ragged) and in bf16 on views 8 bytes off alignment
LSE_CASES = (
    ("train S=4096 causal", 2, 4096, 32, 8, 128, True, 0, "bfloat16", "sm90"),
    ("train S=4096 w=512", 1, 4096, 32, 8, 128, True, 512, "bfloat16", "sm90"),
    ("simt S=1000 Dh=16", 2, 1000, 4, 2, 16, True, 0, "float32", "simt"),
    ("simt view S=1024", 1, 1024, 32, 8, 128, True, 0, "bfloat16", "simt"))
# absolute, on log-sum-exps of ~5-10: ten times the largest read on an H100
# (1.9e-6, sm90; simt 9.5e-7)
LSE_TOL = 2e-5
# the flash backward against autograd through attention_ref: relative L2 a
# grad (bf16 rounding of p, dout and ds); read on an H100: <= 2.8e-3 in
# bf16, <= 3.9e-3 in fp32
BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-2}


def _depth(n):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3-8b"), num_layers=n)


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def check_flash_training(torch):
    """Phase 14b: both flash kernels' lse (and output) against
    attention_ref's, and the recompute backward (through the model's
    autograd Function) against autograd through attention_ref, on the
    card; each route read from the launch counters. Returns the worst
    errors by route."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import flash as flash_model
    g = torch.Generator(device="cuda").manual_seed(14)
    worst = {}
    for name, B, S, H, KH, Dh, causal, window, dtype, route in LSE_CASES:
        dt = getattr(torch, dtype)
        q, k, v = _qkv(torch, g, B, S, H, KH, Dh, dt)
        if route == "simt" and dtype == "bfloat16":
            q, k, v = (_simt_view(torch, x) for x in (q, k, v))
        (out, lse), used = _flash_route(torch, q, k, v, causal=causal,
                                        window=window, return_lse=True)
        if used != route:
            fail(f"flash lse {name} ran the {used} kernel, not {route}")
        want, want_lse = attention_ref(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        out_err = float((out.float() - want.float()).abs().max())
        lse_err = float((lse - want_lse).abs().max())
        if out_err > FLASH_TOL[dtype] or lse_err > LSE_TOL:
            fail(f"flash {route} {name}: output |diff| {out_err:.3e}, lse "
                 f"|diff| {lse_err:.3e} (limits {FLASH_TOL[dtype]}, {LSE_TOL})")
        del out, lse, want, want_lse
        # the backward: the model's Function (kernel forward + recompute
        # backward) against autograd through the plain version
        dout = torch.randn((B, S, H, Dh), generator=g, device="cuda").to(dt)
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        qg = leaves[0].reshape(B, S, KH, H // KH, Dh)
        flash_model.flash_attention_padded(qg, leaves[1], leaves[2], causal,
                                           window).reshape(B, S, H, Dh).backward(dout)
        refs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        attention_ref(*refs, causal=causal, window=window).backward(dout)
        bwd = [_rel_l2(a.grad, b.grad) for a, b in zip(leaves, refs)]
        if max(bwd) > BWD_TOL[dtype] or not all(
                bool(torch.isfinite(a.grad).all()) for a in leaves):
            fail(f"flash backward {name}: grads' relative L2 {bwd} > "
                 f"{BWD_TOL[dtype]}")
        worst[route] = max(worst.get(route, 0.0), out_err, lse_err)
        print(f"flash {route} {name:22s} {dtype:8s} B={B} H={H} KH={KH} Dh={Dh}: "
              f"max |out - plain| {out_err:.3e}, max |lse - plain| {lse_err:.3e} "
              f"(limit {LSE_TOL}); backward vs autograd through the plain "
              f"version: relative L2 dq/dk/dv {[float(f'{x:.3e}') for x in bwd]} "
              f"(limit {BWD_TOL[dtype]}) OK")
        del q, k, v, dout, leaves, refs, qg
        torch.cuda.empty_cache()
    return worst


def time_flash_training(torch, B, S, H, KH, Dh):
    """Phase 14b's times at the training shape: the sm90 forward without
    and with the lse (the new output's cost), cuDNN's forward and the plain
    version (``time_flash_backward`` times the backward). Returns the lse
    row for the JSON line."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device="cuda").manual_seed(15)
    q, k, v = _qkv(torch, g, B, S, H, KH, Dh, torch.bfloat16)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    want, want_lse = attention_ref(q, k, v, return_lse=True)
    err = max(float((out.float() - want.float()).abs().max()),
              float((lse - want_lse).abs().max()))
    del want, want_lse
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = {}
    for label, fn, iters in (
            ("no_lse", lambda: ops.flash_attention(q, k, v), 20),
            ("lse", lambda: ops.flash_attention(q, k, v, return_lse=True), 20),
            ("library", lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 20),
            ("plain", lambda: attention_ref(q, k, v, return_lse=True), 3)):
        ms[label], method, _ = device_ms(fn, iters)
        ms[label + "_method"] = method
    ops_count = 4 * Dh * _flash_pairs(S, 0) * B * H
    nbytes = 2 * (2 * B * S * H * Dh + 2 * B * S * KH * Dh) + 4 * B * H * S
    b_ms, b_by = bound_ms(nbytes, ops_count, BF16_OPS_PER_S)
    shape = f"B={B} S={S} H={H} KH={KH} Dh={Dh} bfloat16 causal"
    print(f"time flash sm90 training forward {shape}: no lse {ms['no_lse']:.5f} ms, "
          f"with lse {ms['lse']:.5f} ms ({(ms['lse'] / ms['no_lse'] - 1) * 100:+.2f}%), "
          f"cuDNN {ms['library']:.5f} ms, plain {ms['plain']:.5f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}); {ops_count / ms['lse'] / 1e9:.2f} TFLOP/s, "
          f"{b_ms / ms['lse']:.4f} of the bound [{ms['lse_method']}]")
    row = dict(ms=ms["lse"], plain_ms=ms["plain"], library_ms=ms["library"],
               bound_ms=b_ms, bound_by=b_by, max_abs_err=err, shape=shape,
               no_lse_ms=ms["no_lse"],
               timing=f"{ms['lse_method']}/{ms['plain_method']}/{ms['library_method']}")
    del q, k, v, out, lse, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def time_flash_backward(torch, B, S, H, KH, Dh):
    """Phase 14b: the sm90 backward kernel (``ops.flash_attention_backward``)
    at a causal bf16 training shape against the plain recompute backward on
    the same inputs and lse and against a second call of itself (bitwise),
    then timed beside its bound (the five products,
    2.5 x the forward's FLOPs), the plain backward and the library
    yardstick, cuDNN's backward alone through scaled_dot_product_attention
    (timed here, never called by the port). Returns its row."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_backward
    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v = _qkv(torch, g, B, S, H, KH, Dh, torch.bfloat16)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    dout = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
    shape = f"B={B} S={S} H={H} KH={KH} Dh={Dh} bfloat16 causal"

    def kernel():
        return ops.flash_attention_backward(q, k, v, out, lse, dout, causal=True,
                                            window=0)

    def plain():
        return flash_backward(q, k, v, out, lse, dout, causal=True, window=0)

    reset_launches()
    got = kernel()
    torch.cuda.synchronize()
    if dict(LAUNCHES) != {"flash_attention_bwd_sm90": 1}:
        fail(f"flash backward at {shape}: launches {dict(LAUNCHES)}, not one sm90")
    # its sums across blocks run in a fixed order: the same bits each call
    if not all(torch.equal(a, b) for a, b in zip(kernel(), got)):
        fail(f"flash backward sm90 at {shape}: two calls differ")
    want = plain()
    rel = [_rel_l2(a, b) for a, b in zip(got, want)]
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    if max(rel) > BWD_TOL["bfloat16"]:
        fail(f"flash backward sm90 at {shape}: relative L2 dq/dk/dv {rel} > "
             f"{BWD_TOL['bfloat16']}")
    del got, want
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qr, kr, vr = (x.transpose(1, 2).detach().clone().requires_grad_(True)
                  for x in (q, k, v))
    o = sdpa(qr, kr, vr, is_causal=True, enable_gqa=True)
    dot = dout.transpose(1, 2)
    ms = {}
    for label, fn, iters in (
            ("kernel", kernel, 20),
            ("library", lambda: torch.autograd.grad(o, (qr, kr, vr), dot,
                                                    retain_graph=True), 20),
            ("plain", plain, 3)):
        ms[label], ms[label + "_method"], _ = device_ms(fn, iters)
    ops_count = 2.5 * 4 * Dh * _flash_pairs(S, 0) * B * H
    nbytes = 2 * (4 * B * S * H * Dh + 4 * B * S * KH * Dh) + 4 * B * H * S
    b_ms, b_by = bound_ms(nbytes, ops_count, BF16_OPS_PER_S)
    print(f"time flash backward sm90 {shape}: kernel {ms['kernel']:.5f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}), {b_ms / ms['kernel']:.4f} of the bound, "
          f"{ops_count / ms['kernel'] / 1e9:.2f} TFLOP/s; plain recompute "
          f"{ms['plain']:.4f} ms; cuDNN backward {ms['library']:.5f} ms; relative L2 "
          f"dq/dk/dv {[float(f'{x:.3e}') for x in rel]} (limit {BWD_TOL['bfloat16']}) "
          f"[{ms['kernel_method']}/{ms['plain_method']}/{ms['library_method']}]")
    del q, k, v, out, lse, dout, qr, kr, vr, o, dot
    torch.cuda.empty_cache()
    return dict(ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, max_rel_l2=max(rel),
                shape=shape, timing=f"{ms['kernel_method']}/{ms['plain_method']}/"
                                    f"{ms['library_method']}")


def time_simt_lse(torch):
    """The simt kernel with the lse at phase 14d's shape (smoke_config
    llama3-8b, B 2 x S 64, bf16 activations, Dh 16): its row."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    cfg = smoke_config("llama3-8b")
    B, S, H, KH, Dh = 2, 64, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(16)
    q, k, v = _qkv(torch, g, B, S, H, KH, Dh, torch.bfloat16)
    (out, lse), used = _flash_route(torch, q, k, v, return_lse=True)
    want, want_lse = attention_ref(q, k, v, return_lse=True)
    err = max(float((out.float() - want.float()).abs().max()),
              float((lse - want_lse).abs().max()))
    if used != "simt" or err > FLASH_TOL["bfloat16"]:
        fail(f"simt lse at the elastic run's shape: route {used}, error {err}")
    ms, method, _ = device_ms(lambda: ops.flash_attention(q, k, v, return_lse=True),
                              200)
    plain_ms, plain_method, _ = device_ms(
        lambda: attention_ref(q, k, v, return_lse=True), 200)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms, lib_method, _ = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 200)
    ops_count = 4 * Dh * _flash_pairs(S, 0) * B * H
    nbytes = 2 * (2 * B * S * H * Dh + 2 * B * S * KH * Dh) + 4 * B * H * S
    b_ms, b_by = bound_ms(nbytes, ops_count, BF16_OPS_PER_S)
    shape = f"B={B} S={S} H={H} KH={KH} Dh={Dh} bfloat16 causal"
    print(f"time flash simt with lse {shape}: kernel_ms={ms:.5f} plain_ms="
          f"{plain_ms:.5f} library_ms={lib_ms:.5f} bound_ms={b_ms:.7f} ({b_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err, shape=shape,
                timing=f"{method}/{plain_method}/{lib_method}")


def time_lm_wire(torch):
    """Both wire kernels at the depth-1 llama3-8b tree (1.27 B fp32
    elements, the federation's payload) and at the sharded engine's
    stacked (5, ...) LeNet trainers' tree (rows 1s/2s)."""
    from repro_torch import tree
    from repro_torch.configs.lenet_dfl import CONFIG
    from repro_torch.models import lenet, transformer
    meta = transformer.init(torch.Generator(), _depth(1), "meta")
    lm = time_tree(torch, "llama3-8b depth-1 tree", [tuple(x.shape) for x in
                                                     tree.leaves(meta)], seed=17)
    lenet_shapes = [tuple(x.shape) for x in tree.leaves(
        lenet.init(torch.Generator(), CONFIG, "cpu"))]
    sharded = time_tree(torch, "sharded (5, ...) LeNet trainers' tree",
                        [(5, *s) for s in lenet_shapes], seed=18)
    return lm, sharded


def check_train_kernels_vs_plain(torch):
    """Phase 14a's check: one step's loss and grads at depth 1, B 1 x S
    1024 through the kernels (forward with lse, recompute backward) and
    with the attention forced through the plain version (autograd through
    attention_ref) from the same params and batch."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import flash as flash_model
    from repro_torch.train import step as step_lib
    depth, B, S = CHECK_SHAPE
    cfg = _depth(depth)
    state = step_lib.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(3),
                                      device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in TokenPipeline(cfg.vocab_size, B, S).batch_at(0).items()}
    reset_launches()
    loss_k, _, grads_k = step_lib.loss_and_grads(state["params"], cfg, batch)
    torch.cuda.synchronize()
    kernel_launches = dict(LAUNCHES)
    reset_launches()
    with flash_model.plain_route():
        loss_p, _, grads_p = step_lib.loss_and_grads(state["params"], cfg, batch)
    torch.cuda.synchronize()
    if (kernel_launches.get("flash_attention_sm90", 0) != 2 * depth
            or kernel_launches.get("flash_attention_bwd_sm90", 0) != depth
            or kernel_launches.get("flash_backward_plain", 0) or LAUNCHES):
        fail(f"kernels-vs-plain step: launches {kernel_launches} with the "
             f"kernels, {dict(LAUNCHES)} on the plain route")
    gap = abs(float(loss_k) - float(loss_p))
    names = ["/".join(map(str, p)) for p in _tree_paths(state["params"])]
    rel = {n: _rel_l2(a, b) for n, a, b in zip(names, tree.leaves(grads_k),
                                               tree.leaves(grads_p))}
    worst = max(rel, key=rel.get)
    print(f"train step kernels vs plain route (llama3-8b depth {depth}, B {B} x "
          f"S {S}, full width): loss {float(loss_k):.6f} vs {float(loss_p):.6f} "
          f"(|diff| {gap:.3e}, limit {CHECK_LOSS_TOL}); grads' relative L2 a "
          f"leaf: max {rel[worst]:.4e} ({worst}), median "
          f"{float(np.median(list(rel.values()))):.4e} (limit {CHECK_GRAD_TOL})")
    if gap > CHECK_LOSS_TOL or rel[worst] > CHECK_GRAD_TOL:
        fail("the training step through the kernels disagrees with the plain route")
    del state, grads_k, grads_p
    torch.cuda.empty_cache()
    return dict(loss_gap=gap, grad_rel_l2_max=rel[worst], grad_rel_l2=rel)


def _tree_paths(t, prefix=()):
    if isinstance(t, dict):
        return [p for k in sorted(t) for p in _tree_paths(t[k], prefix + (k,))]
    if isinstance(t, (list, tuple)):
        return [p for i, v in enumerate(t) for p in _tree_paths(v, prefix + (i,))]
    return [prefix]


def run_lm_training(torch):
    """Phase 14a: the launcher's run_plain at llama3-8b full width, depth
    TRAIN_DEPTH, B 2 x S 4096, 6 AdamW steps with remat full, counted; then
    one more step under the profiler."""
    from repro_torch import tree
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers
    from repro_torch.train import step as step_lib
    args = launch_train.parse_args(TRAIN_ARGS)
    cfg = _depth(TRAIN_DEPTH)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, history = launch_train.run_plain(args, cfg, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for h in history:
        print(f"lm train step {h['step']}: loss {h['loss']:.5f} acc "
              f"{h['accuracy']:.4f} grad_norm {h['grad_norm']:.5f} wall "
              f"{h['seconds']:.4f} s")
    steps = len(history)
    after_first = sum(h["seconds"] for h in history[1:]) / (steps - 1)
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"lm train (llama3-8b depth {TRAIN_DEPTH}, full width, B {args.batch} x "
          f"S {args.seq}, remat {cfg.remat}): {steps} steps in {wall:.3f} s, "
          f"{after_first:.4f} s a step after the first "
          f"({args.batch * args.seq / after_first:.1f} tokens/s); peak device "
          f"memory {peak / 2**30:.3f} GiB; launches {json.dumps(launches, sort_keys=True)} "
          f"({per_step.get('flash_attention', 0):.1f} flash, "
          f"{per_step.get('adamw_step', 0):.1f} adamw_step and "
          f"{per_step.get('grad_sumsq', 0):.1f} grad_sumsq a step)")
    import math
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in history):
        fail("lm train: a loss or grad norm is not finite")
    want = TRAIN_FLASH_A_STEP * steps
    if (launches.get("flash_attention", 0) != want
            or launches.get("flash_attention_sm90", 0) != want):
        fail(f"lm train: flash launches {launches}, not {TRAIN_FLASH_A_STEP} a "
             f"step, all sm90 ({want})")
    if (launches.get("flash_attention_bwd_sm90", 0) != TRAIN_DEPTH * steps
            or launches.get("flash_backward_plain", 0)):
        fail(f"lm train: flash backward launches {launches}, not one sm90 a "
             f"layer a step ({TRAIN_DEPTH * steps}) and none plain")
    leaves = sum(x.numel() > 0 for x in tree.leaves(state["params"]))
    opt_want = {"adamw_step": leaves * steps, "grad_sumsq": (leaves + 1) * steps}
    if {k: launches.get(k, 0) for k in opt_want} != opt_want:
        fail(f"lm train: clip and AdamW launches {launches}, not one adamw_step a "
             f"leaf a step and one grad_sumsq a leaf and the final a step ({opt_want})")
    embed0 = layers.embed_init(torch.Generator(device="cuda").manual_seed(0),
                               cfg.vocab_size, cfg.d_model, dev)["table"]
    if (torch.equal(embed0, state["params"]["embed"]["table"])
            or bool((state["params"]["final_norm"]["scale"] == 1).all())
            or int(state["step"]) != steps):
        fail("lm train: the params did not change")
    del embed0

    # one more step under the profiler: device busy / idle share
    ts = step_lib.make_train_step(cfg)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             TokenPipeline(cfg.vocab_size, args.batch, args.seq).batch_at(steps).items()}
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        state, _ = ts(state, batch)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    by_name = {}
    for e in measured_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    busy = sum(by_name.values())
    flash = sum(t for n, t in by_name.items() if any(sym in n for sym in FLASH_SYMBOLS))
    print(f"profile lm train step (profiler on): wall {pwall:.4f} s, device busy "
          f"{busy:.4f} s, device idle share {1 - busy / pwall:.4f}, flash forward "
          f"{flash:.4f} s = {flash / busy:.4f} of busy")
    kinds = {}
    for n, sec in by_name.items():
        kind = ("flash forward kernel" if any(sym in n for sym in FLASH_SYMBOLS)
                else "flash backward kernel (delta, products, convert)"
                if "flash_bwd_sm90" in n else "fp32 GEMM (sgemm)"
                if "sgemm" in n else "bf16 GEMM" if any(
                    x in n for x in ("nvjet", "xmma", "gemm", "Kernel2")) else
                "other (elementwise, reductions, copies)")
        kinds[kind] = kinds.get(kind, 0.0) + sec
    for kind, sec in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  by kind: {sec:.4f} s ({sec / busy:.3f} of busy)  {kind}")
    for n, sec in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  device {sec:.4f} s ({sec / busy:.3f} of busy)  {n[:90]}")
    del state, batch
    torch.cuda.empty_cache()
    return dict(steps=steps, wall_s=wall, step_s_after_first=after_first,
                losses=[h["loss"] for h in history],
                grad_norms=[h["grad_norm"] for h in history], peak_bytes=peak,
                launches=launches, profile=dict(wall=pwall, busy=busy,
                                                idle=1 - busy / pwall,
                                                flash_share=flash / busy,
                                                by_kind=kinds))


def run_lm_federation(torch):
    """Phase 14c: the launcher's run_dfl, F = 2 ranks on cuda:0 under gloo,
    llama3-8b full width at depth 1, int8 wire, counted in each rank."""
    from repro_torch import tree
    from repro_torch.core import compression
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    args = launch_train.parse_args(DFL_ARGS)
    cfg = _depth(1)
    t0 = time.perf_counter()
    ranks = launch_train.run_dfl(args, cfg, torch.device("cuda:0"))
    wall = time.perf_counter() - t0
    meta = transformer.init(torch.Generator(), cfg, "meta")
    payload = {c or "fp32": compression.payload_bytes(meta, c) for c in (None, "int8")}
    n_params = sum(x.numel() for x in tree.leaves(meta))
    for r in ranks:
        rounds, lc, wire = r["rounds"], r["launches"], r["wire"]
        received = sum(x["received"] for x in rounds)
        # forward + remat recompute a local step (one layer), one a receipt
        flash_want = args.rounds * 2 * args.local_steps + received
        print(f"lm dfl rank {r['rank']}: peak device memory "
              f"{r['peak_bytes'] / 2**30:.3f} GiB; rounds " + "; ".join(
                  f"{x['round']}: F={x['F']} loss {x['loss']:.5f} neighbor_acc "
                  f"{x['neighbor_acc']:.4f} rep_min {x['rep_min']:.2f} local "
                  f"{x['local_s']:.3f} s round {x['round_s'] * 1e3:.1f} ms"
                  for x in rounds)
              + f"; wire {wire.get('bytes', 0)} B in {wire.get('messages', 0)} "
                f"messages, {wire.get('seconds', 0.0):.3f} s in the exchange; "
                f"launches {json.dumps(lc, sort_keys=True)}")
        if len(rounds) != args.rounds:
            fail(f"lm dfl rank {r['rank']}: {len(rounds)} rounds")
        for x in rounds:
            if not (0.0 <= x["neighbor_acc"] <= 1.0 and 0.0 <= x["rep_min"] <= 1.0):
                fail(f"lm dfl rank {r['rank']}: round {x}")
        if lc.get("quantize", 0) != args.rounds or lc.get("dequantize", 0) != received:
            fail(f"lm dfl rank {r['rank']}: {lc.get('quantize', 0)} quantize / "
                 f"{lc.get('dequantize', 0)} dequantize launches, not one a round "
                 f"({args.rounds}) / one a valid receipt ({received})")
        if (lc.get("flash_attention_sm90", 0) != flash_want
                or wire.get("bytes") != wire.get("messages", -1) * payload["int8"]):
            fail(f"lm dfl rank {r['rank']}: flash {lc}, wire {wire}")
    ratio = payload["int8"] / payload["fp32"]
    print(f"lm dfl (F={DFL_F}, llama3-8b depth 1 full width, {n_params} params, "
          f"B {args.batch} x S {args.seq}, H {args.local_steps}, ring ttl "
          f"{args.ttl}, int8): {wall:.3f} s for the launch (spawn, init, "
          f"{args.rounds} rounds); int8 payload {payload['int8']} B = {ratio:.4f} "
          f"of fp32's {payload['fp32']} B")
    return dict(wall_s=wall, ranks=ranks, payload_bytes=payload,
                n_params=n_params)


def run_lm_elastic(torch):
    """Phase 14d: the launcher's main() with --dfl --fed 4 --fail-node 1@2
    at smoke_config("llama3-8b") on cuda:0, 4 ranks: F=4, then F=3."""
    from repro_torch.launch import train as launch_train
    t0 = time.perf_counter()
    ranks = launch_train.main(ELASTIC_ARGS)
    wall = time.perf_counter() - t0
    fs = [[x["F"] for x in r["rounds"]] for r in ranks]
    if [r["rank"] for r in ranks] != [0, 2, 3] or fs != [[4, 4, 3, 3]] * 3:
        fail(f"lm elastic: survivors {[r['rank'] for r in ranks]}, F by round {fs}")
    launches = {k: sum(r["launches"].get(k, 0) for r in ranks)
                for k in ("flash_attention", "flash_attention_sm90")}
    if launches["flash_attention"] <= 0 or launches["flash_attention_sm90"]:
        fail(f"lm elastic: flash launches {launches} (the simt kernel, Dh 16)")
    print(f"lm elastic (smoke llama3-8b, --fed 4 --fail-node 1@2, 4 rounds on "
          f"cuda:0): survivors {[r['rank'] for r in ranks]}, F by round {fs[0]}; "
          f"{wall:.3f} s; flash launches over the survivors {launches}")
    return dict(wall_s=wall, launches=launches, f_by_round=fs[0])


def run_lm(torch):
    """Phase 14: (b) kernel checks and times first (the plain attention at
    B 2 x S 4096 needs ~30 GB), then (a) training, (c) the federation, (d)
    the elastic run."""
    t_phase = time.perf_counter()
    lse_err = check_flash_training(torch)
    rows = {"flash_attention_sm90": time_flash_training(torch, 2, 4096, 32, 8, 128),
            "flash_attention": time_simt_lse(torch),
            "flash_attention_bwd_sm90": time_flash_backward(torch, 2, 4096, 32, 8, 128)}
    chatglm3_bwd = time_flash_backward(torch, 2, 4096, 32, 2, 128)   # chatglm3-6b's heads
    rows["flash_attention_sm90"]["max_abs_err"] = max(
        rows["flash_attention_sm90"]["max_abs_err"], lse_err["sm90"])
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], lse_err["simt"])
    (q_lm, dq_lm), (q_sh, dq_sh) = time_lm_wire(torch)
    check = check_train_kernels_vs_plain(torch)
    train = run_lm_training(torch)
    fed = run_lm_federation(torch)
    elastic = run_lm_elastic(torch)
    rows["flash_attention_sm90"]["launches"] = train["launches"]["flash_attention_sm90"]
    rows["flash_attention"]["launches"] = elastic["launches"]["flash_attention"]
    rows["flash_attention_bwd_sm90"]["launches"] = train["launches"]["flash_attention_bwd_sm90"]
    for name, row in (("quantize", q_lm), ("dequantize", dq_lm)):
        row["launches"] = sum(r["launches"].get(name, 0) for r in fed["ranks"])
    print(f"phase 14 took {time.perf_counter() - t_phase:.3f} s")
    return dict(rows=rows, wire_lm=(q_lm, dq_lm), wire_sharded=(q_sh, dq_sh),
                check=check, train=train, fed=fed, elastic=elastic,
                chatglm3_backward=chatglm3_bwd)


# ------------------------------------------------------------ phase 15
# the rest of the LM zoo. (arch, depth, B, P) at full width. depth None:
# the full stack; a number: the depth the op-cost walker checks first, the
# deepest whose whole 15b run (init; serve's prefill and decode; the
# consistency check, whose MoE runs at a dropless capacity; the profiled
# prefill and decode) it puts within ZOO_CEILING above what was allocated
# before it. bf16 weights and the walker's whole run: command-r 56.41 /
# 59.23 GiB at its published 40 layers; dbrx 63.00 / 69.85 GiB at 10 of 40
# (11: 69.07 / 75.97); llama4-maverick 35.38 / 54.05 GiB at 3 of 48, a
# unit of a dense and a 128-expert MoE layer and one dense layer (4: 65.73
# / 84.45; the check's dropless expert buffers take 18 GiB)
ZOO_CEILING = 72 * 2**30
ZOO = (
    ("chatglm3-6b", None, 2, 2048),
    ("command-r-35b", 40, 2, 2048),
    ("dbrx-132b", 10, 2, 2048),
    ("llama4-maverick-400b-a17b", 3, 1, 2048),
    ("recurrentgemma-2b", None, 2, 4096),
    ("xlstm-125m", None, 2, 2048),
    ("hubert-xlarge", None, 2, 4096),
    ("llava-next-mistral-7b", None, 2, 2048),
)
ZOO_DECODE = 8
# flash launches of one full-width prefill: (simt, sm90)
ZOO_FLASH = {"chatglm3-6b": (0, 28), "command-r-35b": (0, 40), "dbrx-132b": (0, 10),
             "llama4-maverick-400b-a17b": (0, 3), "recurrentgemma-2b": (0, 8),
             "xlstm-125m": (0, 0), "hubert-xlarge": (0, 48),
             "llava-next-mistral-7b": (0, 32)}
ZOO_SMOKE_PROMPTS = (2, 40)
# init's peak on the card against the walker's prediction (relative): the
# caching allocator's requested bytes, each storage's own bytes as the
# walker counts them; max_memory_allocated, printed beside, counts the
# allocator's blocks, which can hold more than was asked for (2% more for
# xlstm-125m's 1-10 MB leaves as a process's first arch, none for the
# large archs)
ZOO_INIT_TOL = 0.01
# tests/test_torch_zoo.py's bounds: bf16 5e-2 of the logits' scale, xLSTM
# 2e-2 of it a layer; MoE steps where the two runs routed a token to other
# experts at a near tie (probabilities within 2e-2) are exempt
XLSTM_BF16_PER_LAYER = 2e-2
ROUTE_TIE = 2e-2
# tests/test_models.py: xLSTM's prefill-then-decode in fp32, 0.06 a layer
# (a smoke-size bound: at full width the reference's own gap passes it on
# some draws of the weights and not on others, tests/test_torch_xlstm.py)
XLSTM_CONSISTENCY_PER_LAYER = 0.06
# xLSTM at full width: the card's two consistency runs against the CPU's
# (plain, the reference's numbers) on the same weights, of the logits'
# scale (the port on the CPU is within 6e-4 of it from the JAX package)
XLSTM_CARD_CPU_TOL = 2.5e-3
# the device-time ranges read from a profiled prefill: (module, function)
ZOO_RANGES = {
    "dbrx-132b": (("moe", "_dispatch_combine"), ("moe", "_expert_ffn")),
    "llama4-maverick-400b-a17b": (("moe", "_dispatch_combine"), ("moe", "_expert_ffn")),
    "recurrentgemma-2b": (("rglru", "rglru_apply"), ("rglru", "scan")),
    "xlstm-125m": (("xlstm", "mlstm_apply"), ("xlstm", "slstm_apply")),
}
ZOO_TRAIN_ARGS = ["--steps", "3", "--batch", "2", "--seq", "1024"]
# rows 4h and 4r: (B, S, H, KH, Dh, window, causal)
FLASH_HUBERT = (2, 4096, 16, 16, 80, 0, False)
FLASH_RG_LOCAL = (2, 4096, 10, 1, 256, 2048, True)
# hubert-xlarge's encoder through the kernels against the plain route:
# (depth, B, S) at full width; bound on max |diff| over the output's scale
# (tests/test_torch_zoo.py's bf16 bound: the sm90 kernel rounds p to bf16
# before P.V, the plain version keeps it in fp32)
HUBERT_CHECK = (2, 2, 4096)
HUBERT_CHECK_TOL = 5e-2


@contextlib.contextmanager
def _recorded_routes():
    """Every router call of the port's MoE while the body runs: a list of
    (experts, probs) as host arrays."""
    import torch
    from repro_torch.models import moe
    calls, route = [], moe._route

    def recorded(p, cfg, x):
        gates, experts, aux = route(p, cfg, x)
        probs = torch.softmax(moe.L.dense_apply(p["router"], x).float(), -1)
        calls.append((experts.cpu().numpy(), probs.cpu().numpy()))
        return gates, experts, aux

    moe._route = recorded
    try:
        yield calls
    finally:
        moe._route = route


def _route_flip(card, cpu, dtype):
    """Whether the card and the CPU routed a token to other experts; each
    such token must be a near tie, and fp32 must route alike."""
    import numpy as np
    if len(card) != len(cpu):
        fail(f"{len(card)} router calls on the card, {len(cpu)} on the CPU")
    flip = False
    for (ce, cp), (pe, _) in zip(card, cpu):
        diff = (np.sort(ce, -1) != np.sort(pe, -1)).any(-1)
        for ix in zip(*np.nonzero(diff)):
            gap = abs(np.take(cp[ix], ce[ix]).min() - np.take(cp[ix], pe[ix]).min())
            if dtype == "float32" or gap > ROUTE_TIE:
                fail(f"{dtype} routing differs between card and CPU at {ix}: "
                     f"{ce[ix]} against {pe[ix]} (probability gap {gap:.3e})")
            flip = True
    card.clear()
    cpu.clear()
    return flip


def _zoo_smoke(torch, arch):
    """Phase 15a for one arch: smoke_config from the same params on the card
    (the simt flash kernel at Dh 16) and on the CPU (plain), a ragged
    prompt and 4 decode steps in lockstep, fp32 and bf16. Returns the fp32
    card run's prefill launches."""
    from repro_torch import convert, serve
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer
    cfg = smoke_config(arch)
    g = torch.Generator(device="cuda").manual_seed(6)
    params = {"cuda": transformer.init(g, cfg, "cuda")}
    params["cpu"] = convert.params_from_jax(convert.params_to_numpy(params["cuda"]), "cpu")
    B, P = ZOO_SMOKE_PROMPTS
    inputs = serve.prefill_inputs(cfg, B, P, g, "cuda")
    attn_layers = sum(k in ("attn", "local_attn", "enc_attn") for k in cfg.layer_kinds())
    moe = cfg.moe is not None
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        bound = (XLSTM_BF16_PER_LAYER * cfg.num_layers if cfg.family == "ssm"
                 else 5e-2)
        rec = {"cuda": [], "cpu": []}
        caches = {dev: (transformer.cache_init(cfg, B, P + 8, dev, dtype=dtype)
                        if cfg.supports_decode else None) for dev in ("cuda", "cpu")}
        steps = [("prefill", None)] + ([("decode", i) for i in range(4)]
                                       if cfg.supports_decode else [])
        worst, exempt = 0.0, 0
        for kind, i in steps:
            logits = {}
            for dev in ("cuda", "cpu"):
                ctx = _recorded_routes() if moe else contextlib.nullcontext([])
                with ctx as calls:
                    if dev == "cuda":
                        torch.cuda.synchronize()
                        reset_launches()
                    if kind == "prefill":
                        batch = {k: v.to(dev) for k, v in inputs.items()}
                        lg, _ = transformer.prefill(params[dev], cfg, batch, caches[dev],
                                                    dtype=dtype)
                    else:
                        tok = inputs["tokens"][:, -1:].to(dev)
                        lg, _ = transformer.decode_step(params[dev], cfg, tok,
                                                        caches[dev], P + i, dtype=dtype)
                    if dev == "cuda":
                        torch.cuda.synchronize()
                        counted = dict(LAUNCHES)
                    rec[dev] = list(calls)
                logits[dev] = lg.cpu()
            if kind == "prefill":
                simt = counted.get("flash_attention", 0) - counted.get(
                    "flash_attention_sm90", 0)
                if simt != attn_layers or counted.get("flash_attention_sm90", 0):
                    fail(f"smoke {arch} {name} prefill launched {counted}, not "
                         f"{attn_layers} simt flash launches")
                report[name] = counted
            elif sum(counted.values()):
                fail(f"smoke {arch} decode launched {counted}: decode is plain")
            if moe and _route_flip(rec["cuda"], rec["cpu"], name):
                exempt += 1
                continue
            gap, scale = _scale_gap(torch, logits["cuda"], logits["cpu"])
            ok = (torch.allclose(logits["cuda"], logits["cpu"], rtol=1e-4, atol=1e-4)
                  if dtype == torch.float32 else gap <= bound * scale)
            if not ok:
                fail(f"smoke {arch} {name} {kind} logits differ between card and "
                     f"CPU: max |diff| {gap:.3e} on logits up to {scale:.3f}")
            worst = max(worst, gap / scale)
        print(f"zoo smoke {arch} card vs CPU ({name}, prefill P={P}"
              + (" + 4 decode steps" if cfg.supports_decode else ", encoder")
              + f"): worst |diff| {worst:.3e} of the logits' scale (limit "
              f"{1e-4 if dtype == torch.float32 else bound}); steps exempt for a "
              f"routing near tie: {exempt}; prefill launches "
              f"{json.dumps(report[name], sort_keys=True)}")
    return report["float32"].get("flash_attention", 0)


def _profile_window(torch, arch, fn):
    """One call of ``fn`` under the profiler: wall, device busy and idle
    share, the flash kernels' device time, the device time each of the
    arch's ``ZOO_RANGES`` spans (their functions wrapped in a
    ``record_function`` range for the window), and the top device ops."""
    import importlib
    from torch.profiler import record_function
    wrapped = []
    for mod_name, fn_name in ZOO_RANGES.get(arch, ()):
        mod = importlib.import_module(f"repro_torch.models.{mod_name}")
        orig = getattr(mod, fn_name)

        def ranged(*a, _orig=orig, _label=f"{mod_name}.{fn_name}", **kw):
            with record_function(_label):
                return _orig(*a, **kw)

        setattr(mod, fn_name, ranged)
        wrapped.append((mod, fn_name, orig))
    try:
        torch.cuda.synchronize()
        with profiled() as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, fn_name, orig in wrapped:
            setattr(mod, fn_name, orig)
    # a record_function range also shows on the card as an annotation that
    # spans its kernels (graph replays included): its device seconds, read
    # apart from the kernels' busy time
    labels = {f"{m}.{f}" for m, f in ZOO_RANGES.get(arch, ())}
    by_name, ranges = {}, {}
    for e in measured_events(prof):
        into = ranges if e.name in labels else by_name
        into[e.name] = into.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    busy = sum(by_name.values())
    flash = sum(t for n, t in by_name.items() if any(sym in n for sym in FLASH_SYMBOLS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall=wall, busy=busy, idle=1 - busy / wall if wall else 0.0,
                flash_s=flash, ranges=ranges,
                top=[(n[:80], sec) for n, sec in top])


def _consistency_logits(torch, cfg, weights, inputs, device):
    """``_consistency``'s two runs on ``device``: (the logits decoded at
    position P - 1 after a prefill of P - 1, the full prefill's)."""
    import dataclasses
    from repro_torch.models import transformer
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    xlstm = cfg.family == "ssm"
    dtype = torch.float32 if xlstm else torch.bfloat16
    toks = inputs["tokens"]
    if xlstm:
        toks = torch.cat([toks, toks[:, :1]], dim=1)
    B, P = toks.shape
    head = dict(inputs, tokens=toks[:, :P - 1])
    cache = transformer.cache_init(cfg, B, P + 1, device)
    _, cache = transformer.prefill(weights, cfg, head, cache, dtype=dtype)
    logits_d, _ = transformer.decode_step(weights, cfg, toks[:, P - 1:], cache, P - 1,
                                          dtype=dtype)
    del cache
    cache = transformer.cache_init(cfg, B, P + 1, device)
    want, _ = transformer.prefill(weights, cfg, dict(inputs, tokens=toks), cache,
                                  dtype=dtype)
    return logits_d, want


def _consistency(torch, arch, cfg, weights, inputs):
    """Prefill P - 1 tokens, decode token P - 1, against a prefill of all P
    (tests/test_models.py's check): bf16 within CONSISTENCY_TOL of the
    logits' scale. MoE runs at a dropless capacity (E / k), as the JAX
    smoke config's 4.0 does: the flat decode row drops pairs by design at
    the full config's 1.25 (capacity 1 for dbrx at B 2), where the
    prefill's rows do not. xLSTM as the JAX test runs it: fp32
    activations, a prefill of all P (a whole number of mLSTM chunks) and
    one more token decoded against a prefill of P + 1: the reference's
    chunkwise mLSTM leaves another state after a prefill that ends inside
    a chunk (ROADMAP.md §3), and the port keeps its numbers. Its gap at
    full width is the reference's, which the smoke bound (0.06 a layer)
    holds on some draws of the weights and not on others; so the card's
    two runs are held to the CPU's on the same weights
    (XLSTM_CARD_CPU_TOL), the smoke bound printed beside."""
    logits_d, want = _consistency_logits(torch, cfg, weights, inputs, "cuda")
    xlstm = cfg.family == "ssm"
    P = inputs["tokens"].shape[1] + xlstm
    gap, scale = _scale_gap(torch, logits_d, want)
    agree = float((logits_d.argmax(-1) == want.argmax(-1)).float().mean())
    off = None
    if xlstm:
        from repro_torch import tree
        limit = XLSTM_CONSISTENCY_PER_LAYER * cfg.num_layers
        diff = (logits_d - want).abs()
        smoke_bound = (bool((diff <= limit + 0.1 * want.abs()).all())
                       and float(diff.mean()) < 0.015 * cfg.num_layers and agree > 0.95)
        cpu = _consistency_logits(torch, cfg, tree.map(lambda t: t.cpu(), weights),
                                  {k: v.cpu() for k, v in inputs.items()}, "cpu")
        off = max(float((card.cpu() - plain).abs().max())
                  for card, plain in zip((logits_d, want), cpu))
        ok = off <= XLSTM_CARD_CPU_TOL * scale
        what = (f"fp32, mean {float(diff.mean()):.4f}; the card's two runs "
                f"{off:.3e} from the CPU's (limit {XLSTM_CARD_CPU_TOL} of the scale); "
                f"the smoke bound (atol {limit:.2f} + rtol 0.1, mean < "
                f"{0.015 * cfg.num_layers:.3f}, argmax agreement > 0.95) "
                + ("holds" if smoke_bound else "does not hold, as on the CPU"))
    else:
        ok = gap <= CONSISTENCY_TOL * scale
        what = f"bf16, {CONSISTENCY_TOL} of the scale"
    print(f"zoo {arch} prefill-then-decode consistency (prefill {P - 1}, decode "
          f"position {P - 1}): max |decode - prefill| {gap:.4f} on logits up to "
          f"{scale:.4f} ({gap / scale:.4f} of the scale; {what}), argmax "
          f"agreement {agree:.2f}")
    if not ok:
        fail(f"zoo {arch}: prefill-then-decode logits disagree")
    return dict(gap=gap, scale=scale, agree=agree, card_vs_cpu=off)


@contextlib.contextmanager
def _after_init(read):
    """Call ``read()`` as each ``transformer.init`` returns (the serving
    entry point's init, the first thing it allocates) while the body runs;
    yields the list of values read."""
    from repro_torch.models import transformer
    orig, seen = transformer.init, []

    def init(*args, **kwargs):
        params = orig(*args, **kwargs)
        seen.append(read())
        return params

    transformer.init = init
    try:
        yield seen
    finally:
        transformer.init = orig


def _zoo_runs(torch, cfg, weights, inputs, B, P, device):
    """The prefill and the decode steps phase 15b profiles after serving,
    on a cache of their own: (prefill(), steps() or None)."""
    from repro_torch.models import transformer
    decode = cfg.supports_decode
    cache = transformer.cache_init(cfg, B, P + ZOO_DECODE, device) if decode else None
    state = {}

    def prefill():
        state["logits"], _ = transformer.prefill(weights, cfg, inputs, cache)

    def steps():
        tok = state["logits"].argmax(-1)[:, None]
        for i in range(ZOO_DECODE):
            logits, _ = transformer.decode_step(weights, cfg, tok, cache, P + i)
            tok = logits.argmax(-1)[:, None]

    return prefill, steps if decode else None


def _zoo_predict(torch, cfg, B, P, whole):
    """The op-cost walker's peaks of one arch's phase 15b run, traced on the
    meta device (bytes alive at once of what the run allocates): init
    alone; with ``whole``, also ``serve.serve`` (init, then the prefill and
    decode) and the arch's whole run (serve; the consistency check with
    serve's outputs alive; the profiled prefill and decode)."""
    from repro_torch import serve
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models import transformer
    if not whole:
        with OpCost() as walker:
            transformer.init(torch.Generator(), cfg, "meta", dtype=serve.DTYPE)
        return dict(init=walker.peak_live)
    with OpCost() as walker, _after_init(lambda: walker.peak_live) as init:
        out = serve.serve(cfg, B, P, ZOO_DECODE + 1, "meta")
        at_serve = walker.peak_live
        if cfg.supports_decode:
            _consistency_logits(torch, cfg, out["weights"], out["inputs"], "meta")
        weights, inputs = out["weights"], out["inputs"]
        del out
        prefill, steps = _zoo_runs(torch, cfg, weights, inputs, B, P, "meta")
        prefill()
        if steps:
            steps()
    return dict(init=init[0], serve=at_serve, run=walker.peak_live)


def _zoo_full(torch, arch, depth, B, P):
    """Phase 15b for one arch: the walker's peaks predicted on the meta
    device; ``serve.serve`` at full width (bf16 weights drawn one unit
    slice at a time), counted, init's peak on the card within
    ZOO_INIT_TOL of the prediction; then prefill-then-decode consistency
    and one profiled prefill (and the decode steps)."""
    import dataclasses
    import gc
    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    decode = cfg.supports_decode
    t0 = time.perf_counter()
    pred = _zoo_predict(torch, cfg, B, P, whole=depth is not None)
    print(f"zoo {arch} (depth {cfg.num_layers}) predicted by the op-cost walker on "
          f"meta in {time.perf_counter() - t0:.3f} s: init peak "
          f"{pred['init'] / 2**30:.4f} GiB"
          + (f", serve {pred['serve'] / 2**30:.4f} GiB, the whole run "
             f"{pred['run'] / 2**30:.4f} GiB (ceiling {ZOO_CEILING / 2**30:.0f} GiB)"
             if "run" in pred else ""))
    if pred.get("run", 0) > ZOO_CEILING:
        fail(f"zoo {arch}: depth {cfg.num_layers} is predicted to need "
             f"{pred['run'] / 2**30:.4f} GiB, above the ceiling")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()      # what earlier phases left
    base_requested = torch.cuda.memory_stats()["requested_bytes.all.current"]

    def allocated():
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    def requested():
        return torch.cuda.memory_stats()["requested_bytes.all.peak"] - base_requested

    reset_launches()
    with _after_init(lambda: (requested(), allocated())) as init_peak:
        out = serve.serve(cfg, B, P, ZOO_DECODE + 1, "cuda")
    peak = allocated()
    launches = dict(LAUNCHES)
    init_requested, init_allocated = init_peak[0]
    init_err = abs(init_requested - pred["init"]) / pred["init"]
    print(f"zoo {arch} init peak on the card {init_requested / 2**30:.4f} GiB requested "
          f"({init_requested} B) against the walker's {pred['init'] / 2**30:.4f} GiB "
          f"({pred['init']} B): {init_err:.3e} apart (limit {ZOO_INIT_TOL}); "
          f"max_memory_allocated {init_allocated / 2**30:.4f} GiB ({init_allocated} B, "
          f"{init_allocated / pred['init'] - 1:.3e} above); serve peak "
          f"{peak / 2**30:.4f} GiB"
          + (f" against {pred['serve'] / 2**30:.4f}" if "serve" in pred else ""))
    if init_err > ZOO_INIT_TOL:
        fail(f"zoo {arch}: init peak {init_requested} B on the card, {pred['init']} B "
             "predicted")
    sec = out["seconds"]
    params = transformer.param_count(out["weights"])
    sm90 = launches.get("flash_attention_sm90", 0)
    simt = launches.get("flash_attention", 0) - sm90
    if (simt, sm90) != ZOO_FLASH[arch]:
        fail(f"zoo {arch}: flash launches simt {simt}, sm90 {sm90}; expected "
             f"{ZOO_FLASH[arch]} (one a prefill attention layer)")
    finite = all(bool(torch.isfinite(out[k]).all()) for k in ("prefill_logits", "logits"))
    if not finite:
        fail(f"zoo {arch}: logits are not finite")
    row = dict(arch=arch, layers=cfg.num_layers, params=params, batch=B, prompt=P,
               init_s=sec["init"], prefill_s=sec["prefill"],
               decode_ms_per_token=(sec["decode"] / ZOO_DECODE * 1e3 if decode else None),
               peak_gib=peak / 2**30, init_peak_gib=init_allocated / 2**30,
               init_requested_gib=init_requested / 2**30,
               predicted_gib={k: v / 2**30 for k, v in pred.items()},
               flash_simt=simt, flash_sm90=sm90, launches=launches, finite=finite)
    if decode:
        row["consistency"] = _consistency(torch, arch, cfg, out["weights"], out["inputs"])
    weights, inputs = out["weights"], out["inputs"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    prefill, steps = _zoo_runs(torch, cfg, weights, inputs, B, P, "cuda")
    row["profile_prefill"] = _profile_window(torch, arch, prefill)
    if decode:
        row["profile_decode"] = _profile_window(torch, "decode", steps)
    row["run_peak_gib"] = allocated() / 2**30
    pp = row["profile_prefill"]
    print(f"zoo {arch} (depth {cfg.num_layers}, {params / 1e9:.3f} B params, bf16 "
          f"weights; B {B} x P {P}{f' + {ZOO_DECODE} decode' if decode else ', encoder forward'}):"
          f" init {sec['init']:.3f} s, prefill {sec['prefill']:.4f} s, "
          + (f"decode {row['decode_ms_per_token']:.3f} ms/token, " if decode else "")
          + f"peak {row['peak_gib']:.3f} GiB (above the {base / 2**30:.3f} GiB "
          f"allocated before it; init {row['init_peak_gib']:.3f}, the whole run "
          f"{row['run_peak_gib']:.3f}"
          + (f" against {pred['run'] / 2**30:.3f} predicted" if "run" in pred else "")
          + "), "
          f"flash simt {simt} / sm90 {sm90}, "
          f"logits finite {finite}; profiled prefill: wall {pp['wall']:.4f} s, busy "
          f"{pp['busy']:.4f} s, idle share {pp['idle']:.4f}, flash {pp['flash_s']:.4f} s"
          + "".join(f", {k} {v:.4f} s" for k, v in sorted(pp["ranges"].items()))
          + (f"; profiled decode idle share {row['profile_decode']['idle']:.4f}"
             if decode else ""))
    for n, t in pp["top"]:
        print(f"  device {t:.4f} s ({t / pp['busy']:.3f} of busy)  {n}")
    del weights, inputs, prefill, steps
    gc.collect()
    torch.cuda.empty_cache()
    return row


def time_slstm(torch):
    """xlstm-125m's sLSTM layer prefill at full width, B 2 x S 2048: the
    route the prefill takes (a captured CUDA graph a GRAPH_STEPS steps)
    against the eager loop that training takes, bitwise, each one layer
    call timed on the host clock after a synchronize; the eager loop's
    device kernels a step."""
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    cfg = get_config("xlstm-125m")
    g = torch.Generator(device="cuda").manual_seed(7)
    p = xlstm.slstm_init(g, cfg, "cuda")
    x = torch.randn((2, 2048, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)

    def eager():
        hs, _ = xlstm._slstm_steps(p, cfg, xlstm.slstm_state_init(cfg, 2, "cuda"),
                                   x.float() @ p["w"])
        return xlstm._slstm_out(p, hs, x.dtype)

    walls = {}
    for name, fn in (("graph", lambda: xlstm.slstm_apply(p, cfg, x)[0]), ("eager", eager)):
        fn()                                   # the graph's capture, warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0, out)
    if not torch.equal(walls["graph"][1], walls["eager"][1]):
        fail("sLSTM: the CUDA-graph route differs from the eager loop")
    with profiled() as prof:
        hs, _ = xlstm._slstm_steps(p, cfg, xlstm.slstm_state_init(cfg, 2, "cuda"),
                                   x[:, :16].float() @ p["w"])
        torch.cuda.synchronize()
    kernels = len(measured_events(prof)) / 16
    graph_s, eager_s = walls["graph"][0], walls["eager"][0]
    print(f"sLSTM layer (xlstm-125m, B 2 x S 2048): graph route {graph_s:.4f} s a "
          f"layer call ({graph_s / 2048 * 1e6:.1f} us a step), eager loop "
          f"{eager_s:.4f} s ({eager_s / 2048 * 1e6:.1f} us a step, ~{kernels:.1f} "
          f"device kernels a step); bitwise equal")
    return dict(graph_s=graph_s, eager_s=eager_s, kernels_a_step=kernels)


def run_zoo_train(torch):
    """Phase 15c: ``python -m repro_torch.launch.train`` with its default
    arch (xlstm-125m, full config), 3 steps at B 2 x S 1024."""
    import math
    from repro_torch.launch import train as launch_train
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, history = launch_train.main(ZOO_TRAIN_ARGS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    args = launch_train.parse_args(ZOO_TRAIN_ARGS)
    after_first = sum(h["seconds"] for h in history[1:]) / (len(history) - 1)
    print(f"zoo train (python -m repro_torch.launch.train {' '.join(ZOO_TRAIN_ARGS)}: "
          f"{args.arch}, full config): losses "
          f"{[round(h['loss'], 5) for h in history]}, {history[0]['seconds']:.3f} s "
          f"the first step, {after_first:.3f} s a step after it, peak "
          f"{peak / 2**30:.3f} GiB")
    if args.arch != "xlstm-125m" or not all(math.isfinite(h["loss"]) for h in history):
        fail(f"zoo train: arch {args.arch}, losses {[h['loss'] for h in history]}")
    del state
    torch.cuda.empty_cache()
    return dict(arch=args.arch, losses=[h["loss"] for h in history],
                first_step_s=history[0]["seconds"], step_s_after_first=after_first,
                peak_gib=peak / 2**30)


def check_hubert_kernels_vs_plain(torch):
    """Phase 15d's check: hubert-xlarge at full width and ``HUBERT_CHECK``'s
    depth, bf16 weights and B x S frames from a seed: the encoder's output
    (every position, after the final norm) through the kernels against the
    same forward with the attention forced through the plain version
    (``models.flash.plain_route()``), within ``HUBERT_CHECK_TOL`` of the
    output's scale. The kernels' run launches the sm90 kernel once a layer
    and the simt kernel never; the plain run launches nothing."""
    import dataclasses
    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import flash as flash_model
    from repro_torch.models import layers, transformer
    depth, B, S = HUBERT_CHECK
    cfg = dataclasses.replace(get_config("hubert-xlarge"), num_layers=depth)
    g = torch.Generator(device="cuda").manual_seed(8)
    weights = transformer.init(g, cfg, "cuda", dtype=torch.bfloat16)
    inputs = serve.prefill_inputs(cfg, B, S, g, "cuda")

    def encode():
        with torch.no_grad():
            h, positions = transformer._embed_inputs(weights, cfg, inputs)
            h, _, _ = transformer._stack_forward(weights, cfg, h, positions, None)
            return layers.norm_apply(weights["final_norm"], h, cfg.norm).float()

    torch.cuda.synchronize()
    reset_launches()
    got = encode()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    reset_launches()
    with flash_model.plain_route():
        want = encode()
    torch.cuda.synchronize()
    sm90 = launches.get("flash_attention_sm90", 0)
    if (launches.get("flash_attention", 0), sm90) != (depth, depth) or LAUNCHES:
        fail(f"hubert kernels vs plain: launches {launches} through the kernels, "
             f"{dict(LAUNCHES)} on the plain route")
    gap, scale = _scale_gap(torch, got, want)
    finite = bool(torch.isfinite(got).all())
    print(f"hubert-xlarge encoder through the kernels vs the plain route (depth "
          f"{depth}, full width, B {B} x S {S}, bf16): output {tuple(got.shape)}, "
          f"max |diff| {gap:.4e} on values up to {scale:.4f} ({gap / scale:.4e} of "
          f"the scale, limit {HUBERT_CHECK_TOL}), finite {finite}, sm90 launches "
          f"{sm90}")
    if not finite or gap > HUBERT_CHECK_TOL * scale:
        fail("hubert-xlarge's encoder through the kernels disagrees with the plain route")
    del weights, inputs, got, want
    torch.cuda.empty_cache()
    return dict(depth=depth, batch=B, seq=S, gap=gap, scale=scale,
                rel=gap / scale, sm90_launches=sm90)


def run_zoo(torch):
    """Phase 15: (d) rows 4h and 4r first (their plain versions need a few
    GB: hubert's sm90 row on the tensors as made, its simt row on
    ``_simt_view`` copies) and hubert's encoder through the kernels against
    the plain route, (a) every new arch at smoke size on the card against
    the CPU, (b) each at full width, (c) the launcher's default arch
    trains."""
    t_phase = time.perf_counter()
    B, S, H, KH, Dh, window, causal = FLASH_HUBERT
    hubert = time_flash(torch, B, S, H, KH, Dh, window, causal=causal)
    rows = {"hubert": hubert["sm90"], "hubert_simt": hubert["simt"]}
    hubert_check = check_hubert_kernels_vs_plain(torch)
    B, S, H, KH, Dh, window, causal = FLASH_RG_LOCAL
    rows["rg_local"] = time_flash(torch, B, S, H, KH, Dh, window, plain_iters=2)["sm90"]
    smoke = {arch: _zoo_smoke(torch, arch) for arch, *_ in ZOO}
    t_full = time.perf_counter()
    full = {}
    for arch, depth, B, P in ZOO:
        t0 = time.perf_counter()
        full[arch] = _zoo_full(torch, arch, depth, B, P)
        full[arch]["phase_s"] = time.perf_counter() - t0
    t_full = time.perf_counter() - t_full
    slstm = time_slstm(torch)
    train = run_zoo_train(torch)
    rows["hubert"]["launches"] = full["hubert-xlarge"]["flash_sm90"]
    rows["hubert_simt"]["launches"] = full["hubert-xlarge"]["flash_simt"]
    rows["rg_local"]["launches"] = full["recurrentgemma-2b"]["flash_sm90"]
    print(f"phase 15 took {time.perf_counter() - t_phase:.3f} s (15b {t_full:.3f} s)")
    return dict(rows=rows, smoke=smoke, full=full, slstm=slstm, train=train,
                hubert_check=hubert_check)


# ------------------------------------------------------------ phase 16
# the dry-run command line's federation runs and remat="dots". 16a's flags,
# and the record the JAX package's command line writes for them (jax 0.9.0
# on the CPU):
#   PYTHONPATH=src python -m repro.launch.dryrun --engine lax --scenario lenet \
#       --attack signflip --nodes 16 --ticks 48 --topology kregular --ttl 2 \
#       --compress int8
CLI_LAX = ["--engine", "lax", "--scenario", "lenet", "--attack", "signflip",
           "--nodes", "16", "--ticks", "48", "--topology", "kregular", "--ttl",
           "2", "--compress", "int8"]
CLI_JAX_COUNTERS = dict(broadcasts=128, deliveries=988, fedavg_rounds=84,
                        wire_bytes=108800536, broadcast_bytes=110122,
                        delivery_budget=8, compact_budget=64,
                        max_tick_deliveries=24)
CLI_JAX_HONEST_ACC = 0.10520832985639572
CLI_JAX_MAL_REP = 0.9766665697097778
# the two packages draw their train batches from different generators
# (tests/test_torch_dryrun.py's bound)
CLI_ACC_TOL = 0.05
# 16c: --engine lax with the JAX defaults but these, and the default sweep
CLI_TOY = ["--engine", "lax", "--nodes", "64", "--ticks", "48"]
CLI_SWEEP = ["--sweep"]
# 16d: remat="dots" against "full" at phase 14a's shape; the first step's
# loss and each grad leaf within this relative L2 distance (the saved
# products are the ones the recompute would make again: bitwise expected)
DOTS_TOL = 1e-6
DOTS_STEPS = 3


def _cli(argv, tmp, name):
    """``dryrun.main(argv)`` writing to a new file: (record, wall s)."""
    from repro_torch.launch import dryrun
    path = os.path.join(tmp, name + ".json")
    t0 = time.perf_counter()
    rc = dryrun.main([*argv, "--out", path])
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"dryrun {' '.join(argv)}: exit code {rc}")
    with open(path) as f:
        (rec,) = json.load(f)
    return rec, wall


def _cli_counters(rec, what):
    got = {k: rec[k] for k in CLI_JAX_COUNTERS}
    if got != CLI_JAX_COUNTERS:
        fail(f"{what}: counters {got}, the JAX command line's {CLI_JAX_COUNTERS}")


def run_cli(torch):
    """Phase 16a-c: the dry-run command line's federation runs through
    ``launch.dryrun.main`` on the card: (a) the lax LeNet run, counted,
    held to the JAX command line's record, and the same run on the CPU;
    (b) --delivery sharded over 2 gloo ranks on the card; (c) the toy at
    the JAX defaults and the default sweep grid."""
    import math
    import tempfile

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun
    _, spec, _, cfg, *_ = dryrun._lax_setup(dryrun.build_parser().parse_args(CLI_LAX),
                                            None)
    want = _training_ticks(spec, cfg)
    # the most nodes training on one tick (fixed interval): the stacked tree
    # of the largest round trip
    phases = [c % cfg.train_interval[0] for c in spec.initial_countdown]
    wire_rows = max(phases.count(p) for p in phases)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        torch.cuda.synchronize()
        reset_launches()
        rec, wall = _cli(CLI_LAX + ["--device", "cuda"], tmp, "lax")
        launches = dict(LAUNCHES)
        _cli_counters(rec, "cli lax (16a) on cuda")
        if rec["device"] != "cuda":
            fail(f"cli lax (16a): ran on {rec['device']}")
        for k, got, ref in (("honest_acc", rec["honest_acc"], CLI_JAX_HONEST_ACC),
                            ("malicious_reputation", rec["malicious_reputation"],
                             CLI_JAX_MAL_REP)):
            if not abs(got - ref) <= CLI_ACC_TOL:
                fail(f"cli lax (16a): {k} {got} is not within {CLI_ACC_TOL} of "
                     f"the JAX command line's {ref}")
        for k in ("quantize", "dequantize"):
            if launches.get(k, 0) != want:
                fail(f"cli lax (16a): {k} launched {launches.get(k, 0)} times, not "
                     f"once a training tick ({want})")
        print(f"cli lax (16a) {' '.join(CLI_LAX)} on cuda: wall {wall:.3f} s (the "
              f"simulator's run {rec['wall_s']} s); launches "
              f"{json.dumps(launches, sort_keys=True)} (training ticks {want}); "
              f"honest accuracy {rec['honest_acc']:.6f} (JAX {CLI_JAX_HONEST_ACC:.6f}), "
              f"poisoners' reputation {rec['malicious_reputation']:.6f} (JAX "
              f"{CLI_JAX_MAL_REP}); counters equal the JAX command line's")
        cpu, cpu_wall = _cli(CLI_LAX + ["--device", "cpu"], tmp, "lax_cpu")
        _cli_counters(cpu, "cli lax (16a) on the CPU")
        print(f"cli lax (16a) on the CPU: wall {cpu_wall:.3f} s, honest accuracy "
              f"{cpu['honest_acc']:.6f}; counters equal the card's")
        sharded, sh_wall = _cli(CLI_LAX + ["--delivery", "sharded", "--mesh", "2",
                                           "--device", "cuda"], tmp, "sharded")
        _cli_counters(sharded, "cli lax sharded (16b)")
        if sharded["shards"] != 2:
            fail(f"cli lax sharded (16b): shards {sharded['shards']}")
        print(f"cli lax sharded (16b, --mesh 2: 2 gloo ranks on the card): wall "
              f"{sh_wall:.3f} s (spawn included; the simulator's run "
              f"{sharded['wall_s']} s), honest accuracy {sharded['honest_acc']:.6f}; "
              f"counters equal the JAX command line's")
        toy, toy_wall = _cli(CLI_TOY + ["--device", "cuda"], tmp, "toy")
        if not (math.isfinite(toy["honest_acc"])
                and math.isfinite(toy["malicious_reputation"])):
            fail(f"cli toy (16c): {toy}")
        print(f"cli toy (16c) {' '.join(CLI_TOY)} on cuda: wall {toy_wall:.3f} s, "
              f"deliveries {toy['deliveries']}, honest accuracy "
              f"{toy['honest_acc']:.6f}, poisoners' reputation "
              f"{toy['malicious_reputation']:.6f}")
        sweep, sweep_wall = _cli(CLI_SWEEP + ["--device", "cuda"], tmp, "sweep")
        # an honest cell has no attacker: its attacker reputation is NaN
        for o in sweep["outcomes"]:
            vals = [o["final_honest_acc"], o["honest_reputation"]] + (
                [o["attacker_reputation"]] if o["attack"] != "none" else [])
            if not all(math.isfinite(v) for v in vals):
                fail(f"cli sweep (16c): outcome {o}")
        if sweep["cells"] != 12 or len(sweep["outcomes"]) != 12:
            fail(f"cli sweep (16c): {sweep['cells']} cells")
        print(f"cli sweep (16c) on cuda: {sweep['cells']} federations in "
              f"{sweep['batches']} batches over {sweep['devices']} device(s), wall "
              f"{sweep_wall:.3f} s (the runs {sweep['wall_s']} s), "
              f"{sweep['federations_per_s']} federations/s")
    return dict(lax=dict(wall_s=wall, run_s=rec["wall_s"], launches=launches,
                        training_ticks=want, wire_rows=wire_rows,
                        honest_acc=rec["honest_acc"],
                        malicious_reputation=rec["malicious_reputation"],
                        cpu_wall_s=cpu_wall, cpu_run_s=cpu["wall_s"],
                        honest_acc_cpu=cpu["honest_acc"]),
               sharded=dict(wall_s=sh_wall, run_s=sharded["wall_s"],
                            honest_acc=sharded["honest_acc"]),
               toy=dict(wall_s=toy_wall, run_s=toy["wall_s"],
                        honest_acc=toy["honest_acc"]),
               sweep=dict(wall_s=sweep_wall, run_s=sweep["wall_s"],
                          cells=sweep["cells"], batches=sweep["batches"],
                          federations_per_s=sweep["federations_per_s"],
                          frontier=sweep["frontier"]["accuracy_under_attack"]))


def _timed_steps(torch, cfg):
    """DOTS_STEPS train steps of ``cfg`` from a fresh state, counted, then one
    more under the profiler: (seconds a step, peak bytes, launches, profile)."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train as launch_train
    from repro_torch.train import step as step_lib
    args = launch_train.parse_args(TRAIN_ARGS)
    dev = torch.device("cuda")
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in pipe.batch_at(s).items()}
               for s in range(DOTS_STEPS + 1)]
    batch_bytes = sum(t.numel() * t.element_size() for t in batches[0].values())
    state = step_lib.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                                      device=dev)
    torch.cuda.synchronize()
    # what the step takes: the state and one step's batch (phase 18b)
    arg_bytes = torch.cuda.memory_allocated() - base - DOTS_STEPS * batch_bytes
    ts = step_lib.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    secs, losses = [], []
    for s in range(DOTS_STEPS):
        t0 = time.perf_counter()
        state, met = ts(state, batches[s])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    with profiled() as prof:
        t0 = time.perf_counter()
        state, _ = ts(state, batches[DOTS_STEPS])
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() / 1e6 for e in measured_events(prof))
    del state, batches
    torch.cuda.empty_cache()
    return dict(step_s=secs, losses=losses, peak_bytes=peak, launches=launches,
                base_bytes=base, arg_bytes=arg_bytes,
                profile=dict(wall=pwall, busy=busy, idle=1 - busy / pwall))


def run_remat_dots(torch):
    """Phase 16d: remat="dots" against "full" at phase 14a's shape (llama3-8b
    full width, depth TRAIN_DEPTH, B 2 x S 4096): the first step's loss and
    grads from the same params, then DOTS_STEPS timed AdamW steps of each,
    counted, and one profiled."""
    import dataclasses
    import math

    from repro_torch import tree
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    from repro_torch.train import step as step_lib
    args = launch_train.parse_args(TRAIN_ARGS)
    base = _depth(TRAIN_DEPTH)
    dev = torch.device("cuda")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             TokenPipeline(base.vocab_size, args.batch, args.seq).batch_at(0).items()}
    params = transformer.init(torch.Generator(device="cuda").manual_seed(0), base, dev)
    full = step_lib.loss_and_grads(params, dataclasses.replace(base, remat="full"), batch)
    dots = step_lib.loss_and_grads(params, dataclasses.replace(base, remat="dots"), batch)
    loss_gap = abs(float(dots[0]) - float(full[0])) / abs(float(full[0]))
    gaps = {"/".join(map(str, p)): _rel_l2(d, f) for p, d, f in zip(
        _tree_paths(full[2]), tree.leaves(dots[2]), tree.leaves(full[2]))}
    worst = max(gaps, key=gaps.get)
    bitwise = torch.equal(dots[0], full[0]) and all(
        torch.equal(d, f) for d, f in zip(tree.leaves(dots[2]), tree.leaves(full[2])))
    print(f"remat dots (16d, llama3-8b depth {TRAIN_DEPTH}, B {args.batch} x S "
          f"{args.seq}): first step loss {float(dots[0]):.6f} vs full "
          f"{float(full[0]):.6f} (relative gap {loss_gap:.3e}, limit {DOTS_TOL}); "
          f"grads' relative L2 a leaf max {gaps[worst]:.4e} ({worst}, limit "
          f"{DOTS_TOL}); bitwise {bitwise}")
    if loss_gap > DOTS_TOL or gaps[worst] > DOTS_TOL:
        fail(f"remat dots: loss gap {loss_gap}, grad gap {gaps[worst]} ({worst})")
    del params, full, dots, batch
    torch.cuda.empty_cache()
    timed = {}
    for remat in ("full", "dots"):
        t = timed[remat] = _timed_steps(torch, dataclasses.replace(base, remat=remat))
        lc, want = t["launches"], TRAIN_FLASH_A_STEP * DOTS_STEPS
        print(f"remat {remat}: {DOTS_STEPS} steps {[round(s, 4) for s in t['step_s']]} s, "
              f"{sum(t['step_s'][1:]) / (DOTS_STEPS - 1):.4f} s a step after the "
              f"first; peak device memory {t['peak_bytes'] / 2**30:.3f} GiB; launches "
              f"{json.dumps(lc, sort_keys=True)}; profiled step: wall "
              f"{t['profile']['wall']:.4f} s, device busy {t['profile']['busy']:.4f} s, "
              f"idle share {t['profile']['idle']:.4f}")
        if (lc.get("flash_attention", 0) != want
                or lc.get("flash_attention_sm90", 0) != want):
            fail(f"remat {remat}: flash launches {lc}, not {TRAIN_FLASH_A_STEP} a "
                 f"step, all sm90 ({want})")
        if not all(math.isfinite(x) for x in t["losses"]):
            fail(f"remat {remat}: losses {t['losses']}")
    return dict(loss_gap=loss_gap, grad_rel_l2_max=gaps[worst], worst_leaf=worst,
                bitwise=bitwise, timed=timed)


def run_cli_and_dots(torch):
    """Phase 16: the command line's federation runs, then remat="dots"."""
    t_phase = time.perf_counter()
    cli = run_cli(torch)
    dots = run_remat_dots(torch)
    print(f"phase 16 took {time.perf_counter() - t_phase:.3f} s")
    return dict(cli=cli, dots=dots)


# ------------------------------------------------------------ phase 18
# the dry-run cell report (python -m repro_torch.launch.dryrun, --engine
# mesh: every cell traced on the meta device on the CPU; no kernel launches)
CELL_ROOFLINE_ARCHS = ("llama3-8b", "dbrx-132b", "llama4-maverick-400b-a17b")
CELL_TIMEOUT_S = 900          # 18a's command lines, from their start
CELL_ARG_TOL = 0.01           # 18b: predicted argument bytes vs allocated
CELL_PEAK_TOL = 0.25          # 18b: predicted peak vs max_memory_allocated
CELL_BOUND_SLACK = 1.05       # 18b: the roofline bound <= 1.05 x the step


def _cell_commands(out_dir):
    """18a's command lines: --all and --all --multi-pod, and the gossip
    round of each arch (ring ttl 1) and llama3-8b's (smallworld ttl 2,
    int8) in one interpreter: three processes, run side by side."""
    from repro_torch.configs import ARCH_IDS
    dfl = [["--arch", a, "--shape", "train_4k", "--dfl"] for a in ARCH_IDS] + [
        ["--arch", "llama3-8b", "--shape", "train_4k", "--dfl", "--topology",
         "smallworld", "--ttl", "2", "--compress", "int8"]]
    dfl = [[*a, "--out", os.path.join(out_dir, "dryrun_dfl_single_pod.json")]
           for a in dfl]
    mod = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    return [mod + ["--all", "--out", os.path.join(out_dir, "dryrun_single_pod.json")],
            mod + ["--all", "--multi-pod", "--out",
                   os.path.join(out_dir, "dryrun_multi_pod.json")],
            [sys.executable, "-c",
             "import sys\nfrom repro_torch.launch import dryrun\n"
             f"sys.exit(max(dryrun.main(a) for a in {dfl!r}))"]]


def _check_cell_records(name, records):
    from repro_torch.configs import SHAPES, cell_status, get_config
    for r in records:
        where = f"{name}: {r.get('arch')} x {r.get('shape')}"
        if r.get("status") == "skip":
            ok, why = cell_status(get_config(r["arch"]), SHAPES[r["shape"]])
            if ok or r["reason"] != why:
                fail(f"{where}: skipped ({r['reason']}), cell_status says {ok, why}")
            continue
        if r.get("status") != "ok" or "error" in r:
            fail(f"{where}: {r.get('status')} {r.get('error')}")
        if any(v is None for v in r["bytes_per_device"].values()):
            fail(f"{where}: bytes_per_device {r['bytes_per_device']}")
        if r["roofline"]["dominant"] not in ("compute", "memory", "collective"):
            fail(f"{where}: dominant {r['roofline']['dominant']}")
        ratio = r["useful_flops_ratio"]
        if r["step_kind"] == "train" and not 0 < ratio <= 1:
            fail(f"{where}: useful ratio {ratio}")


def _host_only_child():
    """In a child of ``start_cell_report_cli``: the lowest priority, so that
    the host-bound phases it runs beside keep their cores, and killed when
    chip_smoke exits."""
    import ctypes
    import signal
    os.nice(19)
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)       # PR_SET_PDEATHSIG


def start_cell_report_cli(root):
    """Start phase 18a's command lines: host-only traces on the meta device
    (no card visible to them), run beside phases 3-16 and waited for in
    phase 18; each writes its log to a file. They are killed if
    chip_smoke exits first."""
    import atexit
    import shutil
    out_dir = os.path.join(root, "build", "dryrun_cells")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), CUDA_VISIBLE_DEVICES="")
    procs = []
    for i, cmd in enumerate(_cell_commands(out_dir)):
        with open(os.path.join(out_dir, f"log{i}.txt"), "w") as log:
            procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                          stderr=subprocess.STDOUT,
                                          preexec_fn=_host_only_child))
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return dict(procs=procs, out_dir=out_dir, env=env, t0=time.perf_counter(),
                t0_epoch=time.time())


def run_cell_report_cli(started):
    """Phase 18a: wait for the cell report's command lines, check every
    record, render both tables and run the report module over the
    records."""
    from repro_torch.launch import report
    procs, out_dir, env = started["procs"], started["out_dir"], started["env"]
    t_wait = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, started["t0"] + CELL_TIMEOUT_S - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    waited = time.perf_counter() - t_wait
    logs = []
    for i in range(len(procs)):
        with open(os.path.join(out_dir, f"log{i}.txt")) as f:
            logs.append(f.read())
    # until the last log was written: the command lines' own end
    wall = max(os.path.getmtime(os.path.join(out_dir, f"log{i}.txt"))
               for i in range(len(procs))) - started["t0_epoch"]
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            fail(f"cell report: {p.args[-3:]} exited {p.returncode}:\n{log[-3000:]}")
    for log in logs:
        for line in log.splitlines():
            if line.startswith("[dryrun] done") or "gossip schedule" in line:
                print(f"  {line}")
    records = {}
    for name in ("dryrun_single_pod", "dryrun_multi_pod", "dryrun_dfl_single_pod"):
        with open(os.path.join(out_dir, name + ".json")) as f:
            records[name] = json.load(f)
        _check_cell_records(name, records[name])
        report.dryrun_table(records[name])
    if [len(records[n]) for n in records] != [40, 40, 11]:
        fail(f"cell report: {[len(v) for v in records.values()]} records")
    table = report.roofline_table(records["dryrun_single_pod"])
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.report",
                           "--dir", out_dir], env=env, capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0 or "Roofline" not in proc.stdout:
        fail(f"cell report: the report module: {proc.stderr[-2000:]}")
    print("cell report roofline rows (single pod, predictions from the H100 "
          "datasheet figures, not measurements):")
    print("\n".join(table.splitlines()[:2]))
    for line in table.splitlines()[2:]:
        if line.split(" | ")[0].lstrip("| ") in CELL_ROOFLINE_ARCHS:
            print(line)
    dfl = {(r["arch"], r["topology"]): r for r in records["dryrun_dfl_single_pod"]}
    sw = dfl["llama3-8b", "smallworld"]
    print(f"cell report dfl: llama3-8b smallworld ttl 2 int8: "
          f"{sw['gossip_schedule']['num_collectives']} exchanges, permute bytes "
          f"a device {sw['permute_bytes']:.4e} (ring fp32 "
          f"{dfl['llama3-8b', 'ring']['permute_bytes']:.4e}), useful ratio "
          f"{sw['useful_flops_ratio']:.3f}")
    n_ok = sum(r["status"] == "ok" for v in records.values() for r in v)
    print(f"cell report (18a): {n_ok} ok records of {sum(map(len, records.values()))}"
          f" in {wall:.3f} s from the build's end (three command lines side by "
          f"side at nice 19, beside phases 3-16), {waited:.3f} s of them waited "
          f"for in phase 18")
    return dict(wall_s=wall, waited_s=waited, ok=n_ok,
                roofline={line.split(" | ")[0].lstrip("| ") + "/" + line.split(" | ")[1]:
                          line for line in table.splitlines()[2:]
                          if line.split(" | ")[0].lstrip("| ") in CELL_ROOFLINE_ARCHS})


def check_cell_against_card(torch, timed, smi):
    """Phase 18b: the cell record of phase 14a's step (llama3-8b full width,
    depth TRAIN_DEPTH, B 2 x S 4096, on a 1 x 1 abstract mesh) under remat
    full and dots, against phase 16d's measurements of the same steps."""
    import dataclasses

    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    args = launch_train.parse_args(TRAIN_ARGS)
    shape = InputShape("train_4k", args.seq, args.batch, "train")
    mesh = mesh_lib.AbstractMesh(("data", "model"), (1, 1))
    base = _depth(TRAIN_DEPTH)
    out = {}
    for remat in ("full", "dots"):
        t = timed[remat]
        rec, counts = dryrun.cell_record(dataclasses.replace(base, remat=remat),
                                         shape, mesh)
        b, rf = rec["bytes_per_device"], rec["roofline"]
        step = sum(t["step_s"][1:]) / (len(t["step_s"]) - 1)
        batch_bytes = 2 * 4 * args.batch * args.seq          # int32 tokens, labels
        peak = t["peak_bytes"] - t["base_bytes"] - DOTS_STEPS * batch_bytes
        bound = max(rf["compute_s"], rf["memory_s"])
        flash = counts["kernel_calls"].get("flash_attention_sm90", 0)
        measured_flash = t["launches"].get("flash_attention_sm90", 0) / DOTS_STEPS
        mfu = rec["model_flops_global"] / (989e12 * step)
        row = dict(arg_pred=b["argument"], arg_meas=t["arg_bytes"],
                   peak_pred=b["peak"], peak_meas=peak, temp_pred=b["temp"],
                   compute_s=rf["compute_s"], memory_s=rf["memory_s"],
                   flops=rf["hlo_flops"], bytes=rf["hlo_bytes"], step_s=step,
                   bound_share=bound / step, mfu_6nd=mfu, flash=flash,
                   flash_measured=measured_flash, trace_s=rec["lower_s"])
        out[remat] = row
        print(f"cell vs card (18b, remat {remat}; {smi}): argument predicted "
              f"{b['argument'] / 2**30:.4f} GiB, allocated {t['arg_bytes'] / 2**30:.4f}"
              f" GiB; peak predicted {b['peak'] / 2**30:.4f} GiB (temp "
              f"{b['temp'] / 2**30:.4f}), measured {peak / 2**30:.4f} GiB; bound "
              f"max(compute {rf['compute_s']:.5f}, memory {rf['memory_s']:.5f}) s "
              f"= {bound / step:.4f} of the measured step {step:.5f} s; 6ND/(989e12 x "
              f"step) {mfu:.4f}; flash {flash:.0f} a step ({rec['roofline']['dominant']}"
              f" dominant), measured {measured_flash:.1f} sm90")
        if abs(b["argument"] / t["arg_bytes"] - 1) > CELL_ARG_TOL:
            fail(f"18b {remat}: argument {b['argument']} vs {t['arg_bytes']}")
        if abs(b["peak"] / peak - 1) > CELL_PEAK_TOL:
            fail(f"18b {remat}: peak {b['peak']} vs {peak}")
        if bound > CELL_BOUND_SLACK * step:
            fail(f"18b {remat}: bound {bound} s above the step's {step} s")
        if flash != measured_flash or flash != TRAIN_FLASH_A_STEP:
            fail(f"18b {remat}: flash {flash} a step vs {measured_flash} measured")
    return out


def run_cell_report(torch, started, timed, smi):
    """Phase 18: the cell report (18a, its command lines started after the
    build) and its record against the card (18b)."""
    t_phase = time.perf_counter()
    cli = run_cell_report_cli(started)
    card = check_cell_against_card(torch, timed, smi)
    print(f"phase 18 took {time.perf_counter() - t_phase:.3f} s")
    return dict(cli=cli, card=card)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.chain import scenarios  # noqa: F401  (import check)
    from repro_torch.configs.lenet_dfl import CONFIG
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lenet

    # phase 1: device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = smi_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {name} (count {count}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # phase 2: build
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {sorted(logs) or 'cached'} in {time.perf_counter() - t0:.2f} s")
    for src, log in sorted(logs.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {src}: {line.strip()}")
    smem = build.load("flash_attention_sm90").flash_attention_sm90_smem_bytes
    print("  flash_attention_sm90 dynamic shared memory a block: " + ", ".join(
        f"Dh {dh} {smem(dh)} B" for dh in ops.SM90_HEAD_DIMS))

    # phase 18a's command lines (host-only meta traces, niced) start here and
    # run beside phases 3-16
    cell_cli = start_cell_report_cli(root)

    # phase 3: kernels against their plain versions, and their times (the
    # flash plain version at B 4 needs ~17 GB: before the model is on the card)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = lenet.init(g, CONFIG, "cuda")
    q_err, dq_err = check_quantize(torch, params)
    wf_err = check_wfedavg(torch)
    fa_err = check_flash(torch)
    times = time_kernels(torch, params)
    times["flash_attention_sm90"] = time_flash(torch, *FLASH_MAIN)["sm90"]
    gemma = time_flash(torch, *FLASH_GEMMA_LOCAL, plain_iters=2)
    times["flash_attention"] = time_flash(torch, *smoke_flash_shape(),
                                          dtype="float32")["simt"]

    # phase 4: the LeNet main path, counted
    launches = run_main_path(torch)

    # phase 5: a reference on a small input, two seeded heap runs bitwise,
    # then where the time goes
    check_small_federation(torch)
    check_heap_twice(torch)
    check_roundtrip_kernels(torch, params)
    profile_window(torch)

    # phase 6: the serving path, counted
    out, serve_launches = run_serving(torch)
    launches["flash_attention_sm90"] = serve_launches["flash_attention_sm90"]

    # phase 7: prefill-then-decode consistency at full size, then where the
    # serving path's time goes
    check_serving_consistency(torch, out)
    profile_serving(torch, out)
    del out
    torch.cuda.empty_cache()

    # phase 8: the card (kernel) against the CPU (plain version) at smoke
    # size, the simt flash kernel's path (fp32, Dh 16), counted
    launches["flash_attention"] = check_smoke_card_vs_cpu(torch)

    # phase 9: the vectorized engine's delivery engines on the card, the
    # card against the CPU, two seeded runs bitwise
    check_lax_engines(torch)

    # phase 10: the paper's §VI-D federation on the vectorized engine,
    # counted, held to the JAX acceptance test's thresholds
    lax10 = run_lax_paper(torch, 10)
    if lax10["honest_acc"] < 0.90:
        fail(f"lax n=10: honest accuracy {lax10['honest_acc']:.4f} < 0.90")
    if not lax10["rep_mal"] < lax10["rep_hon"] - 0.1:
        fail(f"lax n=10: poisoners' reputation {lax10['rep_mal']:.4f} is not "
             f"below the honest {lax10['rep_hon']:.4f} by 0.1")

    # phase 11: 1024 nodes, counted and profiled; the wire kernels at its
    # stacked tree
    lax1024 = run_lax_paper(torch, 1024, profile_ticks=24)
    lax1024.pop("result")
    for kname, row in zip(("quantize", "dequantize"), time_lax_wire(torch, 1024)):
        times[kname]["lax"] = dict(
            stacked_n1024=row, launches_n10=lax10["launches"][kname],
            launches_n1024=lax1024["launches"][kname])

    # phase 12: batched runs — the toy batch on every engine, the §VI-D
    # sweep of 24 LeNet federations (counted), one run_sweep; the wire
    # kernels at the sweep's stacked tree (24 members x 2 trainers)
    check_batched_toy(torch)
    sgd_graph = check_sgd_graph(torch)
    sweep = run_lax_sweep(torch, lax10)
    sweep["sgd_graph"] = sgd_graph
    lax10_result = lax10.pop("result")
    run_sweep_smoke(torch)
    rows = 2 * sweep["batch"]
    for kname, row in zip(("quantize", "dequantize"),
                          time_lax_wire(torch, rows, f"sweep's stacked LeNet tree "
                                        f"({sweep['batch']} members x 2 trainers)")):
        times[kname]["lax"].update(
            {f"stacked_batch{sweep['batch']}": row,
             f"launches_batch{sweep['batch']}": sweep["launches"][kname]})
    print("lax runs: " + json.dumps({"n10": lax10, "n1024": lax1024,
                                     "sweep": sweep}, sort_keys=True))

    # phase 13: the sharded engine (S = 1 in process; S = 2 and 4 ranks on
    # the card under gloo) and the production gossip round at F = 4
    shard = run_sharded_and_gossip(torch, lax10_result, lax10["wall_s"])
    for kname in ("quantize", "dequantize"):
        times[kname]["sharded"] = {
            "launches_s1": shard["s1_launches"][kname],
            "launches_s2_over_ranks": shard["s2_launches"][kname],
            "launches_gossip_int8_round_over_ranks":
                shard["gossip"]["int8"][f"{kname}_a_round"]}
    print("sharded and gossip: " + json.dumps(shard, sort_keys=True))

    # phase 14: LM training (depth 4, B 2 x S 4096, full width) and the
    # federated LM launcher (F = 2 full width int8; the F = 4 -> 3 elastic run)
    lm = run_lm(torch)
    for kname, row in zip(("quantize", "dequantize"), lm["wire_sharded"]):
        times[kname]["sharded"]["stacked_5_trainers"] = row
    print("lm: " + json.dumps({k: v for k, v in lm.items() if k != "check"},
                              sort_keys=True, default=str))

    # phase 15: the rest of the LM zoo — rows 4h and 4r timed, every new arch
    # at smoke size card vs CPU, each at full width on the card, the
    # launcher's default arch (xlstm-125m) trains
    zoo = run_zoo(torch)
    print("zoo: " + json.dumps({k: v for k, v in zoo.items() if k != "rows"},
                               sort_keys=True, default=str))

    # phase 16: the dry-run command line's federation runs (lax LeNet held to
    # the JAX command line's record, counted; sharded over 2 ranks; the toy and
    # the default sweep) and remat="dots" against "full" at phase 14a's shape;
    # both wire kernels at the command line's stacked trainers' tree
    cli_dots = run_cli_and_dots(torch)
    rows = cli_dots["cli"]["lax"]["wire_rows"]
    cli_wire = time_lax_wire(torch, rows, f"command line's stacked LeNet tree "
                             f"({rows} trainers a tick)")
    print("cli and dots: " + json.dumps(cli_dots, sort_keys=True, default=str))

    # phase 18: the dry-run cell report on the meta device (every cell of
    # --all, --all --multi-pod and the gossip rounds, checked, the tables
    # rendered), and phase 14a's cell against 16d's measured steps
    cells = run_cell_report(torch, cell_cli, cli_dots["dots"]["timed"], smi)
    print("cell report: " + json.dumps(cells, sort_keys=True, default=str))

    # phase 19: Trinity-Mini — the grouped product at the cell's shape, and
    # the benchmark cell's three steps held to the plain reference
    trinity = run_trinity(torch)
    print("trinity: " + json.dumps({k: v for k, v in trinity.items() if k != "row"},
                                   sort_keys=True, default=str))

    # phase 20: the train step's clip and AdamW kernels at chatglm3-6b's
    # benchmark state, against their plain version and a library call
    adamw = run_adamw(torch)
    print("adamw: " + json.dumps({k: v for k, v in adamw.items()}, sort_keys=True,
                                 default=str))

    # phase 17: report
    kernels = []
    for kname, src, replaces, err in (
            ("quantize", "src/repro_torch/csrc/quantize.cu",
             "src/repro/kernels/quantize/quantize.py:37", q_err),
            ("dequantize", "src/repro_torch/csrc/quantize.cu",
             "src/repro/kernels/quantize/quantize.py:59", dq_err),
            ("wfedavg", "src/repro_torch/csrc/wfedavg.cu",
             "src/repro/kernels/wfedavg/wfedavg.py:31", wf_err),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:82",
             fa_err["simt", "float32"]),
            ("flash_attention_sm90", "src/repro_torch/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:82",
             fa_err["sm90", "bfloat16"])):
        t = times[kname]
        err = max(err, t.get("max_abs_err", 0.0))
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "call_ms": t["call_ms"], "shape": t["shape"],
                        "timing": t["timing"],
                        **{k: t[k] for k in ("per_leaf_ms", "llama3_layer", "lax",
                                             "sharded") if k in t}})
    # the training path's launch sites (phase 14): the forwards with the
    # lse, the sm90 backward, and the wire kernels at the federation's
    # llama3-8b depth-1 tree
    for kname, site, src, replaces, row in (
            ("flash_attention_sm90", "train_lse",
             "src/repro_torch/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:82",
             lm["rows"]["flash_attention_sm90"]),
            ("flash_attention", "train_lse", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:82",
             lm["rows"]["flash_attention"]),
            ("flash_attention_bwd_sm90", "train",
             "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
             "none (the JAX backward is jnp: src/repro/models/flash.py:315)",
             lm["rows"]["flash_attention_bwd_sm90"]),
            ("quantize", "llama3_depth1", "src/repro_torch/csrc/quantize.cu",
             "src/repro/kernels/quantize/quantize.py:37", lm["wire_lm"][0]),
            ("dequantize", "llama3_depth1", "src/repro_torch/csrc/quantize.cu",
             "src/repro/kernels/quantize/quantize.py:59", lm["wire_lm"][1])):
        kernels.append({"name": f"{kname}@{site}", "route": "cuda", "source": src,
                        "replaces": replaces, "launches": row["launches"],
                        "max_abs_err": row.get("max_abs_err", 0.0), "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row.get("library_ms"),
                        **{k: v for k, v in row.items() if k not in (
                            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                            "launches", "max_abs_err")}})
    # the zoo's launch sites (phase 15): hubert-xlarge's encoder (Dh 80,
    # bidirectional), the sm90 kernel that runs it and the simt kernel timed
    # at its shape (launched there no more: 0), and the sm90 kernel at
    # recurrentgemma's local layers (Dh 256, KV 1, window 2048)
    for kname, site, src, row in (
            ("flash_attention_sm90", "hubert_encoder",
             "src/repro_torch/csrc/flash_attention_sm90.cu", zoo["rows"]["hubert"]),
            ("flash_attention", "hubert_encoder", "src/repro_torch/csrc/flash_attention.cu",
             zoo["rows"]["hubert_simt"]),
            ("flash_attention_sm90", "recurrentgemma_local",
             "src/repro_torch/csrc/flash_attention_sm90.cu", zoo["rows"]["rg_local"])):
        kernels.append({"name": f"{kname}@{site}", "route": "cuda", "source": src,
                        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:82",
                        "launches": row["launches"], "max_abs_err": row["max_abs_err"],
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "call_ms": row["call_ms"],
                        "shape": row["shape"], "timing": row["timing"]})
    # this slice's launch sites (phase 16): the wire kernels on the command
    # line's lax run, and the sm90 kernel in the remat="dots" step (phase 14b's
    # row at the same shape: B 2 x S 4096, H 32, KV 8, Dh 128, with the lse)
    cli_launches = cli_dots["cli"]["lax"]["launches"]
    dots_launches = cli_dots["dots"]["timed"]["dots"]["launches"]
    for kname, site, src, replaces, row, n in (
            ("quantize", "dryrun_lax", "src/repro_torch/csrc/quantize.cu",
             "src/repro/kernels/quantize/quantize.py:37", cli_wire[0],
             cli_launches["quantize"]),
            ("dequantize", "dryrun_lax", "src/repro_torch/csrc/quantize.cu",
             "src/repro/kernels/quantize/quantize.py:59", cli_wire[1],
             cli_launches["dequantize"]),
            ("flash_attention_sm90", "train_dots",
             "src/repro_torch/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:82",
             lm["rows"]["flash_attention_sm90"], dots_launches["flash_attention_sm90"])):
        kernels.append({"name": f"{kname}@{site}", "route": "cuda", "source": src,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": row.get("max_abs_err", 0.0), "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row.get("library_ms"),
                        "shape": row.get("shape", f"{row.get('rows')} rows, "
                                                  f"{row.get('elements')} elements")})
    row = trinity["row"]
    kernels.append({"name": "grouped_mm@trinity_moe", "route": "library",
                    "source": "torch._grouped_mm (src/repro_torch/models/moe.py grouped_mm)",
                    "replaces": "none (new: the port's dropless expert layer)",
                    "launches": row["launches"], "max_abs_err": row["max_abs_err"],
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": "operations",
                    "library_ms": row["ms"], "shape": row["shape"],
                    "timing": row["timing"]})
    # the clip and AdamW rows (phase 20): 7 and 7n, each at the largest leaf and over
    # chatglm3-6b's whole state; the launches are phase 14a's (the launcher's
    # training run, llama3-8b at depth TRAIN_DEPTH), as the other training rows'
    train = lm["train"]
    for kname in ("adamw_step", "grad_sumsq"):
        for site in ("leaf", "state"):
            kernels.append({"name": f"{kname}@glm_{site}", "route": "cuda",
                            "source": "src/repro_torch/csrc/adamw.cu",
                            "replaces": "none (the JAX optimizer is jnp: "
                                        "src/repro/optim/optimizers.py adamw)",
                            "launches": train["launches"][kname],
                            "launches_at": f"llama3-8b depth {TRAIN_DEPTH}, "
                                           f"{train['steps']} training steps",
                            **adamw[site][kname]})
    f2 = times["wfedavg@f2"]
    print("wfedavg at f2.w: " + json.dumps(f2, sort_keys=True))
    print("flash at gemma3 local heads: " + json.dumps(
        gemma, sort_keys=True))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
