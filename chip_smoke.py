"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and never
prints its last line):

1. the device, its ``nvidia-smi`` name and power limit, TF32 off for
   convolutions and matrix products;
2. build every CUDA kernel of the main path from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together) and print the build time;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it: quantize/dequantize bitwise on every
   LeNet leaf's last-axis blocking, on flat 256-column rows, on a ragged
   row count and on bf16; wfedavg within rtol/atol 1e-6 at N = 10 and
   D = 94 080 / 10 080 and on ragged and misaligned D. Time each one
   (device time per call from the profiler, else CUDA events) beside its
   bound, its plain version and, where one PyTorch call computes the same
   function, that call;
4. the main path: the paper's §VI LeNet federation (``lenet_paper_setup``:
   10 nodes, 20% gaussian random-model poisoners, Dirichlet(1) shards,
   kregular(10, 2), ttl 2, 108 ticks) with int8 wire payloads and the
   wfedavg kernel (``use_kernel=True``) on the heap simulator; launch
   counts are zeroed just before it and read just after, and every kernel
   must have launched;
5. a small federation run on the card (kernels) and on the CPU (plain
   versions) from the same params must agree; then a 36-tick window of
   the main path is profiled (device busy/idle share, host split by
   function);
6. one JSON line with every kernel's numbers, the ``nvidia-smi`` line, and
   the result line.

It exits non-zero without a result when CUDA is unavailable or when the
repository's ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


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


def device_ms(fn, iters: int):
    """(ms, method, kernel names): device time per call, the sum of every
    kernel and copy the profiler saw on the card over ``iters`` calls; CUDA
    events when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    on_card = [e for e in prof.events() if getattr(e, "device_type", None) == cuda]
    total_us = sum(e.time_range.elapsed_us() for e in on_card)
    names = sorted({e.name for e in on_card})
    if total_us > 0:
        return total_us / 1e3 / iters, "profiler", names
    return event_ms(fn, iters), "events", names


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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
    return q_err, dq_err


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
    """Times at the main path's largest shapes (LeNet f1.w) and the f2.w
    FedAvg leaf; returns the per-kernel rows of the JSON line."""
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref
    from repro_torch.kernels.wfedavg import ops as wf_ops
    from repro_torch.kernels.wfedavg.ref import wfedavg_ref

    iters = 200
    x = lenet_params["f1"]["w"].contiguous()            # (784, 120)
    r, c = x.shape
    q, s = q_ops.quantize_rows(x)
    rows = {}

    def row(name, fn, plain, library, nbytes, ops, shape):
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
                          shape=shape, timing=timing)
        lib = "null" if lib_ms is None else f"{lib_ms:.5f}"
        print(f"time {name:10s} {shape:24s} kernel_ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} library_ms={lib} bound_ms={b_ms:.6f} "
              f"({b_by}) call_ms={call:.5f} [{timing}; kernel events {names}]")

    row("quantize", lambda: q_ops.quantize_rows(x), lambda: quantize_ref(x), None,
        r * c * 4 + r * c + r * 4, 6 * r * c, f"({r}, {c}) fp32")
    row("dequantize", lambda: q_ops.dequantize_rows(q, s),
        lambda: dequantize_ref(q, s), lambda: torch.mul(q, s),
        r * c + r * 4 + r * c * 4, r * c, f"({r}, {c}) int8")
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


def profile_window(torch, ticks: int = 36):
    """Where the main path's time goes, on two fresh runs of its first
    ``ticks`` ticks (after the main path warmed the card): the device's busy
    and idle share from the profiler, and the host's split by function from
    cProfile. Both profilers slow the host, so the shares are approximate."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.chain import scenarios
    from repro_torch.core.reputation import IMPL2

    def fresh():
        sc, spec, topo, cfg = scenarios.lenet_paper_setup(
            n=10, ticks=ticks, compress="int8")
        return scenarios.make_heap_simulator(sc, topo, spec, IMPL2, cfg,
                                             use_kernel=True, device="cuda")

    sim = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == cuda:
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


# ------------------------------------------------------------------ main
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
            if "Used" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # phase 3: kernels against their plain versions
    g = torch.Generator(device="cuda").manual_seed(0)
    params = lenet.init(g, CONFIG, "cuda")
    q_err, dq_err = check_quantize(torch, params)
    wf_err = check_wfedavg(torch)
    times = time_kernels(torch, params)

    # phase 4: the main path, counted
    launches = run_main_path(torch)

    # phase 5: a reference on a small input, then where the time goes
    check_small_federation(torch)
    profile_window(torch)

    # phase 6: report
    kernels = []
    for kname, src, replaces, err in (
            ("quantize", "src/repro_torch/csrc/quantize.cu",
             "src/repro/kernels/quantize/quantize.py:37", q_err),
            ("dequantize", "src/repro_torch/csrc/quantize.cu",
             "src/repro/kernels/quantize/quantize.py:59", dq_err),
            ("wfedavg", "src/repro_torch/csrc/wfedavg.cu",
             "src/repro/kernels/wfedavg/wfedavg.py:31", wf_err)):
        t = times[kname]
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "call_ms": t["call_ms"], "shape": t["shape"],
                        "timing": t["timing"]})
    f2 = times["wfedavg@f2"]
    print("wfedavg at f2.w: " + json.dumps(f2, sort_keys=True))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
