"""The readings the MoE training cell's limits are set from, at the cell's
own size, on the card (the benchmark's runs never run this):

    python3 perfbench/moe_readings.py [--workload trinity-mini.local-steps] \\
        --seeds 11,12,13 [--controls 2] [--faults 2] --out <file.jsonl>

For each seed: one set-up as a run makes it (three watched steps) and the
check's numbers against the reference. On the first ``--controls`` seeds
also the control: the reference itself with every product's operands
rounded to float8 e4m3 (the precision below the configuration's bf16), held
to the fp32 reference. On the first ``--faults`` seeds each fault of
``FAULTS`` planted under the program's step (set-up's steps run again from
fresh params with the fault in place), each held to a reference that
follows its own routing choices. One JSON line a seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.reference.glm import round_fp8  # noqa: E402


def _patch(owner, name, wrap):
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    return lambda: setattr(owner, name, orig)


def expert_fp8(run):
    """The grouped products' operands rounded to float8 e4m3 (a per-tensor
    scale over the rows the products compute) and back to bf16."""
    def wrap(orig):
        def grouped_mm(x, w, offs, rows=None):
            end = int(offs[-1])           # the rows past it are undefined
            xr = x.clone()
            xr[:end] = round_fp8(x[:end].float()).to(x.dtype)
            return orig(xr, round_fp8(w.float()).to(w.dtype), offs, rows)
        return grouped_mm
    return _patch(run.moe_lib, "grouped_mm", wrap)


def bias_left_out(run):
    """No expert-bias update after the steps."""
    return _patch(run.moe_lib, "update_expert_bias", lambda orig: lambda *a: None)


def held_shifted(run):
    """The layer told it holds experts [lo + 1, hi + 1) while its stacks are
    [lo, hi)'s."""
    def wrap(orig):
        def moe_dropless(p, cfg, x, bias=None):
            lo, hi = cfg.moe.held_range
            moe = dataclasses.replace(cfg.moe, held=(lo + 1, hi + 1))
            return orig(p, dataclasses.replace(cfg, moe=moe), x, bias)
        return moe_dropless
    return _patch(run.moe_lib, "moe_dropless", wrap)


def gate_left_out(run):
    """Attention's output gate skipped (its params still there)."""
    from repro_torch.models import attention

    def wrap(orig):
        def output(p, cfg, x, ctx):
            return orig(p, dataclasses.replace(cfg, attn_gate=False), x, ctx)
        return output
    return _patch(attention, "_output", wrap)


FAULTS = {"expert_fp8": expert_fp8, "bias_left_out": bias_left_out,
          "held_shifted": held_shifted, "gate_left_out": gate_left_out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="trinity-mini.local-steps")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--fault-names", default=",".join(FAULTS),
                    help="the faults to plant, comma-separated")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(harness.THREADS)
    manifest, entry, cell, config = harness.cell_files(ROOT, args.workload)
    mod = harness.load_module(ROOT / "perfbench" / "entries" / f"{cell['entry']}.py",
                              f"perfbench_entry_{cell['entry']}")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        bench = harness.Bench(args.workload, cell, config, seed, torch.device("cuda"), 1)
        run = mod.setup(bench)
        line = {"seed": seed, "setup_s": time.time() - t0, "losses": run.prog["losses"]}
        progs = {"sound": (run.prog, run.tap.steps)}
        for name in (args.fault_names.split(",") if i < args.faults else ()):
            undo = FAULTS[name](run)
            try:
                run.rerun()
            finally:
                undo()
            progs[f"fault_{name}"] = (run.prog, run.tap.steps)
        line["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        run.release()
        torch.cuda.empty_cache()
        rate = run.cfg.moe.bias_rate
        for key, (prog, steps) in progs.items():
            run.tap.steps = steps
            t1 = time.time()
            ref = run.reference()
            line[f"{key}_reference_s"] = time.time() - t1
            line[key] = mod.gaps(prog, ref, rate)
            line[key]["route_lag"] = ref["route_lag"]
            if key == "sound" and i < args.controls:
                run.tap.steps = progs["sound"][1]
                fp8 = run.reference(operands="fp8")
                line["control_fp8"] = mod.gaps(fp8, ref, rate)
                line["control_fp8"].update(route_off=float(fp8["route_off"]),
                                           route_lag=fp8["route_lag"])
        line["seconds"] = time.time() - t0
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
