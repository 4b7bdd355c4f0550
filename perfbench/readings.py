"""The readings the check's limits are set from, at a cell's own size, on
the card (the benchmark's runs never run this):

    python3 perfbench/readings.py --workload <cell> --seeds 11,12,13 \\
        [--controls 2] [--faults 2] [--layers L] --out <file.jsonl>

For each seed: one set-up, the timed path's first unit and the check, as a
run makes them, and the numbers with their raw readings (each sampled
training's gaps, the follower's arithmetic varied) appended as one JSON
line. On the first ``--controls`` seeds also the control, and on the first
``--faults`` seeds each fault of ``faults.py`` planted under the timed path
(a LeNet cell reruns its first federation, the LM cell its set-up steps).
``--layers`` overrides the LM's depth (sizing it); the line then also
carries the allocator's peaks.
"""
from __future__ import annotations

import argparse
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
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import faults, harness  # noqa: E402


def _values(checks):
    return {k: float(v) for k, v, _ in checks}


def lenet(run, seed, control, fault_names):
    from perfbench.entries import lax_federation
    out = {}
    run.unit()
    out["sound"] = _values(run.check(variants=True))
    tr = run.readings["trainings"]
    out["trainings"] = {k: v.tolist() for k, v in tr.items()}
    out["follow_varied"] = run.readings["follow"]
    if control:
        out["control_ref_tf32"] = _values(run.check(control=lax_federation.tf32_control))
        out["control_ref_tf32_gaps"] = run.readings["trainings"]["gap"].tolist()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        run.k = 0
        run.unit()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        out["control_program_tf32"] = _values(run.check())
        out["control_program_tf32_gaps"] = run.readings["trainings"]["gap"].tolist()
    for name in fault_names:
        orig, sgd = dict(run.rec.orig), run.sc.__dict__.get("sgd_stacked")
        faults.LENET[name](run)
        run.k = 0
        run.unit()
        out[f"fault_{name}"] = _values(run.check())
        out[f"fault_{name}_gaps"] = run.readings["trainings"]["gap"].tolist()
        run.rec.orig = orig
        if sgd is None:
            run.sc.__dict__.pop("sgd_stacked", None)
    return out


def glm(run, seed, control, fault_names):
    from perfbench.entries import lm_local_steps
    out = {"losses": run.prog["losses"]}
    progs = {"sound": run.prog}
    for name in fault_names:
        fn = run.step.fn
        faults.GLM[name](run)
        progs[f"fault_{name}"] = run.prog
        run.step.fn = fn
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["reserved_gib"] = torch.cuda.max_memory_reserved() / 2 ** 30
    run.release()
    torch.cuda.empty_cache()
    t0 = time.time()
    ref = run.reference()
    out["reference_s"] = time.time() - t0
    for key, prog in progs.items():
        out[key] = lm_local_steps.compare(prog, ref)
    if control:
        out["control_fp8"] = lm_local_steps.compare(run.reference(operands="fp8"), ref)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(harness.THREADS)
    manifest, entry, cell, config = harness.cell_files(ROOT, args.workload)
    if args.layers:
        config["arch"]["num_layers"] = args.layers
    mod = harness.load_module(ROOT / "perfbench" / "entries" / f"{cell['entry']}.py",
                              f"perfbench_entry_{cell['entry']}")
    read = lenet if cell["entry"] == "lax_federation" else glm
    names = sorted(faults.LENET if read is lenet else faults.GLM)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        bench = harness.Bench(args.workload, cell, config, seed, torch.device("cuda"), 1)
        run = mod.setup(bench)
        line = {"seed": seed, "setup_s": time.time() - t0}
        line.update(read(run, seed, i < args.controls, names if i < args.faults else []))
        line["seconds"] = time.time() - t0
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps({k: v for k, v in line.items()
                          if not isinstance(v, list) and not k.endswith("trainings")}),
              flush=True)
        del run
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
