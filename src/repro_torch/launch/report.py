"""Render the dry-run tables from the cell records.

Port of the JAX package's ``repro.launch.report``, for one H100 80GB a
device. It reads the records of ``python -m repro_torch.launch.dryrun``
(the port's, on the meta device) and the JAX package's alike: the keys are
the same.

    PYTHONPATH=src python -m repro_torch.launch.report --dir experiments
"""
from __future__ import annotations

import argparse
import json
import os

HBM_PER_CHIP = 80e9  # H100 80GB

_NOTE = {
    "compute": ("compute-bound: raise tensor-core utilization (larger per-device "
                "batch or fused kernels); already near the best case"),
    "memory": ("memory-bound: cut activation traffic (flash bwd recompute, "
               "grad accumulation, bf16 residuals) or increase arithmetic "
               "intensity per HBM byte"),
    "collective": ("collective-bound: shrink cross-device bytes (DFL gossip "
                   "instead of sync all-reduce, int8 payloads, kv-head-"
                   "aligned TP degree)"),
}


def _fits(rec) -> str:
    b = rec.get("bytes_per_device", {})
    tot = (b.get("argument") or 0) + (b.get("temp") or 0)
    return f"{tot/1e9:.1f}" + ("" if tot < HBM_PER_CHIP else " **(>80G)**")


def dryrun_table(records) -> str:
    rows = ["| arch | shape | mesh | status | args+temp GB/dev | peak GB/dev "
            "| GFLOP/dev | collectives (count) |",
            "|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r.get("status") == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | — | SKIP: "
                        f"{r['reason']} | — | — | — | — |")
            continue
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh')} | "
                        f"ERROR {r.get('error','')[:60]} | — | — | — | — |")
            continue
        rf = r["roofline"]
        colls = ", ".join(f"{k}:{v}" for k, v in sorted(rf["collectives"].items()))
        peak = (r["bytes_per_device"].get("peak") or 0) / 1e9
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | {_fits(r)} | "
            f"{peak:.1f} | {rf['hlo_flops']/1e9:.0f} | {colls} |")
    return "\n".join(rows)


def roofline_table(records) -> str:
    """One row an ok, non-dfl record (a gossip round is not a step: its
    useful ratio compares the train shape's 6ND with one round)."""
    rows = ["| arch | shape | compute s | memory s | collective s | dominant "
            "| roofline frac | model GFLOP (6ND) | useful ratio | bottleneck note |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r.get("status") != "ok" or r.get("dfl"):
            continue
        rf = r["roofline"]
        ratio = r.get("useful_flops_ratio")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.3f} | "
            f"{rf['memory_s']:.3f} | {rf['collective_s']:.3f} | "
            f"{rf['dominant']} | {rf['roofline_fraction']:.3f} | "
            f"{r['model_flops_global']/1e9:.0f} | "
            f"{ratio:.3f} | {_NOTE[rf['dominant']]} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--dir", default="experiments")
    args = ap.parse_args(argv)

    def load(name):
        p = os.path.join(args.dir, name)
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return json.load(f)

    single = load("dryrun_single_pod.json")
    multi = load("dryrun_multi_pod.json")
    dfl_s = load("dryrun_dfl_single_pod.json")
    dfl_m = load("dryrun_dfl_multi_pod.json")

    print("## Dry-run — single pod (16x16 = 256 H100s)\n")
    print(dryrun_table(single))
    print("\n## Dry-run — multi-pod (2x16x16 = 512 H100s)\n")
    print(dryrun_table(multi))
    print("\n## Dry-run — DFL gossip round (the paper's technique)\n")
    print("### single pod (fed axis = data: 16 replicas x TP-16)\n")
    print(dryrun_table(dfl_s))
    print("\n### multi-pod (fed axis = pod: 2 replicas x 16x16)\n")
    print(dryrun_table(dfl_m))
    print("\n## Roofline — single pod, per cell (H100 80GB datasheet: 989 TF/s "
          "bf16, 3.35 TB/s HBM, 50 GB/s/link)\n")
    print(roofline_table(single))


if __name__ == "__main__":
    main()
