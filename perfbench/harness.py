"""Run one cell of ``BENCHMARK.json`` once and print its result line.

A run: set-up (the entry's ``setup``: inputs and weights from the seed on
the device, the program built and warmed up on the cell's own shapes),
then the measured window: whole units of work (the entry's ``unit``), one
after another, until ``--seconds`` have passed, ending with the unit
during which they ran out; then the peak memory is read, the program's
state freed and the entry's ``check`` compares what the window produced
with the plain reference. ``--trace 1`` runs the window under the profiler
and reports the per-layer metrics instead of the end-to-end ones.

Everything is found by name: ``workloads/<cell>.json`` names its
``config`` (``configs/<config>.json``) and its ``entry``
(``entries/<entry>.py``); each metric of ``BENCHMARK.json`` is read by
``metrics/<metric>.py``'s ``read(ctx)``, which returns a number or None
(nothing to read: the metric is left out of the line).
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "repro")
TRACE_S = 10.0      # a traced run profiles whole units from the second on, this long
THREADS = 2         # host threads of the run's process (one process, few threads)


class Bench:
    """What an entry is given: the cell's and its configuration's files,
    the seed and the device."""

    def __init__(self, name, cell, config, seed, device, chips):
        self.name, self.cell, self.config = name, cell, config
        self.seed, self.device, self.chips = seed, device, chips


class Ctx:
    """What a metric's reader is given."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(root: Path, workload: str):
    """(manifest entry, cell file, configuration file) of a cell."""
    manifest = load_json(root / "BENCHMARK.json")
    entries = [w for w in manifest["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = load_json(root / "perfbench" / "workloads" / f"{workload}.json")
    config = load_json(root / "perfbench" / "configs" / f"{entries[0]['config']}.json")
    return manifest, entries[0], cell, config


def metrics_of(manifest: dict, workload: str, kind: str):
    """The manifest's ``end_to_end`` or ``per_layer`` metrics this cell
    reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or workload in m["workloads"]]


def read_metrics(root: Path, metrics, ctx) -> dict:
    out = {}
    for m in metrics:
        reader = load_module(root / "perfbench" / "metrics" / f"{m['name']}.py",
                             "perfbench_metric")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def banned_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def run_cell(workload, seed, seconds, trace, *, device=None, t0=None, root=ROOT,
             cell_override=None, config_override=None, entry_hook=None):
    """One run; returns (result line, [(check, value, limit)]). ``device``
    None: the card, which must be there; tests pass the CPU and small
    shapes (``cell_override``, ``config_override``) and break the path underneath
    (``entry_hook(run)``)."""
    import torch
    from torch.profiler import record_function

    t0 = time.time() if t0 is None else t0
    torch.set_num_threads(THREADS)
    t_import = time.time()
    manifest, entry, cell, config = cell_files(root, workload)
    if cell_override:
        cell = cell_override(cell)
    if config_override:
        config = config_override(config)
    chips = int(entry["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"needs {chips} CUDA device(s); have "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
    dev = torch.device(device)
    gpu = dev.type == "cuda"
    bench = Bench(workload, cell, config, int(seed), dev, chips)
    mod = load_module(root / "perfbench" / "entries" / f"{cell['entry']}.py",
                      f"perfbench_entry_{cell['entry']}")
    t_entry = time.time()
    run = mod.setup(bench)
    if entry_hook is not None:
        entry_hook(run)

    def sync():
        if gpu:
            torch.cuda.synchronize()

    sync()
    print(f"perfbench: set-up: to torch {t_import - t0:.3f} s, to the entry "
          f"{t_entry - t_import:.3f} s, the entry {time.time() - t_entry:.3f} s",
          file=sys.stderr)
    counts = collections.Counter()
    summary = prof = None
    traced = collections.Counter()
    start = time.time()
    setup_s = start - t0
    units = 0
    while True:
        if trace and units >= 1 and summary is None and prof is None:
            from perfbench import trace as trace_lib
            ctxmgr = trace_lib.profiled()
            prof = ctxmgr.__enter__()
            t_trace, traced_s = time.time(), 0.0
        t_unit = time.time()
        with record_function("perfbench.unit"):
            c = run.unit()
        sync()
        print(f"perfbench: unit {units} {time.time() - t_unit:.3f} s", file=sys.stderr)
        counts.update(c)
        units += 1
        if prof is not None and summary is None:
            traced.update(c)
            traced_s = time.time() - t_trace
            if traced_s >= TRACE_S or time.time() - start >= seconds:
                ctxmgr.__exit__(None, None, None)
                t1 = time.time()
                summary = trace_lib.summarize(prof, traced_s)
                print(f"perfbench: traced {traced_s:.3f} s; the profiler's stop "
                      f"{t1 - t_trace - traced_s:.3f} s, its reading "
                      f"{time.time() - t1:.3f} s", file=sys.stderr)
                prof = ctxmgr = None
        if time.time() - start >= seconds and (not trace or summary is not None):
            break
    window_s = time.time() - start
    peak = torch.cuda.max_memory_allocated(dev) if gpu else 0
    run.release()
    if gpu:
        torch.cuda.empty_cache()
    t_check = time.time()
    checks = run.check()
    print(f"perfbench: the check {time.time() - t_check:.3f} s", file=sys.stderr)
    ok = all(v <= lim for _, v, lim in checks)
    if trace:
        counts, window_s = traced, summary["window_s"]
    ctx = Ctx(cell=cell, config=config, counts=counts, window_s=window_s,
              setup_s=setup_s, memory_peak_bytes=peak, trace=summary)
    kind = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(root, metrics_of(manifest, workload, kind), ctx)
    device_info = {"platform": "gpu" if gpu else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if gpu else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(ok), "attempted": int(counts["units"]), "failed": 0,
            "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = window_s
        line["breakdown"] = summary["breakdown"]
    line["checks"] = {name: {"value": float(v), "limit": float(lim)}
                      for name, v, lim in checks}
    return line, checks


def main(argv=None, t0=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        line, checks = run_cell(args.workload, args.seed, args.seconds, args.trace, t0=t0)
    except SystemExit as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    found = banned_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for name, v, lim in checks:
        print(f"check {name} {float(v)!r} limit {float(lim)!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
