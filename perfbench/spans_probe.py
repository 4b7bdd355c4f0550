"""One traced run of a cell, as ``run.py --trace 1`` makes it, that also
reads the program's spans over the same window:

    python3 perfbench/spans_probe.py --workload <cell> --seed <n> --seconds <s> --out <file>

from the root of a checkout. Prints the result line as ``run.py`` does, and
writes it to ``<file>`` (JSON) with ``spans.span_table`` of the traced
window (``spans``), ``spans.shares`` of it (``shares``) and the seconds the
table took to read. Until ``trace.summarize`` returns the span table itself,
this is how the numbers of ``PERF.md`` §5 are taken.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run  # noqa: E402  (the benchmark's environment: caches, threads, paths)

from perfbench import harness, spans, trace  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    found = {}
    summarize = trace.summarize

    def with_spans(prof, window_s):
        summary = summarize(prof, window_s)
        t = time.time()
        table = spans.span_table(prof.profiler.kineto_results.events())
        found.update(span_table_s=time.time() - t, spans=table,
                     shares=spans.shares(table, summary["window_s"]))
        return summary

    trace.summarize = with_spans
    line, _ = harness.run_cell(args.workload, args.seed, args.seconds, 1, t0=run.T0)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(line=line, banned=harness.banned_modules(),
                                        **found), indent=1))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
