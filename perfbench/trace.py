"""The traced window: ``torch.profiler`` over the CPU and the card, and
what the metrics read from it.

Once CUDA timing events have been used in a process, a profiler session
on the H100 drops the device records it collects first, so a window opens
with a burst of tiny kernels, a synchronize and a short idle pad, and the
measured body runs inside a ``record_function`` range: only device events
that start after that range begins count (the program's chip tests found
this; the same opening is copied here).
"""
from __future__ import annotations

import bisect
import contextlib
import time

import torch

MEASURED = "perfbench.window"
ABSORB = 64
PAD_S = 0.02
GAPS_ATTRIBUTED = 2000   # longest gaps also named by their host op


@contextlib.contextmanager
def profiled():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad = torch.zeros(1, device="cuda")
        for _ in range(ABSORB):
            pad.add_(1)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        with record_function(MEASURED):
            yield prof


def summarize(prof, window_s: float) -> dict:
    """Device time by name (seconds, events), busy seconds (the union of
    every kernel, copy and set on the card), and the breakdown: the device
    ops that took most time; the idle time by the benchmark's range the
    host was in when each gap began, then the longest gaps by the host op
    that was running."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    start = min(e.start_ns() for e in events if e.name() == MEASURED
                and e.device_type() != cuda)
    dev, host, stages = [], [], []
    for e in events:
        s = e.start_ns()
        if s < start:
            continue
        if e.device_type() == cuda:
            # a record_function range mirrored on the card's timeline spans
            # its kernels and the gaps between them: not device work
            if not e.is_user_annotation() and not e.name().startswith("perfbench."):
                dev.append((s, s + e.duration_ns(), e.name()))
        elif e.name() == MEASURED:
            continue
        elif e.name().startswith("perfbench."):
            stages.append((s, s + e.duration_ns(), e.name()))
        else:
            host.append((s, s + e.duration_ns(), e.name()))
    by_name = {}
    for s, t, name in dev:
        sec, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (sec + (t - s) / 1e9, cnt + 1)
    dev.sort()
    busy, gaps = 0, []
    cur_s = cur_t = None
    for s, t, _ in dev:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
                gaps.append((s - cur_t, cur_t))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    idle = {}
    # every gap by the benchmark's innermost range the host was in (the
    # scenario's stacked calls, else the unit's own code)
    stages.sort()
    inner = [x for x in stages if x[2] != "perfbench.unit"]
    starts = [x[0] for x in inner]
    for length, at in gaps:
        i = bisect.bisect_right(starts, at) - 1
        name = inner[i][2] if i >= 0 and inner[i][1] >= at else "perfbench.unit"
        idle[name] = idle.get(name, 0.0) + length / 1e9
    entries = sorted(idle.items(), key=lambda kv: -kv[1])
    # then the longest gaps by the innermost host op that was running
    host.sort()
    hstarts = [h[0] for h in host]
    ops = {}
    gaps.sort(reverse=True)
    for length, at in gaps[:GAPS_ATTRIBUTED]:
        hi = bisect.bisect_right(hstarts, at)
        best = None
        for j in range(hi - 1, max(-1, hi - 400), -1):
            s, t, nm = host[j]
            if t >= at and (best is None or s > best[0]):
                best = (s, nm)
        name = f"longest gaps: {best[1] if best else '(no host op)'}"
        ops[name] = ops.get(name, 0.0) + length / 1e9
    entries += sorted(ops.items(), key=lambda kv: -kv[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"by_name": by_name, "busy_s": busy / 1e9, "window_s": window_s,
            "breakdown": {
                "device_ops": [[k, v[0]] for k, v in top],
                "idle_gaps": [[k, v] for k, v in entries[:10]]}}


def kernel_time(trace: dict, fragment: str):
    """(seconds, events) of the device ops whose name holds ``fragment``."""
    sec = cnt = 0
    for name, (s, c) in trace["by_name"].items():
        if fragment in name:
            sec, cnt = sec + s, cnt + c
    return sec, cnt
