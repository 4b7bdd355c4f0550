"""The program's own spans in a traced window: the ``dfl.*`` ranges that
``repro_torch.core.spans.span`` opens while a profiler runs, each with the
device time, launches and idle it holds.

``span_table(events)`` reads the kineto events of a window that
``trace.profiled()`` recorded (``prof.profiler.kineto_results.events()``),
and ``shares(table, window_s)`` computes from it the per-layer numbers the
spans are for. ``trace.summarize`` does not call them yet: the benchmark's
per-layer metrics that would read them wait for that one edit (``PERF.md``
§7); ``spans_probe.py`` runs a cell with both.
"""
from __future__ import annotations

import bisect
import re

import torch

from perfbench.trace import MEASURED

SPAN = "dfl."                            # the program's spans
ENGINE = ("dfl.simlax.", "dfl.attack", "dfl.wire", "dfl.scenario.test")  # the engine's own
NO_SPAN = "(no span)"                    # what no span holds
RUNTIME = re.compile(r"cu(da)?[A-Z]")    # a CUDA API call: cudaX or the lower-level cuX


def _is_launch(name: str) -> bool:
    """A runtime call that puts work on the card: a kernel or graph launch,
    an async copy or set."""
    return (name.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch"))
            or (name.startswith(("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset"))
                and "Async" in name))


class _Nest:
    """The spans of one thread, nested: for a time, those open, innermost
    first."""

    def __init__(self, spans):
        spans = sorted(spans, key=lambda x: (x[0], -x[1]))
        self.names = [name for _, _, name in spans]
        self.parent, self.times, self.inner = [], [], []
        stack = []

        def close_until(at):
            while stack and spans[stack[-1]][1] <= at:
                self.times.append(spans[stack.pop()][1])
                self.inner.append(stack[-1] if stack else -1)

        for i, (s, _, _) in enumerate(spans):
            close_until(s)
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
            self.times.append(s)
            self.inner.append(i)
        close_until(float("inf"))

    def chain(self, at):
        k = bisect.bisect_right(self.times, at) - 1
        i = self.inner[k] if k >= 0 else -1
        out = []
        while i >= 0:
            out.append(self.names[i])
            i = self.parent[i]
        return out


def span_table(events) -> dict:
    """For each span name in the window (from the start of ``MEASURED`` on):
    calls and inclusive host seconds; device seconds, launches and idle
    seconds, each *self* (the innermost span) and *total* (under any span of
    that name); ``NO_SPAN`` holds the rest. Empty when the program opened no
    span.

    Device work is every kernel, copy and set on the card (a range mirrored
    there is not); idle is the gaps between them, as ``trace.summarize``
    counts them. A kernel or copy belongs to the op its runtime call ran in
    (kineto's linked correlation id), on that op's thread at the op's
    start; one launched outside any op (a captured graph's replay, a kernel
    launched through ``ctypes``) to its runtime call (the CUPTI correlation
    id), on the thread that call's other launches name. A launch is placed
    the same way. A thread other than the host's main one (the autograd
    engine's) hangs under what the main thread has open at that time. An
    idle gap belongs to the spans open on the main thread when it began."""
    cuda = torch.autograd.DeviceType.CUDA
    start, main = min((e.start_ns(), e.start_thread_id()) for e in events
                      if e.name() == MEASURED and e.device_type() != cuda)
    spans, ops, runtime, kernels = [], {}, [], []
    for e in events:
        s, name = e.start_ns(), e.name()
        if e.device_type() == cuda:
            if (s >= start and not e.is_user_annotation()
                    and not name.startswith(("perfbench.", SPAN))):
                kernels.append((s, s + e.duration_ns(), e.correlation_id(),
                                e.linked_correlation_id()))
        elif RUNTIME.match(name):
            runtime.append((e.correlation_id(), e.linked_correlation_id(),
                            e.start_thread_id(), s, _is_launch(name)))
        else:
            # the program's ops, from before the window too
            ops[e.correlation_id()] = (e.start_thread_id(), s)
            if name.startswith(SPAN) and s >= start:
                spans.append((e.start_thread_id(), s, s + e.duration_ns(), name))
    if not spans:
        return {}

    by_thread = {}
    for tid, s, t, name in spans:
        by_thread.setdefault(tid, []).append((s, t, name))
    nests = {tid: _Nest(v) for tid, v in by_thread.items()}
    top = nests.get(main, _Nest([]))

    def chain(tid, at):
        inner = nests[tid].chain(at) if tid != main and tid in nests else []
        return inner + top.chain(at)

    calls, thread_of = {}, {}     # a runtime call by its CUPTI id; a call's thread
    for corr, link, tid, s, _ in runtime:
        calls[corr] = (link, tid, s)
        if link in ops:
            thread_of.setdefault(tid, ops[link][0])

    def origin(link, corr):
        """(thread, time) a kernel or launch belongs to, or ()."""
        if link and link in ops:
            return ops[link]
        call = calls.get(corr)
        if call is None:
            return ()
        if call[0] and call[0] in ops:
            return ops[call[0]]
        return thread_of.get(call[1], main), call[2]

    table = {}

    def row(name):
        return table.setdefault(name, {
            "calls": 0, "host_s": 0.0, "device_self_s": 0.0, "device_total_s": 0.0,
            "launches_self": 0, "launches_total": 0, "idle_self_s": 0.0,
            "idle_total_s": 0.0})

    def add(names, self_key, total_key, amount):
        row(names[0] if names else NO_SPAN)[self_key] += amount
        for name in set(names):
            row(name)[total_key] += amount

    for _, s, t, name in spans:
        r = row(name)
        r["calls"] += 1
        r["host_s"] += (t - s) / 1e9
    for s, t, corr, link in kernels:
        at = origin(link, corr)
        add(chain(*at) if at else [], "device_self_s", "device_total_s", (t - s) / 1e9)
    for corr, link, _, s, launch in runtime:
        if launch and s >= start:
            at = origin(link, corr)
            add(chain(*at) if at else [], "launches_self", "launches_total", 1)
    # idle: the gaps between the device work's busy intervals, as
    # trace.summarize finds them, each where it began
    kernels.sort()
    cur_t = None
    for s, t, _, _ in kernels:
        if cur_t is not None and s > cur_t:
            add(top.chain(cur_t), "idle_self_s", "idle_total_s", (s - cur_t) / 1e9)
        cur_t = t if cur_t is None else max(cur_t, t)
    return table


def shares(table: dict, window_s: float) -> dict:
    """The numbers the spans are for, from ``span_table``'s ``table`` over a
    traced window of ``window_s`` seconds; each is left out where its spans
    are absent. Where the federation engine ran: the idle self-attributed to
    its own spans (``ENGINE``), to the training calls and to the eval calls,
    each in % of the window, and the launches under a tick over the ticks.
    Where a train step ran: the device seconds under the attention backward
    in % of those under the step, and the device ms of clipping and the
    optimizer a step."""
    out = {}

    def idle(prefixes):
        return 100 * sum(r["idle_self_s"] for name, r in table.items()
                         if name.startswith(prefixes)) / window_s

    tick = table.get("dfl.simlax.tick")
    if tick:
        out.update(engine_idle_share=idle(ENGINE),
                   train_idle_share=idle(("dfl.scenario.train",)),
                   eval_idle_share=idle(("dfl.scenario.eval",)),
                   launches_per_tick=tick["launches_total"] / tick["calls"])
    step = table.get("dfl.train.step")
    if step and step["device_total_s"] > 0:
        def device(name):
            return table[name]["device_total_s"] if name in table else 0.0

        out.update(
            attn_bwd_share=100 * device("dfl.flash.backward") / step["device_total_s"],
            optimizer_ms=1e3 * (device("dfl.train.clip") + device("dfl.train.optimizer"))
            / step["calls"])
    return out
