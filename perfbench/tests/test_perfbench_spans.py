"""``spans.span_table`` on a synthetic kineto-like event list: the program's
``dfl.*`` spans get their device time, launches and idle by correlation id
and thread (a kernel launched on the autograd engine's thread, a graph
replay and a kernel launched outside any op included); and
``trace.summarize``'s device numbers do not move when the program opens
spans."""
from types import SimpleNamespace

import pytest
import torch

from perfbench import spans as spans_lib
from perfbench import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2                   # RecordFunction thread ids
SYSTEM = {MAIN: 4242, AUTOGRAD: 4343}   # the same threads as CUPTI numbers them


class Ev:
    """The methods of a ``_KinetoEvent`` that ``summarize`` calls; times
    in microseconds."""

    def __init__(self, name, start, end, *, device=CPU, tid=MAIN, corr=0, linked=0,
                 annotation=False):
        self._name, self._start, self._dur = name, int(start * 1000), int((end - start) * 1000)
        self._device, self._tid, self._corr, self._linked = device, tid, corr, linked
        self._annotation = annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked


def _span(name, start, end, corr, tid=MAIN):
    return Ev(name, start, end, tid=tid, corr=corr, annotation=True)


def _launch(op, at, cupti, name="cudaLaunchKernel", tid=MAIN):
    """A runtime call on thread ``tid`` (numbered as CUPTI numbers it),
    linked to ``op`` (0: no op was open)."""
    return Ev(name, at, at + 2, tid=SYSTEM[tid], corr=cupti, linked=op)


def _kernel(op, start, end, cupti, name="kernel"):
    return Ev(name, start, end, device=CUDA, corr=cupti, linked=op)


def _events():
    """(the benchmark's and torch's events, the program's dfl.* events): a
    training step whose backward runs on the autograd thread, a wire kernel
    launched straight from a span (no op around it), then a graph replay
    (its kernels linked to no op either)."""
    base = [
        Ev("aten::ones", -50, -40, corr=90),                       # before the window
        _kernel(90, -45, -30, 500, "pad"),
        Ev(trace.MEASURED, 0, 1000, corr=1, annotation=True),
        Ev("perfbench.unit", 10, 990, corr=2, annotation=True),
        # forward: an aten op on the main thread, its launch and kernel
        Ev("aten::mm", 40, 60, corr=5),
        _launch(5, 45, 100),
        _kernel(5, 70, 150, 100, "gemm_fwd"),
        Ev("aten::copy_", 160, 170, corr=13),
        _launch(13, 161, 107, "cudaMemcpyAsync"),
        Ev("cudaStreamSynchronize", 164, 169, tid=SYSTEM[MAIN], corr=108, linked=13),
        # backward, autograd thread: one op under the main thread's span,
        # one inside the flash backward's span
        Ev("aten::mm", 220, 240, tid=AUTOGRAD, corr=7),
        _launch(7, 225, 101, tid=AUTOGRAD),
        _kernel(7, 250, 350, 101, "gemm_bwd"),
        Ev("aten::bmm", 310, 320, tid=AUTOGRAD, corr=9),
        _launch(9, 312, 102, tid=AUTOGRAD),
        _kernel(9, 400, 550, 102, "sgemm_attn"),
        # clipping: the kernel runs after its span has closed
        Ev("aten::mul", 715, 720, corr=11),
        _launch(11, 716, 103),
        _kernel(11, 760, 800, 103, "mul"),
        # the wire: a kernel launched straight from a span (ctypes)
        _launch(0, 812, 104),
        _kernel(0, 860, 870, 104, "quantize_kernel"),
        # a graph replay: one launch, two kernels
        _launch(0, 910, 105, "cudaGraphLaunch"),
        _kernel(0, 915, 925, 105, "graph_a"),
        _kernel(0, 925, 940, 105, "graph_b"),
        _kernel(13, 175, 178, 107, "Memcpy HtoD"),
    ]
    dfl = [
        _span("dfl.train.step", 20, 900, 3),
        _span("dfl.train.forward", 30, 200, 4),
        _span("dfl.train.backward", 210, 700, 6),
        _span("dfl.flash.backward", 300, 600, 8, tid=AUTOGRAD),
        _span("dfl.train.clip", 710, 750, 10),
        _span("dfl.wire", 810, 850, 12),
        _span("dfl.scenario.train", 905, 960, 14),
        # a range mirrored on the card's timeline: not device work
        Ev("dfl.train.step", 20, 900, device=CUDA, annotation=True),
    ]
    return base, dfl


def _summarize(events):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return trace.summarize(prof, 1e-3)


def test_device_time_launches_and_idle_go_to_the_innermost_span():
    base, dfl = _events()
    spans = spans_lib.span_table(base + dfl)
    us = 1e-6
    step, fwd, bwd, flash, clip, wire = (spans[f"dfl.{n}"] for n in (
        "train.step", "train.forward", "train.backward", "flash.backward", "train.clip",
        "wire"))
    assert (step["calls"], step["host_s"]) == (1, pytest.approx(880 * us))
    # forward: the gemm and the copy; backward: the autograd thread's gemm
    # under the main thread's span; the flash backward's own sgemm
    assert fwd["device_self_s"] == pytest.approx((80 + 3) * us)
    assert bwd["device_self_s"] == pytest.approx(100 * us)
    assert bwd["device_total_s"] == pytest.approx(250 * us)
    assert flash["device_self_s"] == flash["device_total_s"] == pytest.approx(150 * us)
    assert clip["device_self_s"] == pytest.approx(40 * us)
    assert wire["device_self_s"] == pytest.approx(10 * us)
    assert step["device_total_s"] == pytest.approx((83 + 250 + 40 + 10) * us)
    assert step["device_self_s"] == 0
    # launches: kernel launches and the async copy, not the synchronize
    assert (fwd["launches_self"], bwd["launches_self"], bwd["launches_total"]) == (2, 1, 2)
    assert (flash["launches_self"], clip["launches_self"], wire["launches_self"]) == (1, 1, 1)
    assert step["launches_total"] == 6
    replay = spans["dfl.scenario.train"]
    assert replay["device_self_s"] == pytest.approx(25 * us)
    assert (replay["launches_self"], replay["calls"]) == (1, 1)
    # idle, by the main thread's innermost span when each gap began: 150
    # (forward, to the copy at 175), 178 (forward, to 250), 350 and 550
    # (backward), 800 and 870 (the step itself, around the wire)
    assert fwd["idle_self_s"] == pytest.approx((25 + 72) * us)
    assert bwd["idle_self_s"] == pytest.approx((50 + 210) * us)
    assert step["idle_self_s"] == pytest.approx((60 + 45) * us)
    assert step["idle_total_s"] == pytest.approx((97 + 260 + 105) * us)
    assert flash["idle_total_s"] == 0
    # the pad kernel before the window counts nowhere
    assert spans_lib.NO_SPAN not in spans


def test_summarize_device_numbers_do_not_move_with_spans():
    """The spans' ranges (on the host, and mirrored on the card as
    annotations) leave the device time, busy time and the benchmark's idle
    by range as they are; only the longest gaps' host-op names can take a
    span's name."""
    base, dfl = _events()
    without, with_ = _summarize(base), _summarize(base + dfl)
    assert with_["by_name"] == without["by_name"]
    assert with_["busy_s"] == without["busy_s"] == pytest.approx(
        (80 + 3 + 100 + 150 + 40 + 10 + 25) * 1e-6)
    stages = [[k, v] for k, v in without["breakdown"]["idle_gaps"]
              if not k.startswith("longest gaps")]
    assert [[k, v] for k, v in with_["breakdown"]["idle_gaps"]
            if not k.startswith("longest gaps")] == stages


def test_what_no_span_holds():
    base, dfl = _events()
    dfl = [e for e in dfl if e.name() != "dfl.train.step"]
    spans = spans_lib.span_table(base + dfl)
    assert spans[spans_lib.NO_SPAN]["idle_self_s"] == pytest.approx((60 + 45) * 1e-6)
    assert spans[spans_lib.NO_SPAN]["calls"] == 0


def test_no_spans_no_table():
    base, _ = _events()
    assert spans_lib.span_table(base) == {}


def test_shares_of_a_train_step():
    """The step's numbers: the attention backward's device seconds over the
    step's, and clipping and the optimizer's device ms a step."""
    base, dfl = _events()
    table = spans_lib.span_table(base + dfl)
    got = spans_lib.shares(table, 1e-3)
    assert set(got) == {"attn_bwd_share", "optimizer_ms"}
    assert got["attn_bwd_share"] == pytest.approx(100 * 150 / (83 + 250 + 40 + 10))
    assert got["optimizer_ms"] == pytest.approx(40e-3)    # clip alone: no optimizer span


def _row(**kw):
    r = {"calls": 0, "host_s": 0.0, "device_self_s": 0.0, "device_total_s": 0.0,
         "launches_self": 0, "launches_total": 0, "idle_self_s": 0.0, "idle_total_s": 0.0}
    r.update(kw)
    return r


def test_shares_of_federation_ticks():
    """The engine's numbers: idle self in the engine's own spans, the
    training calls and the eval calls over the window; launches under a
    tick over the ticks. Idle that no span holds, or under the build,
    counts in none but the engine's."""
    table = {
        "dfl.simlax.build": _row(calls=1, idle_self_s=0.25),
        "dfl.simlax.tick": _row(calls=4, launches_total=400, idle_self_s=0.5),
        "dfl.simlax.deliver": _row(calls=4, idle_self_s=0.25),
        "dfl.simlax.reduce": _row(calls=4, idle_self_s=0.5, idle_total_s=1.5),
        "dfl.scenario.eval": _row(calls=8, idle_self_s=1.0),
        "dfl.scenario.train": _row(calls=3, idle_self_s=2.0),
        "dfl.attack": _row(calls=2, idle_self_s=0.75),
        "dfl.wire": _row(calls=3, idle_self_s=0.25),
        "dfl.scenario.test": _row(calls=1, idle_self_s=0.5),
        spans_lib.NO_SPAN: _row(idle_self_s=4.0),
    }
    got = spans_lib.shares(table, 10.0)
    assert got == pytest.approx({"engine_idle_share": 30.0, "train_idle_share": 20.0,
                                 "eval_idle_share": 10.0, "launches_per_tick": 100.0})
    assert spans_lib.shares({spans_lib.NO_SPAN: _row(idle_self_s=1.0)}, 10.0) == {}
