"""The port's spans (``repro_torch.core.spans``) on the CPU: a tiny LeNet
federation through ``simlax.LaxSimulator`` (compact delivery, an attacker,
the int8 wire, record ticks) and a tiny training step through
``models.flash`` under ``torch.profiler`` show every span, nested as the
engine and the step are; with no profiler running a span enters no
``record_function``, and the federation's result is bitwise that of a run
under the profiler."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)

from torch.profiler import ProfilerActivity, profile              # noqa: E402

from repro_torch import tree                                     # noqa: E402
from repro_torch.chain import scenarios, simlax                  # noqa: E402
from repro_torch.configs import smoke_config                     # noqa: E402
from repro_torch.core import spans                               # noqa: E402
from repro_torch.core.reputation import IMPL2                    # noqa: E402
from repro_torch.train import step as step_lib                   # noqa: E402

TICKS, RECORD_EVERY = 14, 12

# each engine span and the span it opens inside (None: at the top)
ENGINE_PARENTS = {
    "dfl.simlax.build": None,
    "dfl.simlax.tick": None,
    "dfl.simlax.deliver": "dfl.simlax.tick",
    "dfl.simlax.reduce": "dfl.simlax.tick",
    "dfl.scenario.eval": "dfl.simlax.reduce",
    "dfl.simlax.fedavg": "dfl.simlax.tick",
    "dfl.simlax.train_and_send": "dfl.simlax.tick",
    "dfl.scenario.train": "dfl.simlax.train_and_send",
    "dfl.attack": "dfl.simlax.train_and_send",
    "dfl.wire": "dfl.simlax.train_and_send",
    "dfl.scenario.test": "dfl.simlax.tick",
    "dfl.simlax.finish": None,
}
STEP_PARENTS = {
    "dfl.train.step": None,
    "dfl.train.forward": "dfl.train.step",
    "dfl.train.backward": "dfl.train.step",
    "dfl.flash.backward": "dfl.train.backward",
    "dfl.train.clip": "dfl.train.step",
    "dfl.train.optimizer": "dfl.train.step",
}


def _spans_nested(prof):
    """[(name, parent name or None)] of the dfl.* ranges of a CPU trace:
    the parent is the innermost dfl.* range around it on its thread."""
    got = [(e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("dfl.")]
    out = []
    for tid, s, t, name in got:
        around = [x for x in got if x[0] == tid and x[1] <= s and t <= x[2]
                  and (x[1], x[2]) != (s, t)]
        inner = max(around, key=lambda x: x[1], default=None)
        out.append((name, None if inner is None else inner[3]))
    return out


def _federation():
    sc, spec, topo, cfg = scenarios.lenet_paper_setup(
        6, ticks=TICKS, train_steps=1, compress="int8")
    cfg = dataclasses.replace(cfg, record_every=RECORD_EVERY)
    assert spec.malicious and cfg.delivery == "compact"
    return simlax.LaxSimulator(sc, topo, spec, IMPL2, cfg, device="cpu").run()


@pytest.fixture(scope="module")
def runs():
    """The federation without a profiler and under one, each with the
    ``record_function`` ranges that spans entered counted."""
    entered = []

    def counting(name):
        entered.append(name)
        return torch.profiler.record_function(name)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spans, "record_function", counting)
        plain = _federation()
        off = len(entered)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = _federation()
    return {"plain": plain, "traced": traced, "entered_off": off,
            "entered_on": len(entered) - off, "nested": _spans_nested(prof)}


@pytest.mark.parametrize("name", sorted(ENGINE_PARENTS))
def test_engine_span_opens_inside_its_parent(runs, name):
    parents = {p for n, p in runs["nested"] if n == name}
    assert parents == {ENGINE_PARENTS[name]}


def test_engine_span_counts(runs):
    calls = {}
    for name, _ in runs["nested"]:
        calls[name] = calls.get(name, 0) + 1
    assert set(calls) == set(ENGINE_PARENTS)
    assert calls["dfl.simlax.tick"] == TICKS
    for phase in ("deliver", "fedavg", "train_and_send"):
        assert calls[f"dfl.simlax.{phase}"] == TICKS
    assert calls["dfl.scenario.test"] == len(range(0, TICKS, RECORD_EVERY))
    assert calls["dfl.simlax.build"] == calls["dfl.simlax.finish"] == 1
    assert calls["dfl.scenario.train"] == calls["dfl.wire"] == calls["dfl.attack"]


def test_no_profiler_no_range_and_the_same_bits(runs):
    assert runs["entered_off"] == 0
    assert runs["entered_on"] == len(runs["nested"])
    a, b = runs["plain"], runs["traced"]
    for x, y in zip(tree.leaves(a.params) + tree.leaves(a.sent),
                    tree.leaves(b.params) + tree.leaves(b.sent)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.reputation, b.reputation)
    np.testing.assert_array_equal(a.acc_history, b.acc_history)
    assert a.stats["deliveries"] == b.stats["deliveries"] > 0
    assert a.stats["fedavg_rounds"] == b.stats["fedavg_rounds"]


def test_span_without_a_profiler_is_one_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = spans.span("dfl.a"), spans.span("dfl.b")
    assert first is second
    with first as value:
        assert value is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(spans.span("dfl.a"), torch.profiler.record_function)


@pytest.fixture(scope="module")
def step_nested():
    cfg = dataclasses.replace(smoke_config("llama3-8b"), num_layers=1)
    assert cfg.attn_impl == "flash"
    g = torch.Generator().manual_seed(0)
    state = step_lib.init_train_state(cfg, g, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    train_step = step_lib.make_train_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, batch)
    return _spans_nested(prof)


@pytest.mark.parametrize("name", sorted(STEP_PARENTS))
def test_step_span_opens_inside_its_parent(step_nested, name):
    parents = {p for n, p in step_nested if n == name}
    assert parents == {STEP_PARENTS[name]}
    if name != "dfl.flash.backward":
        assert sum(n == name for n, _ in step_nested) == 1



def test_chip_smoke_device_events_leave_out_the_spans():
    """chip_smoke's device events of a profiled window are the card's
    kernels and copies: the spans' ranges, mirrored on the card's timeline
    as annotations, are left out; its own labelled ranges are kept."""
    import importlib.util
    import os
    from types import SimpleNamespace

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, start, device=cuda):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start))

    events = [ev("pad_kernel", 0), ev(chip_smoke.MEASURED, 10, cpu),
              ev(chip_smoke.MEASURED, 11), ev("dfl.wire", 12, cpu), ev("dfl.wire", 13),
              ev("quantize_kernel", 14), ev("dequantize_kernel", 15),
              ev("Memcpy DtoH", 16), ev("dfl.simlax.tick", 17), ev("models.rglru", 18)]
    got = chip_smoke.measured_events(SimpleNamespace(events=lambda: events))
    assert [e.name for e in got] == ["quantize_kernel", "dequantize_kernel",
                                     "Memcpy DtoH", "models.rglru"]
