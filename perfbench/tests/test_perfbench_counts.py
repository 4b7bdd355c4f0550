"""The metric files' operation and byte counts against hand counts."""
import json

import pytest

from perfbench import harness, peaks
from perfbench.harness import Ctx, load_module

CFG = json.loads((harness.ROOT / "perfbench/configs/lenet5-dfl.json").read_text())
GLM = json.loads((harness.ROOT / "perfbench/configs/chatglm3-6b.json").read_text())


def metric(name):
    return load_module(harness.ROOT / "perfbench" / "metrics" / f"{name}.py", "m")


def test_lenet_forward_flops_by_hand():
    from perfbench.metrics._lenet import forward_flops
    conv1 = 28 * 28 * 6 * 25          # 5x5 SAME over one channel
    conv2 = 14 * 14 * 16 * 25 * 6
    dense = 784 * 120 + 120 * 84 + 84 * 10
    assert forward_flops(CFG["model"]) == 2 * (conv1 + conv2 + dense) == 1_386_000


def test_lenet_wire_bytes_by_hand():
    from perfbench.metrics._lenet import wire_bytes
    # 107 786 fp32 elements, as many int8 q (no leaf pads: every last axis
    # is at most 256 wide), one bf16 scale a block row: 1168 rows
    rows = 1 + 25 + 1 + 150 + 1 + 784 + 1 + 120 + 1 + 84
    assert rows == 1168
    assert wire_bytes(CFG["model"]) == 4 * 107_786 + 107_786 + 2 * rows == 541_266


def test_causal_pairs_and_flash_flops_by_hand():
    from perfbench.metrics._glm import causal_pairs, flash_fwd_flops
    assert causal_pairs(4) == 4 + 3 + 2 + 1
    arch = {"d_model": 64, "num_heads": 4, "head_dim": 16}
    assert flash_fwd_flops(arch, 2, 4) == 2 * 2 * (2 * 4 * 16 * 10)


def test_step_flops_by_hand():
    from perfbench.metrics._glm import multiplying_params, step_flops
    arch = dict(GLM["arch"], num_layers=1, d_model=8, num_heads=2, num_kv_heads=1,
                head_dim=4, d_ff=16, vocab_size=10)
    layer = 8 * 2 * 4 + 2 * 8 * 1 * 4 + 2 * 4 * 8 + 3 * 8 * 16
    assert multiplying_params(arch) == layer + 10 * 8
    attn = 3 * 4.0 * 2 * 2 * 4 * 10       # B 2, S 4, 3 forwards
    assert step_flops(arch, 2, 4) == 6 * (layer + 80) * 8 + attn


def _trace(by_name, busy=1.0, window=4.0):
    return {"by_name": by_name, "busy_s": busy, "window_s": window}


@pytest.mark.parametrize("family", ["fed", "sweep"])
def test_device_readers(family):
    ctx = Ctx(trace=_trace({"quantize_kernel": (0.002, 1), "dequantize_kernel": (0.001, 1)}),
              config=CFG, counts={"trainings": 1000, "deliveries": 0, "test_models": 0},
              window_s=4.0, cell={})
    assert metric(f"idle_share.{family}").read(ctx) == pytest.approx(75.0)
    want = 100 * 2 * 541_266 * 1000 / peaks.HBM_BYTES_PER_S / 0.003
    assert metric(f"wire_roofline.{family}").read(ctx) == pytest.approx(want)
    assert metric(f"wire_roofline.{family}").read(Ctx(trace=_trace({}), config=CFG,
                                                 counts={"trainings": 1})) is None
    assert metric(f"mfu.{family}").read(ctx) == pytest.approx(
        100 * 3 * 1000 * 8 * 16 * 1_386_000 / (4.0 * 67e12))
    assert metric(f"idle_share.{family}").read(Ctx(trace=None)) is None


def test_lm_readers():
    from perfbench.metrics._glm import flash_fwd_flops, step_flops
    cell = {"traffic": {"batch": 2, "seq": 4096}}
    ctx = Ctx(trace=_trace({"void flash_fwd_sm90_kernel<128>(Params)": (0.01, 4)}),
              config=GLM, counts={"steps": 3}, window_s=4.0, cell=cell)
    assert metric("flash_fwd_roofline.train").read(ctx) == pytest.approx(
        100 * 4 * flash_fwd_flops(GLM["arch"], 2, 4096) / 989e12 / 0.01)
    assert metric("mfu.train").read(ctx) == pytest.approx(
        100 * 3 * step_flops(GLM["arch"], 2, 4096) / (4.0 * 989e12))


class _Event:
    def __init__(self, name, device, start, end, annotation=False):
        self._n, self._d, self._s, self._e, self._a = name, device, start, end, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return self._a


def test_trace_busy_union_and_idle_by_range():
    import torch

    from perfbench import trace
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_Event(trace.MEASURED, cpu, 0, 100), _Event("perfbench.unit", cpu, 0, 100),
              _Event("perfbench.train_stacked", cpu, 10, 40), _Event("aten::mm", cpu, 12, 30),
              _Event("k1", gpu, 5, 15), _Event("k2", gpu, 12, 25), _Event("k3", gpu, 50, 60),
              _Event("k4", gpu, 70, 80),
              # a range mirrored on the card's timeline is not device work
              _Event("perfbench.unit", gpu, 0, 100, annotation=True),
              _Event("early", gpu, -10, -5)]

    class Prof:
        pass
    prof = Prof()
    prof.profiler = Prof()
    prof.profiler.kineto_results = Prof()
    prof.profiler.kineto_results.events = lambda: events
    out = trace.summarize(prof, 1e-7)
    assert out["busy_s"] == pytest.approx(40e-9)    # [5, 25), [50, 60), [70, 80)
    assert out["by_name"]["k2"] == (pytest.approx(13e-9), 1) and "early" not in out["by_name"]
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["perfbench.train_stacked"] == pytest.approx(25e-9)
    assert gaps["perfbench.unit"] == pytest.approx(10e-9)    # [60, 70): outside it
    assert gaps["longest gaps: aten::mm"] == pytest.approx(25e-9)
    assert trace.kernel_time(out, "k") == (pytest.approx(43e-9), 4)
