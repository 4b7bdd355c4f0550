"""LeNet-5's counts from its configuration (the benchmark's own arithmetic):
the forward's FLOPs a sample and the bytes of one model through the int8
wire's quantize or dequantize; and the readers the federation cells'
per-layer metrics share."""
from __future__ import annotations

from perfbench import peaks
from perfbench.gen.lenet_data import lenet_leaves
from perfbench.trace import kernel_time


def forward_flops(model: dict) -> int:
    """2 x multiply-adds of conv 5x5 SAME (1 -> c1 at S x S, c1 -> c2 at
    S/2 x S/2) and the three dense layers; pools and tanh count nothing."""
    size, k = model["image_size"], model["kernel"]
    c1, c2 = model["conv_channels"]
    f1, f2 = model["fc_dims"]
    flat = (size // 4) ** 2 * c2
    macs = (size * size * c1 * k * k * model["in_channels"]
            + (size // 2) ** 2 * c2 * k * k * c1
            + flat * f1 + f1 * f2 + f2 * model["num_classes"])
    return 2 * macs


def wire_bytes(model: dict, block: int = 256) -> int:
    """One model through quantize (or dequantize): every fp32 leaf read (or
    written) once, its int8 q (the padded blocks) and its bf16 scales (one a
    block row) written (or read) once."""
    total = 0
    for _, shape, _ in lenet_leaves(model):
        last = shape[-1]
        b = min(block, last)
        nb = -(-last // b)
        lead = 1
        for d in shape[:-1]:
            lead *= d
        elems = lead * last
        total += 4 * elems + lead * nb * b + 2 * lead * nb
    return total


def wire_roofline(ctx):
    """K1 + K2 (``kernels.quantize``: the quantize and dequantize kernels of
    the int8 wire) against their bytes bound: every broadcast model goes
    through both once, each moving the model's bytes (``wire_bytes``)
    once; the bound is those bytes over the card's HBM bandwidth, divided
    by the two kernels' device time by name in the trace."""
    if ctx.trace is None:
        return None
    q, nq = kernel_time(ctx.trace, "quantize_kernel")   # also dequantize_kernel
    if not nq or q <= 0:
        return None
    nbytes = 2 * wire_bytes(ctx.config["model"]) * ctx.counts["trainings"]
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / q


def mfu(ctx):
    """LeNet-5 FLOPs the federations of the traced window needed, over the
    window times the card's fp32 peak: 3 forwards a training sample (train
    steps x batch for each training action), one a sample of each
    receipt's held-out set and of each record tick's test set. The
    convolutions and products run in fp32 outside the tensor cores (the
    traced kernels are cuDNN's f32 / ffma ones, not TF32), so the peak is
    67 TFLOP/s."""
    if ctx.trace is None:
        return None
    r = ctx.config["recipe"]
    c = ctx.counts
    samples = (3 * c["trainings"] * r["train_steps"] * r["batch"]
               + c["deliveries"] * r["eval_size"] + c["test_models"] * r["test_size"])
    return 100.0 * samples * forward_flops(ctx.config["model"]) / (
        ctx.window_s * peaks.FP32_FLOPS)
