"""The dropless expert layer's grouped products (``models.moe.grouped_mm``,
``torch._grouped_mm`` on the card) against their operations bound: each
held slot's expert forward (gate, up, down: 6 d ff FLOPs, ``_moe``) once in
the forward, again in the remat recompute (every layer's, but under remat
"none") and twice in the backward (the input's and the weights' gradients), the
slots from the program's route counter, over 989 TFLOP/s, divided by the
device time of the grouped-GEMM kernels by name in the trace
(``KERNELS``, read from a traced step on an H100). None where no such
kernel ran."""
from perfbench import peaks
from perfbench.metrics._moe import slot_fwd_flops
from perfbench.trace import kernel_time

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm")


def read(ctx):
    if ctx.trace is None or not ctx.counts["held_slots"]:
        return None
    sec = sum(kernel_time(ctx.trace, k)[0] for k in KERNELS)
    if sec <= 0:
        return None
    arch = ctx.config["arch"]
    passes = 3 if arch["remat"] == "none" else 4
    flops = ctx.counts["held_slots"] * slot_fwd_flops(arch) * passes
    return 100.0 * flops / peaks.BF16_FLOPS / sec
