"""K4 (``kernels.flash_attention``, the sm90 forward writing the lse) against
its operations bound: the causal forward's FLOPs at the cell's shape
(``_glm.flash_fwd_flops``) over 989 TFLOP/s, for each of its calls (the
forward and its remat recompute), divided by the kernel's device time by
name in the trace."""
from perfbench import peaks
from perfbench.metrics._glm import flash_fwd_flops
from perfbench.trace import kernel_time


def read(ctx):
    if ctx.trace is None:
        return None
    sec, calls = kernel_time(ctx.trace, "flash_fwd_sm90_kernel")
    if not calls or sec <= 0:
        return None
    t = ctx.cell["traffic"]
    bound = calls * flash_fwd_flops(ctx.config["arch"], t["batch"], t["seq"]) / peaks.BF16_FLOPS
    return 100.0 * bound / sec
