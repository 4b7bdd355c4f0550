"""The sm90 attention backward (``kernels.flash_attention``'s
``flash_attention_backward``) against its operations bound: the recompute
of S and the dP, dV, dQ and dK products, 2.5 times the causal forward's
FLOPs at the cell's shape (``_glm.flash_fwd_flops``), over 989 TFLOP/s, for
each call of its main kernel, divided by the device time of every kernel
of the backward (its delta and convert passes included) by name in the
trace. None where the backward ran no kernel (the plain PyTorch route)."""
from perfbench import peaks
from perfbench.metrics._glm import flash_fwd_flops
from perfbench.trace import kernel_time

BWD_PER_FWD = 2.5   # five products against the forward's two


def read(ctx):
    if ctx.trace is None:
        return None
    _, calls = kernel_time(ctx.trace, "flash_bwd_sm90_kernel")
    sec, _ = kernel_time(ctx.trace, "flash_bwd_sm90")
    if not calls or sec <= 0:
        return None
    t = ctx.cell["traffic"]
    flops = BWD_PER_FWD * flash_fwd_flops(ctx.config["arch"], t["batch"], t["seq"])
    return 100.0 * calls * flops / peaks.BF16_FLOPS / sec
