"""Model FLOPs of the traced window's training steps (``_glm.step_flops``)
over the window times the card's bf16 dense peak (989 TFLOP/s)."""
from perfbench import peaks
from perfbench.metrics._glm import step_flops


def read(ctx):
    if ctx.trace is None or not ctx.counts["steps"]:
        return None
    t = ctx.cell["traffic"]
    flops = ctx.counts["steps"] * step_flops(ctx.config["arch"], t["batch"], t["seq"])
    return 100.0 * flops / (ctx.window_s * peaks.BF16_FLOPS)
