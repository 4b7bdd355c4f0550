"""Model FLOPs of the traced window's training steps (``_moe.step_flops``:
the dense part from the configuration, the routed experts' part from the
held slots the program's route counter counted) over the window times
the card's bf16 dense peak (989 TFLOP/s). MoE training cells."""
from perfbench import peaks
from perfbench.metrics._moe import step_flops


def read(ctx):
    if ctx.trace is None or not ctx.counts["steps"] or not ctx.counts["held_slots"]:
        return None
    t = ctx.cell["traffic"]
    dense, routed = step_flops(ctx.config["arch"], t["batch"], t["seq"],
                               ctx.counts["held_slots"])
    flops = ctx.counts["steps"] * dense + routed
    return 100.0 * flops / (ctx.window_s * peaks.BF16_FLOPS)
