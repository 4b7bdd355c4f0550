"""Seconds from the process's start to the start of the measured window:
imports, the kernels' load (and build, in a fresh checkout), inputs and
weights, warm-up."""


def read(ctx):
    return ctx.setup_s
