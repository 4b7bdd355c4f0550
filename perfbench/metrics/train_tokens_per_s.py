"""Tokens trained a second over the whole window (steps x B x S, the window
ending on a step boundary)."""


def read(ctx):
    return ctx.counts["tokens"] / ctx.window_s
