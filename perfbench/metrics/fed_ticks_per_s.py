"""Federation ticks completed a second over the whole window, federations
of one at a time."""


def read(ctx):
    return ctx.counts["ticks"] / ctx.window_s
