"""Federation ticks completed a second over the whole window, batched
sweeps: a batch of B federations counts B ticks a tick."""


def read(ctx):
    return ctx.counts["ticks"] / ctx.window_s
