"""Shared by the device-layer readers: the idle share of a traced window,
in percent."""


def idle_share(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
