"""Share of the traced window in which no kernel, copy or set ran on the
card (1 - the union of their intervals over the window), LM training cells."""
from perfbench.metrics._device import idle_share


def read(ctx):
    return idle_share(ctx)
