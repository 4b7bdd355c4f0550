"""K1 + K2 against their bytes bound (``_lenet.wire_roofline``), batched
sweeps of small federations."""
from perfbench.metrics._lenet import wire_roofline


def read(ctx):
    return wire_roofline(ctx)
