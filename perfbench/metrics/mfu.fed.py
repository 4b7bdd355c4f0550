"""The LeNet-5 FLOPs of the traced window over its length times the fp32
peak (``_lenet.mfu``), federations of one at a time."""
from perfbench.metrics._lenet import mfu


def read(ctx):
    return mfu(ctx)
