"""Device time of the bit-parallel kernel per traced call."""

from benchmark import trace

KERNEL = "BitpalKernel"


def value(ctx):
    return trace.kernel_ms_per_call(ctx.trace, KERNEL)
