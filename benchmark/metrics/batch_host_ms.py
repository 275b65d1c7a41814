"""Per traced batch call, the time in which no operation ran on the device:
the batch layer's host padding, length scan, transfers and read-back."""

from benchmark import trace


def value(ctx):
    return trace.host_ms_per_call(ctx.trace)
