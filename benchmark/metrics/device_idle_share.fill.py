"""Share of the traced window in which no operation ran on the device,
averaged over the devices (score fills)."""

from benchmark import trace


def value(ctx):
    return trace.idle_share(ctx.trace)
