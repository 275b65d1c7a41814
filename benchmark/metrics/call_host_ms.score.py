"""Per traced call of a score, the time in which no operation ran on the
device: the API's host work, transfers' set-up and launch gaps."""

from benchmark import trace


def value(ctx):
    return trace.host_ms_per_call(ctx.trace)
