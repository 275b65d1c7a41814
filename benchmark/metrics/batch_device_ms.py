"""Per traced batch call, the time in which an operation ran on the device
(union of intervals, averaged over devices)."""

from benchmark import trace


def value(ctx):
    calls = ctx.trace.calls
    if not calls or not ctx.trace.devices:
        return None
    busy = [trace.mean_busy_ns(ctx.trace, s, e) for s, e, _ in calls]
    return sum(busy) / len(busy) / 1e6
