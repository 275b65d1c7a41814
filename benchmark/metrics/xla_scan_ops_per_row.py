"""Device operations per DP row of the XLA row scan: operations that
started inside the traced calls over the rows those calls scanned (one row
per base of the second sequence).  This counts launches per row."""

from benchmark import trace


def value(ctx):
    calls = ctx.trace.calls
    if not calls or not ctx.trace.devices:
        return None
    ops = sum(trace.ops_started(dev, s, e) for s, e, _ in calls
              for dev in ctx.trace.devices.values()) / len(ctx.trace.devices)
    rows = ctx.inputs[0][1].shape[1] * len(calls)
    return ops / rows if ops else None
