"""95th percentile of the wall time of every call of the window, from its
start to the host read of its answer."""

from benchmark import stats


def value(ctx):
    return stats.percentile(ctx.window.call_s, 95) * 1e3
