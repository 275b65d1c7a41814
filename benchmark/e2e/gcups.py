"""DP cells (len(a) x len(b)) of every call of the window, over the window's
seconds, in billions."""

from benchmark import stats


def value(ctx):
    return stats.window_rate(sum(ctx.cells), ctx.window.seconds) / 1e9
