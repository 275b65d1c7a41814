"""Pairs scored by every call of the window, over the window's seconds."""

from benchmark import stats


def value(ctx):
    return stats.window_rate(sum(ctx.pairs), ctx.window.seconds)
