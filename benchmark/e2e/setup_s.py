"""Set-up: process start to the first timed call's start (imports, the CUDA
build when cold, compilation or cache load, input generation, warm-up)."""


def value(ctx):
    return ctx.setup_s
