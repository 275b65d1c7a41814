"""The bit-parallel kernel's share of its roofline: the least time its
algorithm's operations and bytes can take at the device's published peaks
(``benchmark/ops.py``), over the kernel's device time per call."""

from benchmark import ops, trace

KERNEL = "BitpalKernel"


def value(ctx):
    kernel_ms = trace.kernel_ms_per_call(ctx.trace, KERNEL)
    if kernel_ms is None or ctx.peak is None:
        return None
    a, b = ctx.inputs[0]
    t_min, _ = ops.bitpal_roofline_s(ctx.config["scoring"], a.shape[1],
                                     b.shape[1], ctx.peak)
    return 100.0 * t_min / (kernel_ms / 1e3)
