"""Kernel 2's share of its roofline, in percent: the least time of a
launch (the pairs in range counted from the traced chunks' start states,
each particle's bytes once; ``fsibench.roofline``) over the mean device
time of ``phase2_sweep_kernel`` in the trace."""

from fsibench import roofline
from fsibench.trace import kernel_time


def read(ctx):
    got = kernel_time(ctx["kernels"], "phase2_sweep_kernel")
    if got is None:
        return None
    sec, launches = got
    least = roofline.least_seconds("phase2_sweep", ctx["pairs"],
                                   ctx["particles"], ctx["three_d"])
    return 100.0 * least / (sec / launches)
