"""The whole step's share of the card's peak, in percent: the least time
of the step's counted pair work (kernels 1 and 2, as their rooflines count
it) over the mean host time of an untraced step.  The step time comes from
the window's clean chunks, the same in-episode chunks as the traced ones
with neither the profiler nor the section marks on, so the trace's cost to
the host does not enter it.  It outlives any fusion or renaming of the
kernels."""

from fsibench import roofline


def read(ctx):
    least = sum(roofline.least_seconds(k, ctx["pairs"], ctx["particles"],
                                       ctx["three_d"])
                for k in ("phase1_sweep", "phase2_sweep"))
    return 100.0 * least / ctx["step_s"]
