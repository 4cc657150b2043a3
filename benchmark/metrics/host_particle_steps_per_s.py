"""Particle-steps a second by the host's clock, over the traced run's chunks
that ran with nothing on: the window's chunks but the marked and profiled
ones, each timed from its call to its return, the episodes' fresh copies
between them left out.  Where the host paces the step, this is the rate a
user waits on, and it swings with the host's speed from run to run; the
cell's end-to-end rate is then the card's (``device_particle_steps_per_s``)."""


def read(ctx):
    if ctx["plain_s"] <= 0:
        return None
    return ctx["particles"] * ctx["plain_steps"] / ctx["plain_s"]
