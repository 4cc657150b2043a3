"""Share of an untraced step in which nothing ran on the card, in percent:
1 less the card's busy time a step (the union of the device activities in
the profiler's trace, over the traced steps) over the mean host time of an
untraced step (the window's clean chunks, the same in-episode chunks with
neither the profiler nor the section marks on).  The profiler adds host
time to every launch but not device time, so the traced window's own idle
share (``busy_s`` and ``window_s`` of the result's ``device``) reads higher
than this where the host paces the step."""


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["steps"] / ctx["step_s"])
