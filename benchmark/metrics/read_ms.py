"""Milliseconds a step of the step's host read: inlet, wrap, extremes, the
C8 rebuild test and the one read of them (the "read" section of the
program's marks), over the marked steps.  The marks run without the
profiler; the harness logs their host cost beside the clean step."""


def read(ctx):
    v = ctx["spans"].get("read")
    return None if v is None else v / ctx["steps"]
