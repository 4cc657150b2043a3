"""Milliseconds a step of the frame: the sort and window tables on a C8
rebuild, the cached gather otherwise (the "frame" section of the program's
marks), over the marked steps, which run without the profiler."""


def read(ctx):
    v = ctx["spans"].get("frame")
    return None if v is None else v / ctx["steps"]
