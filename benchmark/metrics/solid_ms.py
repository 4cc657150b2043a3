"""Milliseconds a step of the elastic substeps (the "solid" section of the
program's marks), over the marked steps, which run without the profiler;
nothing on a scene without a solid."""


def read(ctx):
    v = ctx["spans"].get("solid")
    return None if v is None else v / ctx["steps"]
