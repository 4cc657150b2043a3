"""Milliseconds a step of the chunk edge: the guarded chunk's last health
read and the ghost plan's upkeep between chunks, extremes and strip counts
read and the plan rebuilt on the host where stale (the "guard read" and
"ghost upkeep" sections of the program's marks), summed over the marked
chunks and spread over their steps, which run without the profiler;
nothing where the program marks neither."""


def read(ctx):
    s = ctx["spans"]
    if "guard read" not in s and "ghost upkeep" not in s:
        return None
    return (s.get("guard read", 0.0) + s.get("ghost upkeep", 0.0)) / ctx["steps"]
