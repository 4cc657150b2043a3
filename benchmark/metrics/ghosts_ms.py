"""Milliseconds a step of the periodic ghost rows: their extraction or
refresh and their phase-1 fields from the sources (the "ghost rows" and
"ghost fields" sections of the program's marks), over the marked steps,
which run without the profiler; nothing on a scene without ghost rows."""


def read(ctx):
    s = ctx["spans"]
    if "ghost rows" not in s and "ghost fields" not in s:
        return None
    return (s.get("ghost rows", 0.0) + s.get("ghost fields", 0.0)) / ctx["steps"]
