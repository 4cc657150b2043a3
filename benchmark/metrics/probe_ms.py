"""Milliseconds a step of the guard's probe: the squared top speed of each
step's result, reduced on the card before the next step reads it (the
"probe" section of the program's marks), over the marked steps, which run
without the profiler; nothing where the program marks no probe."""


def read(ctx):
    v = ctx["spans"].get("probe")
    return None if v is None else v / ctx["steps"]
