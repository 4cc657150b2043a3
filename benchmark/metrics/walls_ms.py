"""Milliseconds a step of the prescribed wall motion: every wall row turned
and given its velocity (the "walls" section of the program's marks, which
the program makes only where the walls move), over the marked steps, which
run without the profiler; nothing on a scene whose walls stand still, or
where the program marks no such section."""


def read(ctx):
    v = ctx["spans"].get("walls")
    return None if v is None else v / ctx["steps"]
