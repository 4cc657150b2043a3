"""Milliseconds a step of the pair phases: phase 1 with the EOS and phase 2
(the "phase1" and "phase2" sections of the program's marks), over the
marked steps, which run without the profiler."""


def read(ctx):
    s = ctx["spans"]
    if "phase1" not in s or "phase2" not in s:
        return None
    return (s["phase1"] + s["phase2"]) / ctx["steps"]
