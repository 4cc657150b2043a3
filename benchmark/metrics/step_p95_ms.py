"""The 95th percentile (nearest rank) of the marked steps' milliseconds:
each step from its "begin" mark to the next step's, a chunk's last step to
its last mark, the guard's probe (the program's recording of the marked
chunks, ``particlemethod_fsi_tpu_torch.utils.trace.last_recording``), over
the marked steps, which run without the profiler.  Besides
``fsibench/program.py`` the one reader that reaches into the port; nothing
where the program keeps no recording or this run marked nothing."""


def read(ctx):
    if not ctx["spans"]:
        return None
    try:
        from particlemethod_fsi_tpu_torch.utils.trace import last_recording
    except ImportError:
        return None
    rec = last_recording()
    ms = sorted(rec.step_ms()) if rec is not None else []
    if not ms:
        return None
    return ms[-(-95 * len(ms) // 100) - 1]
