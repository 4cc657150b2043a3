"""Reading a ``torch.profiler`` trace of the card: what ran on the device,
when, and what the host was doing while the device stood idle."""

from __future__ import annotations

import bisect
import contextlib

import torch


@contextlib.contextmanager
def profiled(device_only: bool):
    """A profiler over the block: the card's activity (CUPTI) alone, or
    with the host's ops too."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if not device_only:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        yield prof


def _is_device(evt) -> bool:
    """An activity of the card: a kernel, a copy or a fill, and not the
    device-side span the profiler draws for a ``record_function`` range."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)
            and not evt.name.startswith("fsibench."))


def read(prof) -> dict:
    """From a finished profile: ``kernels`` {name: [seconds, launches]} of
    every device activity, ``busy_s`` (their union), and ``gaps``
    {host op: idle seconds} over the idle stretches between them, each
    named by the innermost host op running at its middle."""
    dev, host = [], []
    for evt in prof.events():
        tr = evt.time_range
        if _is_device(evt):
            dev.append((tr.start, tr.end, evt.name))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, evt.name))
    kernels: dict = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) * 1e-6
        k[1] += 1
    dev.sort()
    merged = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    gaps: dict = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        name = "host code between ops"
        i = bisect.bisect_right(starts, mid) - 1
        # nested host ops: the latest one started that still runs is the
        # innermost
        for j in range(i, max(-1, i - 256), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) * 1e-6
    return dict(kernels=kernels, busy_s=busy, gaps=gaps,
                device_events=len(dev))


def top(table: dict, n: int = 10, width: int = 120) -> list:
    """The ``n`` largest entries of {name: seconds or [seconds, ...]} as
    ``[[name, seconds], ...]``."""
    rows = [(name[:width], v[0] if isinstance(v, list) else v)
            for name, v in table.items()]
    rows.sort(key=lambda r: -r[1])
    return [[name, sec] for name, sec in rows[:n]]


def kernel_time(kernels: dict, needle: str):
    """(seconds, launches) of the device activities whose name holds
    ``needle``, or None."""
    sec, n = 0.0, 0
    for name, (s, k) in kernels.items():
        if needle in name:
            sec, n = sec + s, n + k
    return (sec, n) if n else None
