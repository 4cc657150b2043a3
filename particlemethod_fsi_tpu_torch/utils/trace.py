"""Section spans of the simulation: marks on the device's clock, a record
of each marked step, and host ranges on the profiler's clock.

A step is cut into sections ("read", "frame", "phase1", ...).  Each is a
span: :meth:`Spans.begin` where the section's code begins, :meth:`Spans.mark`
where it ends.  Spans have parents: a section's is its step (the chunk's
``"guard read"``'s is the chunk), a step's is its chunk; ``refresh_ghosts``'
``"ghost upkeep"`` follows the chunk it tends.

- Marks.  While :attr:`Spans.events` is a list (``Simulation.profile_events``),
  each :meth:`Spans.mark` appends ``(name, event)`` and each step appends
  ``("begin", event)`` at its entry: a timed ``torch.cuda.Event`` recorded
  on the current stream, or on a CPU device a :class:`HostStamp` with the
  same ``elapsed_time``.  The interval between a mark and the one before it
  is the section's time; the interval that ends at a ``"begin"`` is
  between steps.
- Recordings.  Setting the list where there was none starts a
  :class:`Recording` (:func:`last_recording`): chunk and step numbers, the
  frame rebuilds and the events that bound each step, resolved only when
  read.  It stays readable after the list is set back to None, until the
  next start.
- Ranges.  While ``torch.profiler`` records, each span is also a host range
  ``fsi.<name>``, inside ``fsi.step`` (``fsi.diagnostics``) and
  ``fsi.chunk``, so the program's sections share the profiler's clock with
  the kernels.  A section's parts (:meth:`Spans.part`: the solid's
  substeps) are ranges alone, so that a long section's later host ops lie
  close to a range that holds them.

With neither on, a span costs one attribute test and one flag test; it
records, opens and allocates nothing.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

# levels of an open range
_CHUNK, _STEP, _SECTION, _PART = 0, 1, 2, 3

_last: Optional["Recording"] = None


def last_recording() -> Optional["Recording"]:
    """The recording started last in this process, or None."""
    return _last


class HostStamp:
    """A CPU device's mark: the host clock when made, read as a timed
    ``torch.cuda.Event`` is."""

    __slots__ = ("t",)

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other: "HostStamp") -> float:
        """Milliseconds from this mark to ``other``."""
        return (other.t - self.t) * 1e3

    def synchronize(self) -> None:
        pass


class StepRecord:
    """One marked step: its chunk's number, its number in the chunk,
    whether it rebuilt the frame, and its first and last marks (``end``
    None for a step that was begun but not taken)."""

    __slots__ = ("chunk", "step", "rebuilt", "begin", "end")

    def __init__(self, chunk: int, step: int, begin):
        self.chunk, self.step, self.begin = chunk, step, begin
        self.rebuilt = False
        self.end = None


class Recording:
    """The steps marked from one start of the marks."""

    def __init__(self):
        self.steps: list = []
        self.chunks = 0

    def step_ms(self) -> list:
        """Each taken step's milliseconds: from its ``"begin"`` to the
        next step's in the same chunk, the chunk's last step to its own
        last mark (the guard's ``"probe"`` in a guarded chunk)."""
        steps = [s for s in self.steps if s.end is not None]
        if not steps:
            return []
        steps[-1].end.synchronize()
        out = []
        for s, nxt in zip(steps, steps[1:] + [None]):
            end = nxt.begin if nxt is not None and nxt.chunk == s.chunk \
                else s.end
            out.append(s.begin.elapsed_time(end))
        return out


class Spans:
    """The section spans of one simulation on ``device``."""

    __slots__ = ("_events", "_cuda", "_open", "_step", "_n_step",
                 "recording")

    def __init__(self, device: torch.device):
        self._events: Optional[list] = None
        self._cuda = device.type == "cuda"
        self._open: list = []  # [(level, range)], innermost last
        self._step: Optional[StepRecord] = None
        self._n_step = 0
        self.recording: Optional[Recording] = None

    @property
    def events(self) -> Optional[list]:
        return self._events

    @events.setter
    def events(self, value: Optional[list]) -> None:
        global _last
        if value is not None and self._events is None:
            self.recording = _last = Recording()
            self._step = None
        self._events = value

    # -- the calls of the program --------------------------------------
    def chunk(self) -> None:
        """A chunk begins."""
        if self._open:
            self._close(_CHUNK)
        if self._events is not None:
            self.recording.chunks += 1
            self._n_step = 0
            self._step = None
        if _profiler._is_profiler_enabled:
            self._enter(_CHUNK, "fsi.chunk")

    def step(self, kind: str = "step") -> None:
        """A step (or, ``kind`` ``"diagnostics"``, a diagnostics call)
        begins: the ``"begin"`` mark, which ends the last step's range."""
        if self._events is not None or _profiler._is_profiler_enabled:
            self._begin_step(kind)

    def begin(self, name: str) -> None:
        """Section ``name`` begins."""
        if _profiler._is_profiler_enabled:
            self._close(_SECTION)
            self._enter(_SECTION, "fsi." + name)

    def part(self, name: str) -> None:
        """Part ``name`` of the open section begins; it ends with the next
        part or with the section.  A range alone: no mark."""
        if _profiler._is_profiler_enabled:
            self._close(_PART)
            self._enter(_PART, "fsi." + name)

    def mark(self, name: str, rebuilt: Optional[bool] = None) -> None:
        """Section ``name`` ends; ``rebuilt`` says whether the step rebuilt
        its frame, where this section would."""
        if self._events is not None or self._open:
            self._end(name, rebuilt)

    def end_step(self) -> None:
        """The last step of a chunk has ended."""
        self._step = None
        if self._open:
            self._close(_STEP)

    def end(self) -> None:
        """The chunk (or the diagnostics call) has ended."""
        self._step = None
        if self._open:
            self._close(_CHUNK)

    # -- with marks or ranges on ---------------------------------------
    def _stamp(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return HostStamp()

    def _begin_step(self, kind: str) -> None:
        if self._open:
            self._close(_STEP)
        if self._events is not None:
            ev = self._stamp()
            self._events.append(("begin", ev))
            self._step = None
            if kind == "step":
                rec = self.recording
                self._step = StepRecord(rec.chunks - 1, self._n_step, ev)
                rec.steps.append(self._step)
                self._n_step += 1
        if _profiler._is_profiler_enabled:
            self._enter(_STEP, "fsi." + kind)

    def _end(self, name: str, rebuilt: Optional[bool]) -> None:
        if self._events is not None:
            ev = self._stamp()
            self._events.append((name, ev))
            if self._step is not None:
                self._step.end = ev
                if rebuilt is not None:
                    self._step.rebuilt = rebuilt
        if self._open:
            self._close(_SECTION)

    def _enter(self, level: int, name: str) -> None:
        rf = _profiler.record_function(name)
        rf.__enter__()
        self._open.append((level, rf))

    def _close(self, level: int) -> None:
        """Ends the open ranges at ``level`` and below it, innermost
        first."""
        while self._open and self._open[-1][0] >= level:
            self._open.pop()[1].__exit__(None, None, None)
