"""The control: the configuration's plain reference
(:func:`fsibench.harness.reference_for`) put in the program's place and
computed a step below the configurations' float32 (each pair's terms in
bfloat16, state and sums in float32).  Driven through the harness like the
program, it has to come out as not correct."""

from __future__ import annotations

from typing import NamedTuple

import torch

from fsibench.harness import BENCH_DIR, reference_for


class State(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    time: float


class ControlProgram:
    """The program's interface to the harness (``start``, ``fresh``,
    ``chunk``), stepped by the reference with bfloat16 pair terms.
    ``bench_dir`` is the benchmark folder a named reference is found in."""

    def __init__(self, cfg: dict, scene: dict, device,
                 bench_dir: str = BENCH_DIR):
        physics, Reference = reference_for(cfg, bench_dir)
        phys = physics(cfg, scene["domain_min"], scene["domain_max"])
        self.ref = Reference(phys, scene["prop"], scene["pos"], device,
                             precision="bfloat16")
        self.n = int(scene["prop"].shape[0])
        self.ghost_rows = 0

    @staticmethod
    def describe(state) -> str:
        return "the control"

    @property
    def rebuilds(self) -> int:
        return self.ref.rebuilds

    def start(self, pos64, vel64):
        return State(pos64.to(self.ref.dtype), vel64.to(self.ref.dtype), 0.0)

    @staticmethod
    def fresh(state):
        return State(state.pos.clone(), state.vel.clone(), state.time)

    def chunk(self, state, steps: int):
        pos, vel = self.ref.run(state.pos, state.vel, state.time, steps)
        ok = bool(torch.isfinite(pos).all() and torch.isfinite(vel).all())
        return State(pos, vel, state.time + steps * self.ref.p.dt), steps, ok
