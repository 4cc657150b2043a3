"""The system under test: the port's ``Simulation`` on a configuration's
scene, driven as the command line steps a case (``cli.run``): one output
interval a chunk through ``run_chunk_guarded``, then ``refresh_ghosts`` at
the chunk boundary.

The only module of the benchmark that imports ``particlemethod_fsi_tpu_torch``.
From it the benchmark takes the system, its spans (``profile_events``), its
counters (``rebuilds``, ``ghost_refreshes``) and its kernels' names; it
hands the program the scene's arrays and the configuration's numbers, and
reads back only the states the program returns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from particlemethod_fsi_tpu_torch.config import (
    CaseConfig, CompatFlags, NumericsConfig, SceneConfig)
from particlemethod_fsi_tpu_torch.io.grid_file import GridData
from particlemethod_fsi_tpu_torch.solver import Simulation

def case_config(cfg: dict, dtype: str | None = None) -> CaseConfig:
    """The port's case configuration of a configuration file."""
    if cfg.get("walls", "static") != "static":
        raise ValueError("only static walls are configured")
    numerics = dict(cfg["numerics"])
    if dtype is not None:
        numerics["dtype"] = dtype
    return CaseConfig(
        dt=cfg["dt"], elastic_dt=cfg["elastic_dt"],
        radius_ratio_a=cfg["radius_ratio_a"],
        radius_ratio_p=cfg["radius_ratio_p"],
        radius_ratio_v=cfg["radius_ratio_v"],
        density=tuple(cfg["density"]),
        bulk_modulus=tuple(cfg["bulk_modulus"]),
        bulk_viscosity=tuple(cfg["bulk_viscosity"]),
        shear_viscosity=tuple(cfg["shear_viscosity"]),
        surface_tension=tuple(cfg["surface_tension"]),
        young_modulus=tuple(cfg["young_modulus"]),
        poisson_ratio=tuple(cfg["poisson_ratio"]),
        interaction_ratio=tuple(tuple(r) for r in cfg["interaction_ratio"]),
        gravity=tuple(cfg["gravity"]),
        two_dimensional=cfg["two_dimensional"],
        scene=SceneConfig(**cfg["scene_physics"]),
        compat=dataclasses.replace(CompatFlags(), **cfg["compat"]),
        numerics=NumericsConfig(**numerics),
    )


def grid_data(scene: dict) -> GridData:
    return GridData(
        time=0.0, spacing=scene["spacing"],
        domain_min=np.asarray(scene["domain_min"], dtype=np.float64),
        domain_max=np.asarray(scene["domain_max"], dtype=np.float64),
        prop=scene["prop"], position=scene["pos"],
        initial_position=scene["pos"].copy(), velocity=scene["vel"])


class Program:
    """One configured ``Simulation`` and the start state of the seed."""

    def __init__(self, cfg: dict, scene: dict, device, dtype=None):
        self.sim = Simulation(case_config(cfg, dtype), grid_data(scene),
                              device=device)
        self.n = self.sim.n

    def start(self, pos64: torch.Tensor, vel64: torch.Tensor):
        """The seed's start state in the program's slots and type."""
        s0 = self.sim.state0
        pad = s0.pos.shape[0] - pos64.shape[0]
        pos = torch.nn.functional.pad(pos64, (0, 0, 0, pad))
        vel = torch.nn.functional.pad(vel64, (0, 0, 0, pad))
        return s0.replace(pos=pos.to(s0.pos.dtype), vel=vel.to(s0.vel.dtype))

    @staticmethod
    def fresh(state):
        """A new device copy of every tensor of ``state``."""
        return state.replace(**{k: v.clone()
                                for k, v in state._asdict().items()})

    def chunk(self, state, steps: int):
        """One output interval, then the chunk boundary's ghost upkeep:
        ``(state, steps done, healthy)``."""
        state, done, healthy = self.sim.run_chunk_guarded(state, steps)
        self.sim.refresh_ghosts(state)
        return state, done, healthy

    def spans_on(self, on: bool):
        self.sim.profile_events = [] if on else None

    def take_spans(self) -> list:
        events = self.sim.profile_events or []
        self.sim.profile_events = []
        return events

    @property
    def rebuilds(self) -> int:
        return self.sim.rebuilds

    def describe(self, state) -> str:
        """The program's own counts at the end of the window, for the log."""
        sim = self.sim
        valid = state.prop >= 0
        lo = state.pos[valid].amin(dim=0).tolist()
        hi = state.pos[valid].amax(dim=0).tolist()
        axes = (tuple(bool(a) for a in sim._ghost_axes.tolist())
                if sim._ghosts is not None else None)
        return (f"{state.pos.shape[0]} slots, ghost rows {self.ghost_rows} "
                f"on axes {axes}, ghost plan "
                f"rebuilds {sim.ghost_refreshes}, ghost overflow "
                f"{int(state.ghost_overflow)}, last state's extremes {lo} "
                f"{hi}")

    @property
    def ghost_rows(self) -> int:
        g = self.sim._ghosts
        return g.total_capacity if g is not None else 0


def section_ms(events) -> dict:
    """Milliseconds of each section summed over the steps the marks cover:
    the interval between a mark and the one before it, within a step."""
    spans: dict = {}
    for (_, a), (name, b) in zip(events, events[1:]):
        if name != "begin":
            spans[name] = spans.get(name, 0.0) + a.elapsed_time(b)
    return spans
