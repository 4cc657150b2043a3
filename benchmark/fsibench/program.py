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
    TYPE_COUNT, CaseConfig, CompatFlags, NumericsConfig, RollingMotion,
    SceneConfig, WallMotion)
from particlemethod_fsi_tpu_torch.io.grid_file import GridData
from particlemethod_fsi_tpu_torch.solver import Simulation

# top-level keys of a configuration file that are the benchmark's own: the
# manifest's name, source and cuts, the scene builder's name and inputs, the
# plain reference's name, and notes.  Every other key is a field of the
# port's CaseConfig, and the file's ``scene_physics`` is its ``scene``.
OWN_KEYS = frozenset({"name", "source", "scene", "reference", "reduced",
                      "assumed", "sizes", "geometry", "particles", "slots",
                      "memory"})
SCENE_KEY = "scene_physics"


def _fields(cls, group: dict, where: str) -> dict:
    """``group``'s keys, each a field of ``cls``; any other is refused by
    name."""
    if not isinstance(group, dict):
        raise ValueError(f"{where}: not an object")
    unknown = sorted(set(group) - {f.name for f in dataclasses.fields(cls)})
    if unknown:
        raise ValueError(f"{where}: {', '.join(unknown)} not a field of the "
                         f"port's {cls.__name__}")
    return dict(group)


def _tuples(value):
    """JSON lists as the tuples the port's frozen dataclasses hold."""
    if isinstance(value, list):
        return tuple(_tuples(v) for v in value)
    return value


def wall_motion(walls) -> tuple | None:
    """``walls``: ``"static"`` (None: the port's default) or a list of six
    ``{center, velocity, omega}``, one a particle type."""
    if walls == "static":
        return None
    if not isinstance(walls, list) or len(walls) != TYPE_COUNT:
        raise ValueError(f"walls: \"static\" or a list of {TYPE_COUNT} "
                         "wall motions, one a type")
    return tuple(WallMotion(**{k: _tuples(v) for k, v in _fields(
        WallMotion, w, f"walls[{t}]").items()}) for t, w in enumerate(walls))


def scene_config(group: dict) -> SceneConfig:
    """The port's SceneConfig of ``scene_physics``, its ``rolling``
    (``{max_angle_deg, period}``) a RollingMotion."""
    kw = _fields(SceneConfig, group, SCENE_KEY)
    if kw.get("rolling") is not None:
        kw["rolling"] = RollingMotion(**_fields(
            RollingMotion, kw["rolling"], f"{SCENE_KEY}.rolling"))
    return SceneConfig(**kw)


def case_config(cfg: dict, dtype: str | None = None) -> CaseConfig:
    """The port's case configuration of a configuration file: every field
    of CaseConfig the file states, nested classes included, and the port's
    default for the rest; ``dtype`` overrides the numerics' type.  A key
    that is neither the benchmark's own nor a field of the port's class is
    refused by name."""
    case_fields = {f.name for f in dataclasses.fields(CaseConfig)}
    unknown = sorted(set(cfg) - OWN_KEYS - {SCENE_KEY}
                     - (case_fields - {"scene"}))
    if unknown:
        raise ValueError(f"{', '.join(unknown)}: neither the benchmark's own "
                         "key nor a field of the port's CaseConfig")
    kw = {}
    for key, value in cfg.items():
        if key in OWN_KEYS:
            continue
        if key == SCENE_KEY:
            kw["scene"] = scene_config(value)
        elif key == "walls":
            walls = wall_motion(value)
            if walls is not None:
                kw["walls"] = walls
        elif key == "compat":
            kw["compat"] = CompatFlags(**_fields(CompatFlags, value, key))
        elif key == "numerics":
            kw["numerics"] = NumericsConfig(**_fields(NumericsConfig, value,
                                                      key))
        else:
            kw[key] = _tuples(value)
    if dtype is not None:
        kw["numerics"] = dataclasses.replace(
            kw.get("numerics", NumericsConfig()), dtype=dtype)
    return CaseConfig(**kw)


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
