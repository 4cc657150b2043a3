"""The Turek-Hron channel: an elastic flag behind a rigid cylinder in an
x-periodic channel flow (the reference's Turek_Hron module,
src/main.cpp:56, 419-441, 1990-2004).

Counterpart of the lattice in ``cases/turek/generate.py`` (the same sites,
types, order and primed velocity, so the grid is the one that script
writes) and of the run ``cases/turek/execute.sh`` makes: the ``.data`` of
``cases/turek/turek.data``, scene ``turek_hron`` (flag clamp, parabolic
inlet re-imposed every step), C8 margin 1.0.  Channel [0, 2.5] x [0, 0.41],
cylinder r = 0.05 at (0.2, 0.2), flag 0.4 x 0.02, three wall rows at top
and bottom.  At ``l0=5e-3`` the grid holds 44,000 particles; at ``1e-3``
1,040,000, with the step scaled to the spacing (``dt=2e-5``,
``elastic_dt=4e-6``, as the README's run of that size).  The channel is
periodic in x with fluid at both ends, so every step runs on a
ghost-extended frame.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from particlemethod_fsi_tpu_torch.config import SCENES, CaseConfig, NumericsConfig
from particlemethod_fsi_tpu_torch.io.data_file import parse_data_file
from particlemethod_fsi_tpu_torch.io.grid_file import GridData
from particlemethod_fsi_tpu_torch.solver import Simulation

L0 = 5e-3  # the spacing of turek.data's time steps
XMAX, YMAX = 2.5, 0.41
CX, CY, R = 0.2, 0.2, 0.05
FLAG_X0, FLAG_X1 = 0.2, 0.6
FLAG_Y0, FLAG_Y1 = 0.19, 0.21
NWALL = 3  # wall rows top/bottom
# time steps at the spacings the repository runs: the .data's, and the
# CFL-scaled pair of the 1M-particle run
STEPS = {5e-3: (1e-4, 2e-5), 1e-3: (2e-5, 4e-6)}

DATA_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "cases", "turek", "turek.data")


def _lattice(x0, x1, y0, y1, l0):
    nx = int(round((x1 - x0) / l0))
    ny = int(round((y1 - y0) / l0))
    xs = x0 + (np.arange(nx) + 0.5) * l0
    ys = y0 + (np.arange(ny) + 0.5) * l0
    return np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1).reshape(-1, 2)


def turek_grid(l0: float = L0) -> GridData:
    """Walls, cylinder, flag and fluid on one lattice of spacing ``l0``,
    segment-sorted (fluid, structure, wall), the fluid primed with the
    steady parabolic profile."""
    pts = _lattice(0.0, XMAX, -NWALL * l0, YMAX + NWALL * l0, l0)
    x, y = pts[:, 0], pts[:, 1]
    in_channel = (y > 0.0) & (y < YMAX)
    in_disk = (x - CX) ** 2 + (y - CY) ** 2 <= R * R
    in_flag = (x > FLAG_X0) & (x < FLAG_X1) & (y > FLAG_Y0) & (y < FLAG_Y1)

    prop = np.full(pts.shape[0], -1, dtype=np.int32)
    prop[~in_channel] = 4                       # top/bottom walls
    prop[in_channel & in_disk & ~in_flag] = 4   # cylinder
    prop[in_channel & in_flag] = 2              # elastic flag
    prop[in_channel & ~in_disk & ~in_flag] = 1  # fluid

    keep = prop >= 0
    prop, pts = prop[keep], pts[keep]
    order = np.argsort(np.where(prop < 2, 0, np.where(prop < 4, 1, 2)),
                       kind="stable")
    prop, pts = prop[order], pts[order]

    n = prop.shape[0]
    pos = np.zeros((n, 3))
    pos[:, :2] = pts
    pos[:, 2] = 0.5 * l0
    vel = np.zeros((n, 3))
    fluid = prop < 2
    u = 4.0 * 1.0 / (YMAX * YMAX) * pos[:, 1] * (YMAX - pos[:, 1])
    vel[fluid, 0] = np.clip(u[fluid], 0.0, None)
    return GridData(
        time=0.0, spacing=l0,
        domain_min=np.array([0.0, -NWALL * l0, 0.0]),
        domain_max=np.array([XMAX, YMAX + NWALL * l0, l0]),
        prop=prop, position=pos, initial_position=pos.copy(), velocity=vel,
    )


def turek_config(l0: float = L0, **numerics_kw) -> CaseConfig:
    """The physics of the repository's ``cases/turek/turek.data`` for the
    scene ``turek_hron``, 2-D, with the time steps of spacing ``l0``
    (scaled from the file's, which are for 5e-3) and the C8 margin 1.0
    unless ``numerics_kw`` says otherwise."""
    cfg = parse_data_file(DATA_FILE)
    dt, elastic_dt = STEPS.get(l0, (cfg.dt * l0 / L0, cfg.elastic_dt * l0 / L0))
    return cfg.replace(
        dt=dt, elastic_dt=elastic_dt, scene=SCENES["turek_hron"],
        two_dimensional=True,
        numerics=dataclasses.replace(
            NumericsConfig(), **{"rebuild_margin": 1.0, **numerics_kw}))


def build_turek(l0: float = L0, device=None, **numerics_kw) -> Simulation:
    """The channel as a ready :class:`Simulation` (on the card unless
    ``device="cpu"``); ``numerics_kw`` go to :class:`NumericsConfig`."""
    return Simulation(turek_config(l0, **numerics_kw), turek_grid(l0),
                      device=device)
