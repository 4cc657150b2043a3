"""Scene builder of the configuration ``turek-1m``: the Turek-Hron channel
(walls, cylinder, flag and fluid on one lattice of spacing l0, segment-sorted
fluid, structure, wall, the fluid primed with the steady parabolic profile;
the lattice ``models/turek.turek_grid`` of the port and
``cases/turek/generate.py`` make).  Plain numpy; imports nothing of the
port."""

from __future__ import annotations

import numpy as np


def _lattice(x0, x1, y0, y1, l0):
    nx = int(round((x1 - x0) / l0))
    ny = int(round((y1 - y0) / l0))
    xs = x0 + (np.arange(nx) + 0.5) * l0
    ys = y0 + (np.arange(ny) + 0.5) * l0
    return np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1).reshape(-1, 2)


def build(cfg: dict) -> dict:
    l0 = float(cfg["sizes"]["spacing"])
    g = cfg["geometry"]
    xmax, ymax, nwall = g["length"], g["height"], g["wall_rows"]
    cx, cy, r = g["cylinder"]
    fx0, fx1, fy0, fy1 = g["flag"]
    pts = _lattice(0.0, xmax, -nwall * l0, ymax + nwall * l0, l0)
    x, y = pts[:, 0], pts[:, 1]
    in_channel = (y > 0.0) & (y < ymax)
    in_disk = (x - cx) ** 2 + (y - cy) ** 2 <= r * r
    in_flag = (x > fx0) & (x < fx1) & (y > fy0) & (y < fy1)
    prop = np.full(pts.shape[0], -1, dtype=np.int32)
    prop[~in_channel] = 4
    prop[in_channel & in_disk & ~in_flag] = 4
    prop[in_channel & in_flag] = 2
    prop[in_channel & ~in_disk & ~in_flag] = 1
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
    u = 4.0 * g["umax"] / (ymax * ymax) * pos[:, 1] * (ymax - pos[:, 1])
    vel[fluid, 0] = np.clip(u[fluid], 0.0, None)
    return dict(
        prop=prop, pos=pos, vel=vel, spacing=l0,
        domain_min=np.array([0.0, -nwall * l0, 0.0]),
        domain_max=np.array([xmax, ymax + nwall * l0, l0]),
    )
