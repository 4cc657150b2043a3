"""The breaking-wave case: a long 3-D tank with a raised water slab that
collapses into a surge hitting a row of elastic posts (``cases/wave``).

Counterpart of the lattice in ``cases/wave/generate.py`` (the same sites,
types, order and domain, so :func:`wave_grid` is the grid that script
writes at the same ``--scale``), which imports the JAX package.  Tank
2.0 x 0.25 x 0.20 m, ``l0 = 1.66 mm / scale``: 130,734 particles at
scale 0.2 (the ``.data``'s design point, ``cases/wave/wave.data``) and
1,110,766 at 0.46, growing about as scale^3.  The long x axis suits the
1-D slab halo decomposition (``parallel/halo.py``).  As a command, it writes the grid:

    python -m particlemethod_fsi_tpu_torch.models.wave --scale 0.2 --out wave.grid

and, past scale 0.2, prints the ``--dt`` / ``--elastic-dt`` the command
line needs (time steps scale with ``l0``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from particlemethod_fsi_tpu_torch.io.grid_file import GridData, write_grid_file

LX, LY, LZ = 2.0, 0.25, 0.20
NW = 3  # wall layers
POSTS_X = (0.9, 1.1, 1.3)
POSTS_Z = (0.05, 0.10, 0.15)
DATA_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "cases", "wave", "wave.data")


def spacing(scale: float) -> float:
    return 0.00166 / scale


def _lattice(lo, hi, l0):
    n = np.maximum(np.round((np.asarray(hi) - lo) / l0), 1).astype(int)
    axes = [lo[d] + (np.arange(n[d]) + 0.5) * l0 for d in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def wave_grid(scale: float = 0.2) -> GridData:
    """Fluid (a pool and a raised column at the left end), nine elastic
    posts (type 2) standing in the pool, and floor, end and side walls
    (type 4) three layers thick; segment-sorted (fluid, structure, wall).
    The domain leaves a gap of 4 l0 (more than the support) beyond the
    outer wall shells, so no axis wraps."""
    l0 = spacing(scale)
    nw = NW
    blocks = [(1, _lattice((0.0, 0.0, 0.0), (LX, 0.06, LZ), l0)),
              (1, _lattice((0.0, 0.06, 0.0), (0.35, 0.22, LZ), l0))]
    for xc in POSTS_X:
        for zc in POSTS_Z:
            blocks.append((2, _lattice((xc, 0.0, zc - 0.008),
                                       (xc + 0.012, 0.12, zc + 0.008), l0)))
    blocks += [
        (4, _lattice((-nw * l0, -nw * l0, -nw * l0),
                     (LX + nw * l0, 0.0, LZ + nw * l0), l0)),
        (4, _lattice((-nw * l0, 0.0, -nw * l0), (0.0, LY, LZ + nw * l0), l0)),
        (4, _lattice((LX, 0.0, -nw * l0), (LX + nw * l0, LY, LZ + nw * l0),
                     l0)),
        (4, _lattice((0.0, 0.0, -nw * l0), (LX, LY, 0.0), l0)),
        (4, _lattice((0.0, 0.0, LZ), (LX, LY, LZ + nw * l0), l0)),
    ]
    # the posts displace water: no fluid site inside a post box
    post_boxes = [(xc, xc + 0.012, zc - 0.008, zc + 0.008)
                  for xc in POSTS_X for zc in POSTS_Z]
    pts, prop = [], []
    for t, g in blocks:
        if t == 1:
            m = np.ones(len(g), bool)
            for (x0, x1, z0, z1) in post_boxes:
                m &= ~((g[:, 0] >= x0) & (g[:, 0] < x1)
                       & (g[:, 2] >= z0) & (g[:, 2] < z1) & (g[:, 1] < 0.12))
            g = g[m]
        pts.append(g)
        prop.append(np.full(len(g), t, np.int32))
    pts = np.concatenate(pts)
    prop = np.concatenate(prop)
    order = np.argsort(np.where(prop < 2, 0, np.where(prop < 4, 1, 2)),
                       kind="stable")
    pts, prop = pts[order], prop[order]
    gap = 4 * l0
    return GridData(
        time=0.0, spacing=l0,
        domain_min=np.array([-nw * l0 - gap, -nw * l0 - gap, -nw * l0 - gap]),
        domain_max=np.array([LX + nw * l0 + gap, LY, LZ + nw * l0 + gap]),
        prop=prop, position=pts, initial_position=pts.copy(),
        velocity=np.zeros_like(pts))


def steps(scale: float) -> tuple[float, float]:
    """(dt, elastic_dt) CFL-scaled from the ``.data``'s design point, scale
    0.2 (Dt 1e-4, ElasticDt 2e-5)."""
    f = max(scale / 0.2, 1.0)
    return 1e-4 / f, 2e-5 / f


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="write the breaking-wave case's grid")
    ap.add_argument("--scale", type=float, default=0.2,
                    help="linear resolution scale (0.2 => 130,734 particles)")
    ap.add_argument("--out", default="wave.grid")
    args = ap.parse_args(argv)
    grid = wave_grid(args.scale)
    write_grid_file(grid, args.out)
    counts = [int((grid.prop == t).sum()) for t in range(6)]
    print(f"{grid.n} particles were generated (types {counts})")
    if args.scale > 0.2 + 1e-9:
        dt, edt = steps(args.scale)
        print(f"NOTE: scale {args.scale:g} shrinks l0 by "
              f"{args.scale / 0.2:.1f}x vs the .data's design point; pass "
              f"--dt {dt:.2e} --elastic-dt {edt:.2e} to the CLI (CFL scales "
              "with l0)")


if __name__ == "__main__":
    main()
