"""Scene builder of the configuration ``dam3d-2m``: the reference's Dam case
made 3-D.  The configuration lists the Dam case's cuboids in x and y (the
water column, the floor and the two side walls, as ``cases/dam/dam.boid``
has them) and its domain in x and y.  In the Dam case every cuboid and the
domain span the same z range, one spacing deep, and the reference's domain
is periodic on every axis; here that z range is ``sizes.depth`` deep, so
the scene is the same basin, periodic across its depth.  Sites, types and
order are the generator's (``particlemethod_fsi_tpu_torch/generator.py`` on
the same primitives).  Plain numpy; imports nothing of the port."""

from __future__ import annotations

import numpy as np


def _axis(lo: float, hi: float, space: float) -> np.ndarray:
    """The generator's 1-D lattice: round(extent / space) sites at
    lo + (k + 0.5) * extent / n."""
    width = hi - lo
    n = int(round(width / space))
    if n <= 0:
        return np.zeros(0)
    return lo + (np.arange(n, dtype=np.float64) + 0.5) * (width / n)


def _cuboid(lower, upper, space):
    ax = [_axis(lower[d], upper[d], space) for d in range(3)]
    g = np.meshgrid(*ax, indexing="ij")  # x outer, y, z inner
    return np.stack([a.ravel() for a in g], axis=1)


def primitives(cfg: dict) -> tuple:
    """``([(type, lower, upper), ...], domain_min, domain_max)`` in 3-D, in
    the generator's order: each cuboid, and the domain, over z from 0 to
    the depth."""
    geo = cfg["geometry"]
    depth = float(cfg["sizes"]["depth"])
    boxes = [(int(k), (lo[0], lo[1], 0.0), (hi[0], hi[1], depth))
             for k, lo, hi in geo["cuboids_xy"]]
    (dx0, dy0), (dx1, dy1) = geo["domain_xy"]
    return (boxes, np.array([dx0, dy0, 0.0], dtype=np.float64),
            np.array([dx1, dy1, depth], dtype=np.float64))


def build(cfg: dict) -> dict:
    l0 = float(cfg["sizes"]["spacing"])
    boxes, dmin, dmax = primitives(cfg)
    pos = [_cuboid(lo, hi, l0) for _, lo, hi in boxes]
    prop = np.concatenate([np.full(p.shape[0], k, dtype=np.int32)
                           for (k, _, _), p in zip(boxes, pos)])
    pos = np.concatenate(pos)
    return dict(prop=prop, pos=pos, vel=np.zeros_like(pos), spacing=l0,
                domain_min=dmin, domain_max=dmax)
