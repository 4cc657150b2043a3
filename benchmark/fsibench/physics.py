"""The constants of one configuration, worked out from its file alone.

Each constant is derived here from its definition in the reference solver
(``src/main.cpp``), not copied from the port:

- the kernel of the P and V families, w(r) = (1 - r/R)^2 / (Swp R^dim)
  (``:267-368``), whose normalizer Swp is the kernel shape's integral over
  its support in units of the particle volume l0^dim (``:1191-1213``),
  :func:`kernel_integral`;
- the lattice number density N0p, the sum of w over the sites of a perfect
  lattice of spacing l0 within R of one site, that site left out
  (``:1216-1304``), :func:`lattice_number_density`;
- the domain's upper corner moved to the lower one plus a whole number of
  spacings (``initializeDomain``, ``:1418-1437``), :func:`adjust_domain`.

``benchmark/tests`` pins each against a hand computation (the lattice
shells within 2.5 l0 in 2-D and 3-D, the integral by quadrature) and
against the port's values.  Only what the benchmark's configurations use is
kept: uniform radii, no surface tension (so the A and G families and
``CofA`` drop out), uniform interaction ratios and static walls.
:func:`physics` refuses a file that asks for anything else.  Imports
neither the port nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

TYPE_COUNT = 6


@dataclasses.dataclass(frozen=True)
class Physics:
    dim: int  # 2 or 3 (2: z is never touched)
    spacing: float
    volume: float  # spacing ** dim
    dt: float
    elastic_dt: float
    substeps: int
    radius: float  # the P and V families' radius (uniform radii)
    wnorm: float  # 1 / Swp / radius ** dim
    n0p: float
    c_visc: float  # 8 in 2-D, 10 in 3-D (src/main.cpp:2478-2522)
    domain_min: tuple
    domain_width: tuple
    density: tuple
    bulk_modulus: tuple
    bulk_viscosity: tuple
    shear_viscosity: tuple
    young_modulus: tuple
    poisson_ratio: tuple
    gravity: tuple
    # the Turek-Hron inlet (src/main.cpp:419-438), None elsewhere
    inlet: dict | None
    # Dirichlet clamp of structure rows: (axis, threshold, greater) or None
    clamp: tuple | None
    double_substep: bool
    # the initial structure neighbours' reach: radius + 0.1 spacing
    structure_reach: float


def adjust_domain(domain_min, domain_max, spacing: float, dim: int):
    """DomainMax moved to DomainMin plus the whole number of spacings
    nearest the width, at least one (never z in 2-D)."""
    dmin = np.asarray(domain_min, dtype=np.float64).copy()
    dmax = np.asarray(domain_max, dtype=np.float64).copy()
    for d in range(dim):
        width = dmax[d] - dmin[d]
        n = max(1, math.floor(width / spacing + 0.5))
        if n * spacing != width:
            dmax[d] = dmin[d] + n * spacing
    return dmin, dmax


def kernel_integral(dim: int) -> float:
    """The integral of (1 - |s|)^2 over the unit disk (2-D) or ball (3-D):
    the unit circle's length or sphere's area times the radial integral
    of (1 - s)^2 s^(dim - 1) from 0 to 1 (1/12 and 1/30).  Swp is this
    over l0^dim, so that the kernel's sum over a continuum of particles,
    one to each volume l0^dim, is 1."""
    if dim == 2:
        return 2.0 * math.pi * (1.0 / 12.0)
    return 4.0 * math.pi * (1.0 / 30.0)


def lattice_number_density(radius: float, spacing: float, dim: int,
                           wnorm: float) -> float:
    """Sum of w(r) = wnorm (1 - r/radius)^2 over a perfect lattice's sites
    within ``radius`` of the origin, the origin left out."""
    rng = int(radius / spacing + 3.0)
    ax = np.arange(-rng, rng + 1, dtype=np.float64) * spacing
    grids = np.meshgrid(*([ax] * dim), indexing="ij")
    r2 = sum(g * g for g in grids)
    mask = (r2 <= radius * radius) & (r2 > 0.0)
    r = np.sqrt(r2[mask])
    return float(np.sum(wnorm * (1.0 - r / radius) ** 2))


def physics(cfg: dict, domain_min, domain_max) -> Physics:
    """The constants of configuration ``cfg`` (its file, as a dict) for a
    scene whose domain the scene builder gave."""
    dim = 2 if cfg["two_dimensional"] else 3
    l0 = float(cfg["sizes"]["spacing"])
    ra, rp, rv = (cfg["radius_ratio_a"], cfg["radius_ratio_p"],
                  cfg["radius_ratio_v"])
    if not ra == rp == rv:
        raise ValueError("the reference takes uniform radii only")
    if any(v != 0.0 for v in cfg["surface_tension"]):
        raise ValueError("the reference takes no surface tension")
    if any(r != 1.0 for row in cfg["interaction_ratio"] for r in row):
        raise ValueError("the reference takes uniform interaction ratios only")
    if cfg.get("walls", "static") != "static":
        raise ValueError("the reference takes static walls only")
    radius = rp * l0
    swp = kernel_integral(dim) / l0 ** dim
    wnorm = 1.0 / swp / radius ** dim
    dmin, dmax = adjust_domain(domain_min, domain_max, l0, dim)
    scene = cfg["scene_physics"]
    inlet = None
    if scene.get("velocity_profile") == "turek_inlet":
        inlet = {k: float(scene[k]) for k in
                 ("turek_ymin", "turek_ymax", "turek_umax",
                  "turek_outlet_until")}
    elif scene.get("velocity_profile") is not None:
        raise ValueError(f"profile {scene['velocity_profile']!r} not taken")
    clamp = None
    if scene.get("clamp_threshold") is not None:
        if scene.get("clamp2_threshold") is not None:
            raise ValueError("the reference takes one clamp region only")
        clamp = (int(scene["clamp_axis"]), float(scene["clamp_threshold"]),
                 bool(scene.get("clamp_greater", False)))
    return Physics(
        dim=dim, spacing=l0, volume=l0 ** dim, dt=float(cfg["dt"]),
        elastic_dt=float(cfg["elastic_dt"]),
        substeps=int(cfg["dt"] / cfg["elastic_dt"] + 0.5),
        radius=radius, wnorm=wnorm,
        n0p=lattice_number_density(radius, l0, dim, wnorm),
        c_visc=8.0 if dim == 2 else 10.0,
        domain_min=tuple(float(v) for v in dmin),
        domain_width=tuple(float(v) for v in dmax - dmin),
        density=tuple(map(float, cfg["density"])),
        bulk_modulus=tuple(map(float, cfg["bulk_modulus"])),
        bulk_viscosity=tuple(map(float, cfg["bulk_viscosity"])),
        shear_viscosity=tuple(map(float, cfg["shear_viscosity"])),
        young_modulus=tuple(map(float, cfg["young_modulus"])),
        poisson_ratio=tuple(map(float, cfg["poisson_ratio"])),
        gravity=tuple(map(float, cfg["gravity"])),
        inlet=inlet, clamp=clamp,
        double_substep=bool(cfg["compat"]["double_substep_position_update"]),
        structure_reach=radius + 0.1 * l0,
    )
