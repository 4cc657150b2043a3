"""Smoothing-kernel function library and setup-time calibration constants.

Counterpart of ``particlemethod_fsi_tpu/ops/smoothing.py`` (an independent
copy: host float64 constants only, no tensors).  Re-implements the
reference's four quadratic-spike kernel families and their normalization
machinery (``src/main.cpp:267-368`` for the kernels, ``:1191-1309`` for
``initializeWeight``, ``:1329-1341`` for the surface-tension calibration in
``initializeFluid``):

* four families with independent support radii: A (attractive pressure,
  shape ``q(1-q)^2``), G (gravity-center / diffuse interface), P (base
  pressure / weight), V (viscosity), all with shape ``(1-q)^2`` except A;
* analytic normalizers ``Sw*`` and the diffuse-interface scale ``R2g``
  switched by dimensionality (src/main.cpp:1201-1213);
* reference lattice number densities ``N0a``/``N0p`` summed over a perfect
  lattice within the support radius (src/main.cpp:1216-1304);
* surface-tension coefficient calibration ``CofA`` from hard-coded
  diffuse-interface integrals and ``CofK`` (src/main.cpp:1329-1341).

All constants are plain Python floats computed at setup in float64; the CUDA
kernels receive the ones they need as launch parameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class KernelSet:
    """Static kernel constants for one case setup."""

    two_dimensional: bool
    spacing: float
    radius_a: float
    radius_g: float
    radius_p: float
    radius_v: float
    swa: float
    swg: float
    swp: float
    swv: float
    r2g: float
    n0a: float
    n0p: float
    cof_k: float
    cof_a: tuple[float, ...]  # per type
    max_radius: float
    margin: float  # neighbor-list skin = 0.1*spacing (src/main.cpp:116)

    @property
    def dim_power(self) -> int:
        return 2 if self.two_dimensional else 3

    @property
    def support_radius(self) -> float:
        """Neighbor candidate radius = MaxRadius + MARGIN (src/main.cpp:1765)."""
        return self.max_radius + self.margin

    # --- kernel family evaluations (vectorized over numpy arrays or tensors) -------------
    # shapes are evaluated un-clamped; callers mask by their own radius test,
    # matching the reference's call-site `radius^2 - rij2 >= 0` guards.

    def _norm(self, sw: float, h: float) -> float:
        return 1.0 / sw / h**self.dim_power

    def wa(self, r):
        q = r / self.radius_a
        return self._norm(self.swa, self.radius_a) * q * (1.0 - q) ** 2

    def dwadr(self, r):
        q = r / self.radius_a
        return (
            self._norm(self.swa, self.radius_a)
            * (1.0 - q) * (1.0 - 3.0 * q) / self.radius_a
        )

    def wg(self, r):
        q = r / self.radius_g
        return self._norm(self.swg, self.radius_g) * (1.0 - q) ** 2

    def dwgdr(self, r):
        q = r / self.radius_g
        return self._norm(self.swg, self.radius_g) * (-2.0 / self.radius_g) * (1.0 - q)

    def wp(self, r):
        q = r / self.radius_p
        return self._norm(self.swp, self.radius_p) * (1.0 - q) ** 2

    def dwpdr(self, r):
        q = r / self.radius_p
        return self._norm(self.swp, self.radius_p) * (-2.0 / self.radius_p) * (1.0 - q)

    def wv(self, r):
        q = r / self.radius_v
        return self._norm(self.swv, self.radius_v) * (1.0 - q) ** 2

    def dwvdr(self, r):
        q = r / self.radius_v
        return self._norm(self.swv, self.radius_v) * (-2.0 / self.radius_v) * (1.0 - q)

    def weight(self, r, radius: float):
        """The generic WLS weight: wp-normalized (1-q)^2 at arbitrary radius
        (src/main.cpp:267-295; used by the solid pipeline with RadiusP)."""
        q = r / radius
        return self._norm(self.swp, radius) * (1.0 - q) ** 2


def _lattice_number_density(kernel, radius: float, spacing: float, two_dimensional: bool) -> float:
    """Sum kernel over perfect-lattice sites within `radius`, excluding the
    origin (initializeWeight's N0a/N0p sums, src/main.cpp:1216-1304)."""
    rng = int(radius / spacing + 3.0)
    ax = np.arange(-rng, rng + 1, dtype=np.float64) * spacing
    if two_dimensional:
        x, y = np.meshgrid(ax, ax, indexing="ij")
        r2 = x * x + y * y
    else:
        x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
        r2 = x * x + y * y + z * z
    mask = (r2 <= radius * radius) & (r2 > 0.0)
    r = np.sqrt(r2[mask])
    # kernel methods are dtype-generic arithmetic; numpy float64 in -> f64 out
    return float(np.sum(kernel(r)))


def build_kernels(
    *,
    spacing: float,
    radius_ratio_a: float,
    radius_ratio_p: float,
    radius_ratio_v: float,
    surface_tension: tuple[float, ...],
    two_dimensional: bool,
) -> KernelSet:
    """Compute all kernel constants (initializeWeight + the CofA part of
    initializeFluid, src/main.cpp:1191-1341).  RadiusRatioG is aliased to
    RadiusRatioA (src/main.cpp:1193)."""
    l0 = spacing
    radius_a = radius_ratio_a * l0
    radius_g = radius_ratio_a * l0
    radius_p = radius_ratio_p * l0
    radius_v = radius_ratio_v * l0

    if two_dimensional:
        swa = 0.5 * (2.0 / 15.0) * math.pi / l0**2
        swg = 0.5 * (1.0 / 3.0) * math.pi / l0**2
        swp = swg
        swv = swg
        r2g = 0.5 * (1.0 / 30.0) * math.pi * radius_g**2 / l0**2 / swg
        cof_k = 0.350778153
        integ_n = 0.024679383
        integ_x = 0.226126699
    else:
        swa = (1.0 / 3.0) * (1.0 / 5.0) * math.pi / l0**3
        swg = (1.0 / 3.0) * (2.0 / 5.0) * math.pi / l0**3
        swp = swg
        swv = swg
        r2g = (1.0 / 3.0) * (4.0 / 105.0) * math.pi * radius_g**2 / l0**3 / swg
        cof_k = 0.326976006
        integ_n = 0.021425779
        integ_x = 0.233977488

    max_radius = max(radius_a, radius_g, radius_p, radius_v)

    ks = KernelSet(
        two_dimensional=two_dimensional,
        spacing=l0,
        radius_a=radius_a,
        radius_g=radius_g,
        radius_p=radius_p,
        radius_v=radius_v,
        swa=swa,
        swg=swg,
        swp=swp,
        swv=swv,
        r2g=r2g,
        n0a=0.0,
        n0p=0.0,
        cof_k=cof_k,
        cof_a=tuple(
            st / ((radius_g / l0) * (integ_n + cof_k * cof_k * integ_x))
            for st in surface_tension
        ),
        max_radius=max_radius,
        margin=0.1 * l0,
    )
    n0a = _lattice_number_density(ks.wa, radius_a, l0, two_dimensional)
    n0p = _lattice_number_density(ks.wp, radius_p, l0, two_dimensional)
    return KernelSet(**{**ks.__dict__, "n0a": n0a, "n0p": n0p})
