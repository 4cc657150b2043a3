"""Case configuration for the PyTorch/CUDA port.

Counterpart of ``particlemethod_fsi_tpu/config.py``: the same plain-data
:class:`CaseConfig` (physics constants, per-type property tables, wall
kinematics, the scenario :class:`SceneConfig`, the dimensionality switch and
the numerics/compat knobs), kept as an independent copy so that this package
never imports the JAX one.  Field names and defaults are identical, so
``dataclasses.asdict`` of a JAX-side config carries across
(:func:`particlemethod_fsi_tpu_torch.convert.case_config_from_dict`).

The reference solver split configuration across a runtime key-value ``.data``
file (``src/main.cpp:729-786``) and compile-time module flags
(``src/main.cpp:54-64``); both tiers are plain data here.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

TYPE_COUNT = 6
# Particle property-id segmentation (src/main.cpp:68-74).
FLUID_BEGIN, FLUID_END = 0, 2
STRUCTURE_BEGIN, STRUCTURE_END = 2, 4
WALL_BEGIN, WALL_END = 4, 6

DIM = 3  # storage dimensionality is always 3, even in 2-D (src/main.cpp:61)


@dataclass(frozen=True)
class WallMotion:
    """Prescribed rigid-wall kinematics for one wall property type (the
    ``Wall6``/``Wall7`` rows of the ``.data`` file, src/main.cpp:766-767)."""

    center: tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity: tuple[float, float, float] = (0.0, 0.0, 0.0)
    omega: tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class RollingMotion:
    """Harmonic rocking wall motion (the reference's ``Rolling`` module,
    src/main.cpp:2958-3029): theta(t) = max_angle * sin(2*pi*t/period)."""

    max_angle_deg: float = 2.0
    period: float = 1.646


@dataclass(frozen=True)
class SceneConfig:
    """Scenario behavior that was compile-time ``#ifdef`` modules in the
    reference (src/main.cpp:54-59, 395-444, 1918-2079).

    ``clamp_*`` defines the Dirichlet region for structure particles by a
    predicate on InitialPosition; ``velocity_profile`` selects the
    initial/inflow velocity injection.
    """

    name: str = "none"
    # Dirichlet clamp on structure particles: InitialPosition[axis] <cmp> threshold
    clamp_axis: int = 0
    clamp_threshold: Optional[float] = None  # None = no clamp
    clamp_greater: bool = False  # False: x0 < thr clamped; True: x0 > thr
    # Second clamp region (Hydroelastic uses x0<0.01 OR x0>1.99, :2020)
    clamp2_threshold: Optional[float] = None
    clamp2_greater: bool = True
    # Velocity profile: "bar_first_mode" | "turek_inlet" | None
    velocity_profile: Optional[str] = None
    # Bar first-bending-mode constants (src/main.cpp:380-384, 395-416)
    bar_length: float = 0.20
    bar_kl: float = 1.875
    bar_bulk_modulus: float = 3.25e6
    bar_amplitude: float = 0.01
    # Turek-Hron inlet constants (src/main.cpp:374-377, 419-438)
    turek_ymin: float = 0.0
    turek_ymax: float = 0.41
    turek_umax: float = 1.0
    turek_outlet_until: float = 0.7
    # Prescribed wall motion applies only while time < this (src/main.cpp:3037)
    wall_motion_end_time: float = 0.2
    # Optional harmonic rocking walls instead of constant motion
    rolling: Optional[RollingMotion] = None

    @property
    def has_clamp(self) -> bool:
        return self.clamp_threshold is not None


# Pre-canned scenes matching the reference's modules (src/main.cpp:54-59).
SCENES = {
    "none": SceneConfig(name="none"),
    "bar": SceneConfig(
        name="bar",
        clamp_axis=0,
        clamp_threshold=0.001,
        velocity_profile="bar_first_mode",
    ),
    "dam": SceneConfig(name="dam", clamp_axis=1, clamp_threshold=0.002),
    "turek_hron": SceneConfig(
        name="turek_hron",
        clamp_axis=0,
        clamp_threshold=0.205,
        velocity_profile="turek_inlet",
    ),
    "rolling1": SceneConfig(name="rolling1", clamp_axis=1, clamp_threshold=0.003),
    "rolling": SceneConfig(
        name="rolling", clamp_axis=1, clamp_threshold=0.003, rolling=RollingMotion()
    ),
    "hydroelastic": SceneConfig(
        name="hydroelastic",
        clamp_axis=0,
        clamp_threshold=0.01,
        clamp2_threshold=1.99,
        clamp2_greater=True,
    ),
}


@dataclass(frozen=True)
class CompatFlags:
    """Behavioral quirks of the reference, replicated by default so that
    trajectories match; each can be disabled to get the "fixed" physics."""

    # Q1: free structure particles integrate x += v*dtE TWICE per substep
    # (src/main.cpp:2045-2079).
    double_substep_position_update: bool = True
    # Q2: neighbor margin-refresh predicate is disabled; rebuild every step
    # (src/main.cpp:608-610).
    rebuild_neighbors_every_step: bool = True
    # Q4: wall prescribed motion frozen after scene.wall_motion_end_time
    # (src/main.cpp:3037).
    freeze_wall_motion: bool = True


@dataclass(frozen=True)
class NumericsConfig:
    """Numerics knobs (no counterpart in the reference).  The ``pallas_*``
    names are kept from the JAX package so that a config carries across; what
    each means for the CUDA window-sweep kernels is said beside it."""

    dtype: str = "float32"  # compute dtype: "float32" (the card) or "float64" (CPU tests)
    # pairwise backend: the two window sweeps over the cell-sorted frame,
    # "pallas_t" (field-major kernels; "auto" selects it on any device, and
    # a frame of 2^24 cells or more goes on to "pallas") and "pallas"
    # (row-major kernels); and the candidate engines "packed" (the first
    # cell_capacity rows of each neighbour cell, plain torch ops) and
    # "gather" (a padded [N, max_neighbors] neighbour matrix, plain torch
    # ops).  In the JAX package "auto" is "packed" off the TPU.
    backend: str = "auto"
    # receivers per window-table row = threads per CUDA thread block (one
    # thread per receiver).  None = 64.
    pallas_block: Optional[int] = None
    # In the JAX package: sender rows copied per window chunk.  The CUDA
    # kernels walk each window exactly from start to start+len in fixed
    # shared-memory tiles, so this knob does not change what they compute or
    # how; it is carried so that configs stay interchangeable.
    pallas_wmax: Optional[int] = None
    # JAX package only (receiver sub-blocks per grid program); ignored here.
    pallas_subblocks: int = 2
    # JAX package only (one pass over all cell-row offsets); ignored here:
    # the CUDA kernels always walk the offsets one after another inside one
    # thread block.
    pallas_merged: Optional[bool] = None
    max_neighbors: int = 64  # K of the gather engine
    max_initial_neighbors: int = 64  # K0 for static structure neighbor rows
    # max particles per cell-list bucket (packed/gather engines only; the
    # window sweep is exact and ignores it).  None: 16 in 2-D, 40 in 3-D.
    # Rows of a fuller cell are dropped from its candidates (the diagnostics'
    # cell_overflow reports the fullest cell).
    cell_capacity: Optional[int] = None
    # C8 knob (the reference's disabled margin-refresh predicate,
    # src/main.cpp:1472-1494, 608-610): 0.0 = rebuild the sorted frame +
    # windows every step (quirk Q2, the shipped behavior).  > 0 widens the
    # cell support by `rebuild_margin * l0` and reuses the previous sort
    # permutation + window tables until the particles have moved apart by
    # more than half the margin since the last rebuild.  Physics is exact
    # either way (family-radius masks test CURRENT positions; the margin only
    # widens the candidate set); only the summation order differs.
    rebuild_margin: float = 0.0
    steps_per_scan: int = 10  # chunk length between host touchpoints
    n_pad: Optional[int] = None  # pad particle count to this (None: next mult of 256)


@dataclass(frozen=True)
class CaseConfig:
    """Full physics + run configuration (the ``.data`` tier,
    src/main.cpp:729-786, plus dimensionality and scenario)."""

    # Time stepping (src/main.cpp:743-747)
    dt: float = 1.0e-4
    elastic_dt: float = 1.0e-4
    output_interval: float = 1.0
    vtk_output_interval: float = 1.0e-2
    end_time: float = 1.0

    # Kernel support radii in units of particle spacing (src/main.cpp:748-751;
    # RadiusRatioG is aliased to RadiusRatioA at src/main.cpp:1193)
    radius_ratio_a: float = 2.5
    radius_ratio_p: float = 2.5
    radius_ratio_v: float = 2.5

    # Per-type property tables, width TYPE_COUNT (src/main.cpp:752-758).
    density: tuple[float, ...] = (1e3,) * TYPE_COUNT
    bulk_modulus: tuple[float, ...] = (1e4,) * TYPE_COUNT
    bulk_viscosity: tuple[float, ...] = (0.0,) * TYPE_COUNT
    shear_viscosity: tuple[float, ...] = (0.0,) * TYPE_COUNT
    surface_tension: tuple[float, ...] = (0.0,) * TYPE_COUNT
    young_modulus: tuple[float, ...] = (0.0,) * TYPE_COUNT
    poisson_ratio: tuple[float, ...] = (0.0,) * TYPE_COUNT
    interaction_ratio: tuple[tuple[float, ...], ...] = tuple(
        (1.0,) * TYPE_COUNT for _ in range(TYPE_COUNT)
    )
    gravity: tuple[float, float, float] = (0.0, 0.0, 0.0)
    walls: tuple[WallMotion, ...] = tuple(WallMotion() for _ in range(TYPE_COUNT))

    two_dimensional: bool = True  # TWO_DIMENSIONAL (src/main.cpp:50)
    scene: SceneConfig = field(default_factory=lambda: SCENES["none"])
    compat: CompatFlags = field(default_factory=CompatFlags)
    numerics: NumericsConfig = field(default_factory=NumericsConfig)

    @property
    def spatial_dim(self) -> int:
        return 2 if self.two_dimensional else 3

    @property
    def substeps(self) -> int:
        """Elastic substep count = round(Dt/ElasticDt) (src/main.cpp:653)."""
        return int(self.dt / self.elastic_dt + 0.5)

    def replace(self, **kw) -> "CaseConfig":
        return dataclasses.replace(self, **kw)


def bar_mode_shape(x: float, kl: float, length: float) -> float:
    """Euler-Bernoulli cantilever first-mode shape f(x) (src/main.cpp:387-392):
    (cos kL + cosh kL)(cosh kx - cos kx) + (sin kL - sinh kL)(sinh kx - sin kx)
    """
    k = kl / length
    kx = k * x
    term1 = (math.cos(kl) + math.cosh(kl)) * (math.cosh(kx) - math.cos(kx))
    term2 = (math.sin(kl) - math.sinh(kl)) * (math.sinh(kx) - math.sin(kx))
    return term1 + term2
