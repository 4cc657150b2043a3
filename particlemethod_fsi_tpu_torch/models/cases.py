"""Scenario model builders.

Counterpart of ``particlemethod_fsi_tpu/models/cases.py``: the same
builders with the same geometry, tables and scenes, built through this
package's generator, so that each returns the JAX builder's grid (arrays
equal) and config (fields equal) as this package's ``(CaseConfig,
GridData)``, ready for :class:`~particlemethod_fsi_tpu_torch.solver.Simulation`.

The reference selects scenarios with compile-time ``#define`` modules and
ships exactly one runnable case (``results/Dam``); the Bar/Turek/Rolling/
Hydroelastic modules exist there only as code paths with no inputs.  Here
every scenario family is a parameterized builder producing a complete
runnable case.  Default physics tables mirror ``results/Dam/dam.data``
values where the reference defines them; scene-specific values are
documented per builder.
"""

from __future__ import annotations

import numpy as np

from particlemethod_fsi_tpu_torch.config import (
    SCENES,
    CaseConfig,
    NumericsConfig,
    SceneConfig,
    WallMotion,
)
from particlemethod_fsi_tpu_torch.generator import BoidScene, Primitive, generate_grid
from particlemethod_fsi_tpu_torch.io.grid_file import GridData

# per-type tables from results/Dam/dam.data (types: 0-1 fluid, 2-3 solid,
# 4-5 wall)
DAM_TABLES = dict(
    density=(1e3, 1e3, 1.1e3, 1e3, 1e3, 6e3),
    bulk_modulus=(1e4, 1e4, 1e4, 1e6, 1e4, 1e5),
    bulk_viscosity=(1e1, 1e-1, 1e-1, 1e3, 1e-1, 1e2),
    shear_viscosity=(1e-2, 1e-3, 1e-2, 1e-1, 1e3, 1e-1),
    surface_tension=(0.0,) * 6,
    young_modulus=(0.0, 0.0, 1e5, 1e5, 1e8, 1e4),
    poisson_ratio=(0.0, 0.0, 0.2, 0.4, 0.3, 0.3),
)


def _cfg(scene: SceneConfig, *, dt=1e-4, elastic_dt=1e-4, gravity=(0.0, -9.81, 0.0),
         two_dimensional=True, numerics=None, **table_overrides) -> CaseConfig:
    tables = dict(DAM_TABLES)
    tables.update(table_overrides)
    return CaseConfig(
        dt=dt, elastic_dt=elastic_dt, gravity=gravity, scene=scene,
        two_dimensional=two_dimensional,
        numerics=numerics or NumericsConfig(),
        **tables,
    )


def reference_dam(results_dir):
    """The shipped reference Dam case, loaded via the interop readers from
    ``results_dir``, the reference's ``results/Dam`` directory (the JAX
    builder has a fixed default; here the caller names it)."""
    from particlemethod_fsi_tpu_torch.solver import load_case

    return load_case(f"{results_dir}/dam.data", f"{results_dir}/dam.grid",
                     scene="dam")


def dam_break(n_side: int = 100, *, spacing: float = 1e-3, numerics=None):
    """2-D dam break: water column collapsing in a walled basin (the
    reference's Dam geometry scaled by ``n_side``)."""
    l0 = spacing
    s = n_side
    grid = generate_grid(BoidScene(
        particle_distance=l0,
        lower_domain=(-3 * l0, 0.0, 0.0),
        upper_domain=((2 * s + 6) * l0, 2 * s * l0, l0),
        primitives=[
            Primitive("Cuboid", spacing=l0, type=1, lower=(0, 3 * l0, 0),
                      upper=(s * l0, (3 + s) * l0, l0)),
            Primitive("Cuboid", spacing=l0, type=4, lower=(-3 * l0, 0, 0),
                      upper=((2 * s + 3) * l0, 3 * l0, l0)),
            Primitive("Cuboid", spacing=l0, type=4, lower=(-3 * l0, 3 * l0, 0),
                      upper=(0, s * l0, l0)),
            Primitive("Cuboid", spacing=l0, type=4,
                      lower=((2 * s) * l0, 3 * l0, 0),
                      upper=((2 * s + 3) * l0, s * l0, l0)),
        ],
    ))
    return _cfg(SCENES["dam"], numerics=numerics), grid


def dam_break_on_elastic_gate(n_side: int = 100, *, spacing: float = 1e-3,
                              gate_young: float = 1e5, numerics=None):
    """Coupled FSI flagship: dam break impacting a clamped elastic gate."""
    l0 = spacing
    s = n_side
    cfg, base = dam_break(n_side, spacing=spacing, numerics=numerics)
    gate = generate_grid(BoidScene(
        particle_distance=l0,
        lower_domain=tuple(base.domain_min),
        upper_domain=tuple(base.domain_max),
        primitives=[
            Primitive("Cuboid", spacing=l0, type=2,
                      lower=((s + 10) * l0, 3 * l0, 0),
                      upper=((s + 12) * l0, (3 + s // 3) * l0, l0)),
        ],
    ))
    grid = GridData(
        time=0.0, spacing=l0,
        domain_min=base.domain_min, domain_max=base.domain_max,
        prop=np.concatenate([base.prop, gate.prop]),
        position=np.concatenate([base.position, gate.position]),
        initial_position=np.concatenate([base.initial_position,
                                         gate.initial_position]),
        velocity=np.concatenate([base.velocity, gate.velocity]),
    )
    ym = list(DAM_TABLES["young_modulus"])
    ym[2] = gate_young
    return cfg.replace(young_modulus=tuple(ym)), grid


def cantilever_bar(length_cells: int = 200, thickness_cells: int = 4, *,
                   spacing: float = 1e-3, young: float = 1e5,
                   density: float = 1.1e3, excite: bool = True,
                   numerics=None):
    """Structure-only cantilever bar (the reference's Bar module,
    src/main.cpp:54, 395-417, 1918-1943): clamped at x0 < spacing, optionally
    excited with the first-bending-mode velocity profile.

    Oracle: Euler-Bernoulli first-mode frequency
    f1 = (kL)^2 / (2 pi L^2) sqrt(E I / (rho A)), kL = 1.875.
    """
    l0 = spacing
    lx, ly = length_cells, thickness_cells
    grid = generate_grid(BoidScene(
        particle_distance=l0,
        lower_domain=(-5 * l0, -20 * ly * l0, 0.0),
        upper_domain=((lx + 20) * l0, 20 * ly * l0, l0),
        primitives=[
            Primitive("Cuboid", spacing=l0, type=2,
                      lower=(0.0, -ly / 2 * l0, 0.0),
                      upper=(lx * l0, ly / 2 * l0, l0)),
        ],
    ))
    scene = SceneConfig(
        name="bar", clamp_axis=0, clamp_threshold=l0,
        velocity_profile="bar_first_mode" if excite else None,
        bar_length=lx * l0,
    )
    dens = list(DAM_TABLES["density"]); dens[2] = density
    ym = list(DAM_TABLES["young_modulus"]); ym[2] = young
    cfg = _cfg(scene, gravity=(0.0, 0.0, 0.0), numerics=numerics,
               density=tuple(dens), young_modulus=tuple(ym))
    return cfg, grid


def turek_hron_channel(ny: int = 41, *, spacing: float = 1e-2, numerics=None):
    """Turek-Hron-style channel: parabolic inlet re-imposed every step on a
    channel flow past a clamped elastic flag (src/main.cpp:419-441,
    1944-1965).  Channel height 0.41 m at the reference's geometry scale."""
    l0 = spacing
    h_cells = ny
    len_cells = int(2.2 / l0 / (0.41 / (ny * l0)))  # keep aspect ~2.2/0.41
    grid = generate_grid(BoidScene(
        particle_distance=l0,
        lower_domain=(0.0, -3 * l0, 0.0),
        upper_domain=(len_cells * l0, (h_cells + 3) * l0, l0),
        primitives=[
            # fluid fill
            Primitive("Cuboid", spacing=l0, type=0, lower=(0, 0, 0),
                      upper=(len_cells * l0, h_cells * l0, l0)),
            # channel walls
            Primitive("Cuboid", spacing=l0, type=4, lower=(0, -3 * l0, 0),
                      upper=(len_cells * l0, 0, l0)),
            Primitive("Cuboid", spacing=l0, type=4,
                      lower=(0, h_cells * l0, 0),
                      upper=(len_cells * l0, (h_cells + 3) * l0, l0)),
            # elastic flag behind a rigid nose
            Primitive("Cuboid", spacing=l0, type=2,
                      lower=(0.2, (h_cells // 2 - 1) * l0, 0),
                      upper=(0.2 + 0.35, (h_cells // 2 + 1) * l0, l0)),
        ],
    ))
    scene = SCENES["turek_hron"].__class__(
        **{**SCENES["turek_hron"].__dict__, "turek_ymax": h_cells * l0}
    )
    return _cfg(scene, gravity=(0.0, 0.0, 0.0), numerics=numerics), grid


def rolling_tank(n_side: int = 60, *, spacing: float = 1e-3, numerics=None):
    """Partially filled tank with harmonically rocking walls (the
    reference's Rolling module, src/main.cpp:2958-3029)."""
    l0 = spacing
    s = n_side
    grid = generate_grid(BoidScene(
        particle_distance=l0,
        lower_domain=(-3 * l0, -3 * l0, 0.0),
        upper_domain=((s + 3) * l0, s * l0, l0),
        primitives=[
            Primitive("Cuboid", spacing=l0, type=1, lower=(0, 0, 0),
                      upper=(s * l0, s // 2 * l0, l0)),
            Primitive("Cuboid", spacing=l0, type=4, lower=(-3 * l0, -3 * l0, 0),
                      upper=((s + 3) * l0, 0, l0)),
            Primitive("Cuboid", spacing=l0, type=4, lower=(-3 * l0, 0, 0),
                      upper=(0, s * l0 * 0.9, l0)),
            Primitive("Cuboid", spacing=l0, type=4, lower=(s * l0, 0, 0),
                      upper=((s + 3) * l0, s * l0 * 0.9, l0)),
        ],
    ))
    walls = list(WallMotion() for _ in range(6))
    walls[4] = WallMotion(center=(s * l0 / 2, 0.0, 0.0))
    cfg = _cfg(SCENES["rolling"], numerics=numerics).replace(walls=tuple(walls))
    return cfg, grid


def hydroelastic_slab(length_cells: int = 200, *, spacing: float = 1e-2,
                      numerics=None):
    """Water resting on an elastic slab clamped at both ends (the
    reference's Hydroelastic module clamp x0<0.01 | x0>1.99,
    src/main.cpp:2019-2032)."""
    l0 = spacing
    lx = length_cells
    grid = generate_grid(BoidScene(
        particle_distance=l0,
        lower_domain=(0.0, -10 * l0, 0.0),
        upper_domain=(lx * l0, 40 * l0, l0),
        primitives=[
            Primitive("Cuboid", spacing=l0, type=2, lower=(0, -4 * l0, 0),
                      upper=(lx * l0, 0, l0)),
            Primitive("Cuboid", spacing=l0, type=1, lower=(0, 0, 0),
                      upper=(lx * l0, 20 * l0, l0)),
        ],
    ))
    scene = SceneConfig(
        name="hydroelastic", clamp_axis=0, clamp_threshold=l0,
        clamp2_threshold=(lx - 1) * l0, clamp2_greater=True,
    )
    return _cfg(scene, numerics=numerics), grid


def dam_break_3d(n_side: int = 40, *, spacing: float = 1e-3, numerics=None):
    """3-D dam break in a walled box (the reference is compiled 2-D for the
    shipped case but supports 3-D via the TWO_DIMENSIONAL switch;
    src/main.cpp:50)."""
    l0 = spacing
    s = n_side
    grid = generate_grid(BoidScene(
        particle_distance=l0,
        lower_domain=(-3 * l0, 0.0, -3 * l0),
        upper_domain=((2 * s + 6) * l0, 2 * s * l0, (s + 6) * l0),
        primitives=[
            Primitive("Cuboid", spacing=l0, type=1, lower=(0, 3 * l0, 0),
                      upper=(s * l0, (3 + s) * l0, s * l0)),
            # floor
            Primitive("Cuboid", spacing=l0, type=4, lower=(-3 * l0, 0, -3 * l0),
                      upper=((2 * s + 3) * l0, 3 * l0, (s + 3) * l0)),
            # x walls
            Primitive("Cuboid", spacing=l0, type=4,
                      lower=(-3 * l0, 3 * l0, -3 * l0),
                      upper=(0, s * l0, (s + 3) * l0)),
            Primitive("Cuboid", spacing=l0, type=4,
                      lower=((2 * s) * l0, 3 * l0, -3 * l0),
                      upper=((2 * s + 3) * l0, s * l0, (s + 3) * l0)),
            # z walls
            Primitive("Cuboid", spacing=l0, type=4,
                      lower=(0, 3 * l0, -3 * l0),
                      upper=((2 * s) * l0, s * l0, 0)),
            Primitive("Cuboid", spacing=l0, type=4,
                      lower=(0, 3 * l0, s * l0),
                      upper=((2 * s) * l0, s * l0, (s + 3) * l0)),
        ],
    ))
    return _cfg(SCENES["dam"], two_dimensional=False, numerics=numerics), grid
