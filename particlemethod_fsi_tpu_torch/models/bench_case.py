"""The headline scene: coupled 2-D dam break on an elastic bar.

Counterpart of ``build_case`` in the repository's ``bench.py`` (the JAX
benchmark): the same primitives and property tables, built through this
package's generator and returned as a :class:`Simulation` of the port.  At
``n_side=1000`` the scene holds 1,012,666 particles (666 of them in the bar).
"""

from __future__ import annotations

from particlemethod_fsi_tpu_torch.config import SCENES, CaseConfig, NumericsConfig
from particlemethod_fsi_tpu_torch.generator import BoidScene, Primitive, generate_grid
from particlemethod_fsi_tpu_torch.solver import Simulation


def bench_grid(n_side: int):
    """Water column (s x s), elastic bar downstream, floor and two walls."""
    l0 = 1e-3
    s = n_side
    return generate_grid(BoidScene(
        particle_distance=l0,
        lower_domain=(-3 * l0, 0.0, 0.0),
        upper_domain=((2 * s + 6) * l0, 2 * s * l0, l0),
        primitives=[
            Primitive("Cuboid", spacing=l0, type=1, lower=(0, 3 * l0, 0),
                      upper=(s * l0, (3 + s) * l0, l0)),
            Primitive("Cuboid", spacing=l0, type=2,
                      lower=((s + 10) * l0, 3 * l0, 0),
                      upper=((s + 12) * l0, (3 + s // 3) * l0, l0)),
            Primitive("Cuboid", spacing=l0, type=4, lower=(-3 * l0, 0, 0),
                      upper=((2 * s + 3) * l0, 3 * l0, l0)),
            Primitive("Cuboid", spacing=l0, type=4, lower=(-3 * l0, 3 * l0, 0),
                      upper=(0, s * l0, l0)),
            Primitive("Cuboid", spacing=l0, type=4,
                      lower=((2 * s) * l0, 3 * l0, 0),
                      upper=((2 * s + 3) * l0, s * l0, l0)),
        ],
    ))


def bench_config(**numerics_kw) -> CaseConfig:
    """Physics tables of the bench scene; the field-major window sweep
    (``backend="pallas_t"``) with C8 margin 0.5 and cell capacity 12, as
    ``bench.py`` sets them, unless ``numerics_kw`` says otherwise: the
    row-major sweep ``backend="pallas"`` and the candidate engines
    ``"packed"`` and ``"gather"`` rebuild the frame every step, and only the
    candidate engines are held to the capacity (the scene's fullest cells
    hold 4 x 4 lattice sites at step 0, so capacity 12 drops pairs there:
    give them ``cell_capacity=16``)."""
    return CaseConfig(
        dt=1e-4, elastic_dt=1e-4,
        density=(1e3, 1e3, 1.1e3, 1e3, 1e3, 6e3),
        bulk_modulus=(1e4, 1e4, 1e4, 1e6, 1e4, 1e5),
        bulk_viscosity=(1e1, 1e-1, 1e-1, 1e3, 1e-1, 1e2),
        shear_viscosity=(1e-2, 1e-3, 1e-2, 1e-1, 1e3, 1e-1),
        young_modulus=(0.0, 0.0, 1e4, 1e5, 1e8, 1e4),
        poisson_ratio=(0.0, 0.0, 0.2, 0.4, 0.3, 0.3),
        gravity=(0.0, -9.81, 0.0),
        scene=SCENES["dam"],
        numerics=NumericsConfig(**{"backend": "pallas_t", "cell_capacity": 12,
                                   "rebuild_margin": 0.5, **numerics_kw}),
    )


def build_case(n_side: int, device=None, **numerics_kw) -> Simulation:
    """The bench scene as a ready :class:`Simulation`.  ``device=None`` puts
    it on the card (and raises without one); ``"cpu"`` selects the CPU.
    ``numerics_kw`` go to :class:`NumericsConfig`, ``backend`` among them."""
    return Simulation(bench_config(**numerics_kw), bench_grid(n_side),
                      device=device)
