"""PyTorch port vs JAX package: the scene modules, float64 on the CPU.

* ``walls.apply_wall_motion`` (the Rolling branch, the general branch with
  its freeze and without it) against the JAX function on the same seeded
  inputs: equal to the last bit (the same operations in the same order);
  ``walls.bar_initial_velocity`` within 1e-13 of the profile's peak (the
  hyperbolic and circular functions of the two libraries differ in the last
  bit, and the mode shape subtracts near-equal terms near the clamp);
* every builder of ``models/cases.py`` but ``reference_dam`` (which reads
  the reference's own files) against the JAX builder: grid arrays equal,
  config fields equal;
* the rocking tank stepping with walls that move, against JAX ``packed``
  (pos rtol 1e-12 / atol 1e-15, vel rtol 1e-9 / atol 1e-13: the bar the JAX
  package holds its backends to among themselves);
* the reference binary's goldens: the Rolling module after 100 steps (every
  row and the wall rows within 2e-5 m, the JAX test's bars), and the bar's
  tip, excited with the first-mode profile, within 1 % of the peak through
  step 100 (``tests/test_golden.py``'s bar and bars)."""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import port_cfg, port_grid
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)
from test_torch_golden import GOLD, REPO, load_golden, run_steps

from particlemethod_fsi_tpu import models as jmodels
from particlemethod_fsi_tpu.config import (
    SCENES,
    CaseConfig,
    NumericsConfig,
    RollingMotion,
    SceneConfig,
    WallMotion,
)
from particlemethod_fsi_tpu.ops import walls as jwl
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
from particlemethod_fsi_tpu_torch import models as pmodels
from particlemethod_fsi_tpu_torch.config import NumericsConfig as PortNumerics
from particlemethod_fsi_tpu_torch.generator import generate_case
from particlemethod_fsi_tpu_torch.ops import walls as pwl
from particlemethod_fsi_tpu_torch.solver import Simulation, load_case
from particlemethod_fsi_tpu_torch.state import to_numpy

F64 = torch.float64


def _motion_inputs(seed: int, n: int = 300):
    """Seeded positions, velocities and types (every type, pads too) and
    per-type wall centres."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.05, 0.05, size=(n, 3))
    vel = rng.normal(scale=0.1, size=(n, 3))
    prop = rng.integers(-1, 6, size=n).astype(np.int32)
    center = rng.uniform(-0.01, 0.01, size=(6, 3))
    return pos, vel, prop, center


def _walls():
    """Types 4 and 5 with a translation and an out-of-plane rotation."""
    walls = [WallMotion() for _ in range(6)]
    walls[4] = WallMotion(center=(0.01, 0.0, 0.0), velocity=(0.1, -0.05, 0.0),
                          omega=(0.0, 0.0, 3.0))
    walls[5] = WallMotion(center=(0.0, 0.02, 0.0), velocity=(0.0, 0.0, 0.2),
                          omega=(1.0, -2.0, 0.5))
    return tuple(walls)


# case: (scene, time, freeze)
MOTION = {
    "rolling": (SCENES["rolling"], 0.37, True),
    "rolling_long_period": (dataclasses.replace(
        SCENES["rolling"], rolling=RollingMotion(max_angle_deg=5.0,
                                                 period=0.3)), 0.05, True),
    "prescribed": (SCENES["dam"], 0.05, True),
    "prescribed_frozen": (SCENES["dam"], 0.3, True),
    "prescribed_no_freeze": (SCENES["dam"], 0.3, False),
}


@pytest.mark.parametrize("case", sorted(MOTION))
def test_apply_wall_motion_equals_jax(case):
    scene, t, freeze = MOTION[case]
    cfg = CaseConfig(dt=1e-4, walls=_walls(), scene=scene)
    pos, vel, prop, center = _motion_inputs(len(case))
    jtab = jwl.wall_tables(cfg, jnp.float64)
    want = jwl.apply_wall_motion(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(prop),
        jnp.asarray(center), jnp.asarray(t, jnp.float64),
        wall_velocity=jtab[1], wall_omega=jtab[2], wall_rotation=jtab[3],
        dt=cfg.dt, scene=scene, freeze=freeze)
    pcfg = port_cfg(cfg)
    ptab = pwl.wall_tables(pcfg, F64)
    for a, b in zip(ptab, jtab):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = pwl.apply_wall_motion(
        torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(prop),
        torch.as_tensor(center), torch.tensor(t, dtype=F64),
        wall_velocity=ptab[1], wall_omega=ptab[2], wall_rotation=ptab[3],
        dt=pcfg.dt, scene=pcfg.scene, freeze=freeze)
    for name, a, b in zip(("pos", "vel", "center"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    wall = (prop >= 4) & (prop < 6)
    moved = np.abs(got[0].numpy() - pos)
    frozen = case == "prescribed_frozen"
    assert (moved[~wall].max() == 0) and ((moved[wall].max() > 0) != frozen)
    np.testing.assert_array_equal(got[2].numpy(),
                                  center + np.asarray(ptab[1]) * cfg.dt)


@pytest.mark.parametrize("amplitude", [0.01, 0.003])
def test_bar_initial_velocity_equals_jax(amplitude):
    """Through ``Simulation.apply_initial_velocity_profile`` on both sides,
    with the profile's constants of a 2 cm bar."""
    jcfg, grid = jmodels.cantilever_bar(
        length_cells=20, numerics=NumericsConfig(dtype="float64",
                                                 backend="packed"))
    jcfg = jcfg.replace(scene=dataclasses.replace(jcfg.scene,
                                                  bar_amplitude=amplitude))
    rng = np.random.default_rng(5)
    grid.velocity[:] = rng.normal(scale=0.01, size=grid.velocity.shape)
    jsim = JaxSimulation(jcfg, grid)
    want = jax_to_numpy(jsim.apply_initial_velocity_profile(jsim.state0))
    pcfg = port_cfg(jcfg.replace(numerics=NumericsConfig(dtype="float64")))
    psim = Simulation(pcfg, port_grid(grid), device="cpu")
    got = to_numpy(psim.apply_initial_velocity_profile(psim.state0))
    peak = float(np.abs(want["vel"]).max())
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=1e-13,
                               atol=1e-13 * peak)
    s = (got["prop"] >= 2) & (got["prop"] < 4)
    assert float(np.abs(got["vel"][s, 1]).max()) > 0
    # a scene without the profile keeps the state as it is
    plain = Simulation(pcfg.replace(scene=psim.cfg.scene.__class__()),
                       port_grid(grid), device="cpu")
    assert plain.apply_initial_velocity_profile(plain.state0) is plain.state0


@pytest.mark.parametrize("omega, velocity, planar", [
    ((0.0, 0.0, 2.0), (0.1, 0.0, 0.0), True),
    ((0.5, 0.0, 2.0), (0.1, 0.0, 0.0), False),
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.1), False),
])
def test_is_planar_follows_wall_motion(omega, velocity, planar):
    """In-plane wall motion (a rotation about z, a velocity in x-y) keeps a
    2-D case planar, as in the JAX package; motion out of the plane does
    not."""
    cfg, grid = jmodels.dam_break(n_side=6, numerics=NumericsConfig(
        dtype="float64", backend="packed"))
    walls = list(cfg.walls)
    walls[4] = WallMotion(velocity=velocity, omega=omega)
    cfg = cfg.replace(walls=tuple(walls))
    jsim = JaxSimulation(cfg, grid)
    psim = Simulation(port_cfg(cfg.replace(numerics=NumericsConfig(
        dtype="float64"))), port_grid(grid), device="cpu")
    assert psim._pcfg.planar == jsim._pcfg.planar == planar
    assert not psim._walls_static


BUILDERS = {
    "dam_break": dict(n_side=12),
    "dam_break_on_elastic_gate": dict(n_side=12, gate_young=2e5),
    "cantilever_bar": dict(length_cells=24, thickness_cells=3, excite=True),
    "turek_hron_channel": dict(ny=9, spacing=0.05),
    "rolling_tank": dict(n_side=14),
    "hydroelastic_slab": dict(length_cells=20),
    "dam_break_3d": dict(n_side=6),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_equals_jax(name):
    kw = BUILDERS[name]
    numerics = NumericsConfig(dtype="float64", rebuild_margin=0.5)
    jcfg, jgrid = getattr(jmodels, name)(**kw, numerics=numerics)
    pcfg, pgrid = getattr(pmodels, name)(
        **kw, numerics=PortNumerics(dtype="float64", rebuild_margin=0.5))
    assert pcfg == port_cfg(jcfg)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    for f in dataclasses.fields(jgrid):
        a, b = getattr(pgrid, f.name), getattr(jgrid, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    # the default numerics too
    assert pmodels.dam_break(n_side=4)[0] == port_cfg(jmodels.dam_break(
        n_side=4)[0])


def test_rolling_tank_walls_move_and_match_jax():
    """The rocking tank (Rolling: harmonic rotation about the wall centre),
    five steps on the port's field-major backend against JAX ``packed``;
    the walls moved, as ``tests/test_models.py`` asks of the JAX package."""
    jcfg, grid = jmodels.rolling_tank(n_side=14, numerics=NumericsConfig(
        dtype="float64", backend="packed", cell_capacity=12))
    jsim = JaxSimulation(jcfg, grid)
    pcfg = port_cfg(jcfg.replace(numerics=NumericsConfig(
        dtype="float64", backend="pallas_t", pallas_block=32)))
    psim = Simulation(pcfg, port_grid(grid), device="cpu")
    assert not psim._walls_static and psim._pcfg.planar
    js, ps = jsim.state0, psim.state0
    for _ in range(5):
        js, ps = jsim.step(js), psim.step(ps)
    want, got = jax_to_numpy(js, grid.n), to_numpy(ps, grid.n)
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=1e-9, atol=1e-13)
    np.testing.assert_array_equal(got["wall_center"], want["wall_center"])
    wall = (grid.prop >= 4) & (grid.prop < 6)
    assert np.abs(got["pos"][wall] - grid.position[wall]).max() > 0
    assert np.abs(got["vel"][wall]).max() > 0
    assert np.isfinite(got["pos"]).all() and np.isfinite(got["vel"]).all()


def test_rolling_golden_100_steps(tmp_path):
    """The Rolling module (rocking walls, the theta = |omega|^2 quirk, the
    sloshing fluid and a clamped post) against the reference binary after
    100 steps."""
    sim, out = run_steps(tmp_path, "rolling", "rolling", "rolling", 100,
                         scene="rolling")
    assert sim.cfg.scene.rolling is not None and not sim._walls_static
    t, g = load_golden(os.path.join(GOLD, "rolling", "rolling0100.prof.gz"))
    assert t == pytest.approx(0.01) and out["time"] == pytest.approx(0.01)
    np.testing.assert_array_equal(out["prop"], g[:, 0].astype(np.int32))
    dp = np.abs(out["pos"][:, :2] - g[:, 1:3]).max()
    assert dp < 2.0e-5, f"position diff {dp:.3e} m vs golden"
    wall = g[:, 0].astype(int) == 4
    dw = np.abs(out["pos"][wall, :2] - g[wall, 1:3]).max()
    assert dw < 2.0e-5, f"wall position diff {dw:.3e} m vs golden"
    # the walls did rock
    assert np.abs(out["vel"][wall]).max() > 0


def test_bar_tip_within_one_percent_through_step_100(tmp_path):
    """The bar's first-mode excitation (``--apply-velocity-profile``) and
    its tip displacement against the reference binary's trajectory at its
    first six samples (steps 0, 20, ..., 100)."""
    os.symlink(os.path.join(REPO, "cases", "bar", "bar.boid"),
               tmp_path / "bar.boid")
    generate_case(str(tmp_path / "bar"))
    cfg, grid = load_case(
        os.path.join(GOLD, "bar", "bar.data"), tmp_path / "bar.grid",
        scene="bar", numerics=PortNumerics(dtype="float64", backend="pallas_t",
                                           pallas_block=32))
    sim = Simulation(cfg, grid, device="cpu")
    st = sim.apply_initial_velocity_profile(sim.state0)
    x0 = np.asarray(grid.initial_position)
    tip = int(np.argmax(x0[:, 0]))
    gold = np.genfromtxt(os.path.join(GOLD, "bar", "tip_trajectory.csv"),
                         delimiter=",", names=True)
    step, errs = 0, []
    for t_g, uy_g in zip(gold["time"][:6], gold["uy"][:6]):
        target = int(round(t_g / cfg.dt))
        st = sim.run_chunk(st, target - step)
        step = target
        out = to_numpy(st, sim.n)
        errs.append(abs((out["pos"][tip, 1] - x0[tip, 1]) - uy_g))
    assert step == 100
    peak = np.abs(gold["uy"]).max()
    assert max(errs) < 0.01 * peak, (
        f"tip error {max(errs):.3e} m vs 1% of peak {peak:.3e} m")
    assert math.isfinite(float(out["pos"][tip, 1]))
