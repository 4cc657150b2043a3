"""PyTorch port vs JAX package: periodic ghost rows, the Turek inlet and the
Turek-Hron channel, float64 on the CPU.

* ``ops/ghosts.py`` against the JAX ``ops/ghosts.py`` on seeded 2-D and 3-D
  inputs: the plan's fields equal, the extended arrays equal exactly.
* Whole runs against the JAX ``packed`` engine, which always takes the
  minimum image (the oracle of the JAX package's own ghost tests,
  ``tests/test_backends.py``), at the bar those tests use between backends:
  pos rtol 1e-12 / atol 1e-15, vel rtol 1e-9 / atol 1e-13 (only the order
  of the pair sums differs).  Port side: ``pallas_t`` and ``pallas``, block
  32.
* The Turek inlet against the JAX function; ``models/turek.py`` against the
  grid ``cases/turek/generate.py`` writes; the Turek channel (44,000
  particles) against the reference binary's golden after 20 steps at the
  bars of ``tests/test_golden.py`` (structure 5e-6 m, fluid 2e-4 m, the
  minimum image on the periodic x axis)."""

import dataclasses
import gzip
import itertools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cases import dam_like_config
from test_torch_common import port_cfg, port_grid
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.config import SCENES as JAX_SCENES
from particlemethod_fsi_tpu.config import NumericsConfig as JaxNumerics
from particlemethod_fsi_tpu.generator import BoidScene, Primitive, generate_grid
from particlemethod_fsi_tpu.ops import ghosts as jgh
from particlemethod_fsi_tpu.ops import walls as jwl
from particlemethod_fsi_tpu.ops.neighbors import build_cell_grid as jax_cell_grid
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu.solver import load_case as jax_load_case
from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
from particlemethod_fsi_tpu_torch.config import SCENES, NumericsConfig
from particlemethod_fsi_tpu_torch.io.grid_file import write_grid_file
from particlemethod_fsi_tpu_torch.models import turek_config, turek_grid
from particlemethod_fsi_tpu_torch.ops import ghosts as gh
from particlemethod_fsi_tpu_torch.ops import walls as wl
from particlemethod_fsi_tpu_torch.ops.neighbors import build_cell_grid
from particlemethod_fsi_tpu_torch.solver import Simulation, load_case
from particlemethod_fsi_tpu_torch.state import to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS = dict(rtol=1e-12, atol=1e-15)
VEL = dict(rtol=1e-9, atol=1e-13)


# ---------------------------------------------------------------------------
# ops/ghosts.py against the JAX functions
# ---------------------------------------------------------------------------


def _ghost_inputs(case: int):
    """Seeded positions in a 2-D or 3-D domain, crowded against the
    boundaries so that every axis with room wraps; a fifth of the rows are
    padding (prop -1)."""
    rng = np.random.default_rng(40 + case)
    two_d = case < 2
    dmin = np.array([0.0, -1e-3, 0.0])
    dmax = np.array([0.02, 0.015, 1e-3 if two_d else 0.012])
    support = 3.5e-3
    n = 256
    u = rng.random((n, 3))
    # half the rows near the two ends of each axis
    u = np.where(rng.random((n, 3)) < 0.5, u ** 3, 1 - u ** 3)
    pos = dmin + u * (dmax - dmin)
    if two_d:
        pos[:, 2] = 0.5e-3
    prop = rng.integers(0, 6, size=n).astype(np.int32)
    prop[rng.random(n) < 0.2] = -1
    pos[prop < 0] = 0.0
    vel = rng.normal(scale=0.1, size=(n, 3))
    return dmin, dmax, support, two_d, pos, vel, prop


def _grids(dmin, dmax, support, two_d):
    return (jax_cell_grid(dmin, dmax, support, two_dimensional=two_d),
            build_cell_grid(dmin, dmax, support, two_dimensional=two_d))


def _same_spec(jspec, pspec):
    assert dataclasses.asdict(jspec.grid) == dataclasses.asdict(pspec.grid)
    assert jspec.shifts == pspec.shifts
    assert jspec.caps == pspec.caps
    assert jspec.support == pspec.support
    assert jspec.total_capacity == pspec.total_capacity


@pytest.mark.parametrize("case", range(4))
def test_spec_and_extension_equal_jax(case):
    dmin, dmax, support, two_d, pos, vel, prop = _ghost_inputs(case)
    jgrid, pgrid = _grids(dmin, dmax, support, two_d)
    valid = prop >= 0
    axes = gh.wrapped_axes(pgrid, pos, valid, support, two_d)
    assert axes == jgh.wrapped_axes(jgrid, pos, valid, support, two_d)
    assert axes == ((True, True, False) if two_d else (True, True, True))
    if case % 2:  # one axis only: the plan covers what it is given
        axes = (True, False, False)
    jspec = jgh.build_ghost_spec(jgrid, axes, pos, valid, support)
    pspec = gh.build_ghost_spec(pgrid, axes, pos, valid, support)
    _same_spec(jspec, pspec)
    assert gh.spec_axes(pspec) == jgh.spec_axes(jspec) == axes
    assert pspec.total_capacity % 256 == 0

    # the extension, with the plan as built and with every cap cut to 16
    # rows (so that strips overflow), in float64 and in float32 (the strips'
    # bounds and the shifts rounded as the JAX package's arrays round them)
    small = pspec._replace(caps=(16,) * len(pspec.caps))
    for (js, ps), dtype in itertools.product(
            ((jspec, pspec), (jspec._replace(caps=small.caps), small)),
            (np.float64, np.float32)):
        p, v = pos.astype(dtype), vel.astype(dtype)
        want = jgh.extend_with_ghosts(js, jgrid, jnp.asarray(p),
                                      jnp.asarray(v), jnp.asarray(prop),
                                      pos.shape[0])
        got = gh.extend_with_ghosts(ps, pgrid, torch.as_tensor(p),
                                    torch.as_tensor(v),
                                    torch.as_tensor(prop))
        assert got[0].dtype == torch.as_tensor(p).dtype
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (int(got[4]) > 0) == (ps is small)
        # the device-side strip counts are the host test's
        counts = gh.strip_counts(ps, pgrid, torch.as_tensor(pos),
                                 torch.as_tensor(valid)).tolist()
        assert gh.stale_from_counts(ps, axes, counts) == gh.spec_is_stale(
            ps, pgrid, pos, valid, support, axes)


@pytest.mark.parametrize("case", range(4))
def test_spec_is_stale_equals_jax(case):
    dmin, dmax, support, two_d, pos, vel, prop = _ghost_inputs(case)
    jgrid, pgrid = _grids(dmin, dmax, support, two_d)
    valid = prop >= 0
    axes_all = gh.wrapped_axes(pgrid, pos, valid, support, two_d)
    # the plan of the x axis alone, of every axis, and no plan
    x_only = (True, False, False)
    plans = [(gh.build_ghost_spec(pgrid, x_only, pos, valid, support),
              jgh.build_ghost_spec(jgrid, x_only, pos, valid, support)),
             (gh.build_ghost_spec(pgrid, axes_all, pos, valid, support),
              jgh.build_ghost_spec(jgrid, axes_all, pos, valid, support)),
             (None, None)]
    # the distribution as planned, with strips grown past the headroom, and
    # with every valid row inside (nothing wraps)
    grown = pos.copy()
    grown[valid, :2] = dmax[:2] - (dmax[:2] - grown[valid, :2]) * 0.05
    inside = pos.copy()
    inside[valid] = 0.5 * (dmin + dmax)
    stale = []
    for p in (pos, grown, inside):
        now = gh.wrapped_axes(pgrid, p, valid, support, two_d)
        for pspec, jspec in plans:
            got = gh.spec_is_stale(pspec, pgrid, p, valid, support, now)
            assert got == jgh.spec_is_stale(jspec, jgrid, p, valid, support,
                                            now)
            stale.append(got)
    # fresh as planned (all axes), stale where a wrapping axis is not
    # covered or a strip has grown, never stale where nothing wraps and no
    # plan exists
    assert stale[1] is False and stale[0] is True and stale[2] is True
    assert stale[4] is True and stale[6] is False and stale[8] is False


# ---------------------------------------------------------------------------
# whole runs against the JAX packed engine
# ---------------------------------------------------------------------------


def _block_grid(seed=None, vx=None):
    """The fully periodic 12 x 12 fluid block of ``tests/test_backends.py``
    (1 mm lattice filling a 12 mm square)."""
    n_side = 12
    grid = generate_grid(BoidScene(
        particle_distance=1e-3, lower_domain=(0.0, 0.0, 0.0),
        upper_domain=(n_side * 1e-3, n_side * 1e-3, 1e-3),
        primitives=[Primitive("Cuboid", spacing=1e-3, type=0,
                              lower=(0, 0, 0),
                              upper=(n_side * 1e-3, n_side * 1e-3, 1e-3))]))
    if seed is not None:
        rng = np.random.default_rng(seed)
        grid.velocity[:, :2] = rng.normal(scale=0.05, size=(grid.n, 2))
    if vx is not None:
        grid.velocity[:, 0] = vx
    return grid


def _packed(grid, base, steps, state=None):
    """JAX ``packed`` after ``steps`` single steps (from ``state``, a dict
    of numpy arrays, if given)."""
    jsim = JaxSimulation(dam_like_config(backend="packed").replace(**base),
                         grid)
    s = jsim.state0
    if state is not None:
        s = s.replace(pos=jnp.asarray(state["pos"]),
                      vel=jnp.asarray(state["vel"]),
                      time=jnp.asarray(state["time"]))
    for _ in range(steps):
        s = jsim.step(s)
    return jax_to_numpy(s, grid.n)


def _port(grid, base, **numerics):
    cfg = dam_like_config(pallas_block=32, pallas_wmax=128,
                          **numerics).replace(**base)
    return Simulation(port_cfg(cfg), port_grid(grid), device="cpu")


def _agree(got, want):
    np.testing.assert_allclose(got["pos"], want["pos"], **POS)
    np.testing.assert_allclose(got["vel"], want["vel"], **VEL)


_ST = dict(gravity=(0.0, 0.0, 0.0),
           surface_tension=(0.01, 0.01, 0.0, 0.0, 0.01, 0.0))


@pytest.mark.parametrize("backend", ["pallas_t", "pallas"])
def test_periodic_block_matches_jax_packed(backend):
    """``tests/test_backends.py::test_pallas_t_periodic_ghosts``: ten steps
    of the fully periodic block on a ghost-extended frame (with surface
    tension, so pressure A and the gravity centre ride to the ghost rows
    too), then the diagnostics on that frame."""
    grid = _block_grid(seed=3)
    want = _packed(grid, _ST, 10)
    sim = _port(grid, _ST, backend=backend)
    assert sim._backend == backend
    assert sim._ghosts is not None and sim._ghosts.total_capacity % 256 == 0
    assert gh.spec_axes(sim._ghosts) == (True, True, False)
    s = sim.state0
    for _ in range(10):
        s = sim.step(s)
    _agree(to_numpy(s, grid.n), want)
    d = sim.diagnostics(s)
    assert d["force"].shape == (sim.n_pad, 3)
    assert int(d["neighbor_count"].max()) >= 8
    assert np.isfinite(d["virial_pressure"]).all()
    assert int(d["ghost_overflow"]) == 0 and sim.ghost_refreshes == 0


def test_c8_reuse_with_ghosts_matches():
    """``test_rebuild_margin_c8_matches_periodic_ghosts``: the cached path
    keeps the ghost payloads current and reproduces both the packed engine
    and the rebuild-every-step ``pallas_t`` run across the boundary."""
    grid = _block_grid(seed=7)
    want = _packed(grid, _ST, 12)
    sim0 = _port(grid, _ST, backend="pallas_t")
    sim1 = _port(grid, _ST, backend="pallas_t", rebuild_margin=1.0)
    assert not sim0._margin_cached
    assert sim1._margin_cached and sim1._ghosts is not None
    # the margin-deepened strips cover the support + margin reach
    assert sim1._ghosts.support > sim0._ghosts.support
    b = to_numpy(sim0.run_chunk(sim0.state0, 12), grid.n)
    c = to_numpy(sim1.run_chunk(sim1.state0, 12), grid.n)
    _agree(b, want)
    _agree(c, b)
    assert 1 <= sim1.rebuilds < 12


def test_ghost_overflow_carried_out_of_the_chunk():
    """``test_ghost_overflow_carried_out_of_scan``: two image strips
    sabotaged down by 128 rows overflow every step; the count survives to
    the chunk boundary in ``state.ghost_overflow``, a forced refresh
    resizes the plan, and the next chunk from there agrees with JAX
    ``packed`` again with no overflow."""
    grid = _block_grid(seed=7)
    base = dict(gravity=(0.0, 0.0, 0.0))
    sim = _port(grid, base, backend="pallas_t")
    spec = sim._ghosts
    caps = list(spec.caps)
    big = sorted(range(len(caps)), key=lambda i: -caps[i])[:2]
    assert caps[big[0]] >= 128 and caps[big[1]] >= 128
    caps[big[0]] -= 128
    caps[big[1]] -= 128
    sim._ghosts = spec._replace(caps=tuple(caps))
    s = sim.run_chunk(sim.state0, 5)
    assert int(s.ghost_overflow) > 0, "overflow did not survive the chunk"
    # the plan looks fresh by the occupancy test with its sabotaged caps
    # only where forced
    assert sim.refresh_ghosts(s, force=True)
    assert all(c >= 128 for c in sim._ghosts.caps)
    assert sim._ghosts.caps == gh.build_ghost_spec(
        sim.cell_grid, (True, True, False), s.pos.numpy(),
        (s.prop >= 0).numpy(), sim._frame_support).caps
    s = s.replace(ghost_overflow=torch.zeros_like(s.ghost_overflow))
    here = to_numpy(s)
    s = sim.run_chunk(s, 5)
    assert int(s.ghost_overflow) == 0
    _agree(to_numpy(s, grid.n), _packed(grid, base, 5, here))


def test_c8_skip_survives_boundary_crossings():
    """``test_c8_skip_survives_boundary_crossings``: uniform advection at
    0.3 spacings a step wraps the boundary column every ~4 steps, with zero
    relative displacement; the min-imaged predicate rebuilds exactly once
    in 16 steps, and the run agrees with the min-imaging packed engine."""
    cfg1 = dam_like_config(rebuild_margin=1.0)
    vx = 0.3 * 1e-3 / cfg1.dt
    grid = _block_grid(vx=vx)
    base = dict(gravity=(0.0, 0.0, 0.0))
    want = _packed(grid, base, 16)
    sim = _port(grid, base, backend="pallas_t", rebuild_margin=1.0)
    assert sim._margin_cached and sim._ghosts is not None
    state, cache = sim.state0, sim._init_cache(sim.state0)
    with torch.no_grad():
        for _ in range(16):
            state, cache = sim._step_core(state, cache)
    assert cache["rebuilds"] == 1, (
        f"crossings tripped {cache['rebuilds']} rebuilds")
    got = to_numpy(state, grid.n)
    # the state stays wrapped up to one step's drift (the wrap runs at the
    # step's start, before the forces, as in the packed engine)
    assert float(np.max(got["pos"][:, 0])) < sim.domain_max[0] + vx * cfg1.dt
    _agree(got, want)


# ---------------------------------------------------------------------------
# the Turek inlet, the channel's grid and its golden
# ---------------------------------------------------------------------------


def test_turek_inlet_velocity_equals_jax():
    rng = np.random.default_rng(11)
    n = 512
    pos = np.column_stack([rng.choice([0.005, 0.01, 0.0101, 1.2, 1.5, 1.51,
                                       2.4], n),
                           rng.uniform(-0.01, 0.42, n), np.zeros(n)])
    vel = rng.normal(size=(n, 3))
    prop = rng.integers(-1, 6, n).astype(np.int32)
    scene = SCENES["turek_hron"]
    jscene = JAX_SCENES["turek_hron"]
    hit = 0
    for t in (0.0, 0.69, 0.7, 1.0):
        want = np.asarray(jwl.turek_inlet_velocity(
            jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(prop),
            jnp.asarray(t), jscene))
        got = wl.turek_inlet_velocity(
            torch.as_tensor(pos), torch.as_tensor(vel),
            torch.as_tensor(prop), torch.tensor(t, dtype=torch.float64),
            scene).numpy()
        np.testing.assert_array_equal(got, want)
        hit += int((got != vel).any(axis=1).sum())
    assert hit > 0


def test_turek_grid_equals_the_case_generator(tmp_path):
    """``models.turek_grid`` at 5 mm, written by the port's grid writer, is
    byte for byte the grid ``cases/turek/generate.py`` writes."""
    out = tmp_path / "gen.grid"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(REPO, "cases", "turek",
                                                 "generate.py"),
                    "--out", str(out)], check=True, env=env,
                   capture_output=True, timeout=300)
    grid = turek_grid(5e-3)
    assert grid.n == 44000
    write_grid_file(grid, str(tmp_path / "port.grid"))
    assert (tmp_path / "port.grid").read_bytes() == out.read_bytes()
    cfg = turek_config(5e-3)
    assert (cfg.dt, cfg.elastic_dt, cfg.substeps) == (1e-4, 2e-5, 5)
    assert cfg.scene == SCENES["turek_hron"] and cfg.two_dimensional
    assert cfg.numerics.rebuild_margin == 1.0


def test_turek_golden_20_steps(tmp_path):
    """The Turek-Hron channel (44,000 particles, x-periodic, the inlet
    re-imposed every step) against the reference binary after 20 steps,
    from the grid the port writes and the golden's own ``.data``,
    ``pallas_t`` with the C8 margin 1.0 of ``cases/turek/execute.sh``.
    Position differences take the minimum image on the periodic axis."""
    write_grid_file(turek_grid(5e-3), str(tmp_path / "turek.grid"))
    cfg, grid = load_case(
        os.path.join(REPO, "goldens", "turek", "turek.data"),
        tmp_path / "turek.grid", scene="turek_hron",
        numerics=NumericsConfig(dtype="float64", backend="pallas_t",
                                pallas_block=32, rebuild_margin=1.0))
    sim = Simulation(cfg, grid, device="cpu")
    # walls span the channel's ends and its top and bottom rows touch
    # across y: the plan covers both axes
    assert sim._ghosts is not None
    assert gh.spec_axes(sim._ghosts) == (True, True, False)
    state, done, ok = sim.run_chunk_guarded(sim.state0, 20)
    assert (done, ok) == (20, True)
    assert int(state.ghost_overflow) == 0
    out = to_numpy(state, sim.n)
    with gzip.open(os.path.join(REPO, "goldens", "turek",
                                "turek0020.prof.gz"), "rt") as f:
        t = float(f.readline())
        f.readline()
        g = np.loadtxt(f)
    assert t == pytest.approx(0.002) and out["time"] == pytest.approx(0.002)
    np.testing.assert_array_equal(out["prop"], g[:, 0].astype(np.int32))
    d = out["pos"][:, :2] - g[:, 1:3]
    w = float(sim.domain_width[0])
    d[:, 0] -= np.round(d[:, 0] / w) * w
    typ = g[:, 0].astype(int)
    ds = np.abs(d[(typ >= 2) & (typ < 4)]).max()
    df = np.abs(d[typ < 2]).max()
    assert ds < 5.0e-6, f"structure (flag) diff {ds:.3e} m vs golden"
    assert df < 2.0e-4, f"fluid min-image diff {df:.3e} m vs golden"


def test_turek_channel_matches_jax_packed(tmp_path):
    """The slice as a whole: the 44,000-particle channel from one grid file
    and ``cases/turek/turek.data``, ten steps on ``pallas_t`` with the C8
    margin 1.0, against the JAX ``packed`` engine (cell capacity 16, as
    the JAX Turek golden test).  Positions and the fluid's and walls'
    velocities at the JAX bar; the flag's velocities at rtol 1e-9 / atol
    2e-12: five stiff elastic substeps a step amplify the rounding of the
    pair sums' order there (the two engines lie ~1e-12 m/s apart)."""
    path = str(tmp_path / "turek.grid")
    write_grid_file(turek_grid(5e-3), path)
    data = os.path.join(REPO, "cases", "turek", "turek.data")
    jcfg, jgrid = jax_load_case(data, path, scene="turek_hron",
                                numerics=JaxNumerics(dtype="float64",
                                                     backend="packed",
                                                     cell_capacity=16))
    jsim = JaxSimulation(jcfg, jgrid)
    want = jax_to_numpy(jsim.run_chunk(jsim.state0, 10), jsim.n)
    cfg, grid = load_case(data, path, scene="turek_hron",
                          numerics=NumericsConfig(
                              dtype="float64", backend="pallas_t",
                              pallas_block=32, rebuild_margin=1.0))
    sim = Simulation(cfg, grid, device="cpu")
    got = to_numpy(sim.run_chunk(sim.state0, 10), sim.n)
    assert sim.rebuilds == 1 and sim.ghost_refreshes == 0
    flag = (got["prop"] >= 2) & (got["prop"] < 4)
    np.testing.assert_allclose(got["pos"], want["pos"], **POS)
    np.testing.assert_allclose(got["vel"][~flag], want["vel"][~flag], **VEL)
    np.testing.assert_allclose(got["vel"][flag], want["vel"][flag],
                               rtol=1e-9, atol=2e-12)


def test_turek_ghost_extension_equals_jax():
    """The channel's set-up plan and its first extension, port against the
    JAX package's, from the same grid (the frame every Turek step sorts)."""
    grid = turek_grid(5e-3)
    sim = Simulation(turek_config(5e-3, dtype="float64", backend="pallas_t",
                                  pallas_block=32), grid, device="cpu")
    jgrid = jax_cell_grid(sim.domain_min, sim.domain_max,
                          sim.cell_grid.support, two_dimensional=True)
    jspec = jgh.build_ghost_spec(
        jgrid, jgh.wrapped_axes(jgrid, grid.position, grid.prop >= 0,
                                sim._frame_support, True),
        grid.position, grid.prop >= 0, sim._frame_support)
    _same_spec(jspec, sim._ghosts)
    s = sim.state0
    got = sim._frame_inputs(s.pos, s.vel, s.prop)
    want = jgh.extend_with_ghosts(jspec, jgrid, jnp.asarray(s.pos.numpy()),
                                  jnp.asarray(s.vel.numpy()),
                                  jnp.asarray(s.prop.numpy()), sim.n_pad)
    for w, g in zip(want[:3], got[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[3]))
    assert int(got[2]) == int(want[4]) == 0
