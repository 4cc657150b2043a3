"""Pairs that start to span the periodic boundary during a run: the port
extends its frame with ghost rows before the step whose state wraps.

The window sweeps clip windows at the domain edge, so pairs across the
periodic boundary need ghost rows (``ops/ghosts.py``).  The JAX package
rebuilds its ghost plan at a chunk boundary (``refresh_ghosts``;
``tests/test_backends.py``, the drifting block) and drops such pairs inside
the chunk until then; the port also tests the state every step starts from
(its six extremes, read with the step's one host read) and rebuilds the
plan before that step's forces, so no step drops them.  Oracle: the JAX
``packed`` engine, which always takes the minimum image, at the JAX
package's bar between its backends (pos rtol 1e-12 / atol 1e-15, vel rtol
1e-9 / atol 1e-13).

The scene is that test's: a 6 x 6 fluid block in a 16 x 12 L0 domain,
drifting at 0.5 m/s in +x without gravity, here with seeded velocity noise
(sd 0.05 m/s) so that the pair forces are live; ``pallas_t``, block 32, CPU
float64, 20-step chunks.  Its pairs first span x = 16 L0 during the fifth
chunk (steps 80-100).  A second scene comes within the support across the
boundary and goes back inside one chunk."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cases import L0, dam_like_config
from test_torch_common import port_cfg
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.generator import BoidScene as JaxBoidScene
from particlemethod_fsi_tpu.generator import Primitive as JaxPrimitive
from particlemethod_fsi_tpu.generator import generate_grid as jax_generate
from particlemethod_fsi_tpu.io.grid_file import read_grid_file as jax_read_grid
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
from particlemethod_fsi_tpu_torch import cli as pcli
from particlemethod_fsi_tpu_torch.generator import (
    BoidScene, Primitive, generate_grid)
from particlemethod_fsi_tpu_torch.io.data_file import write_data_file
from particlemethod_fsi_tpu_torch.io.grid_file import read_grid_file, write_grid_file
from particlemethod_fsi_tpu_torch.ops.ghosts import (
    spec_axes, wrapped_axes, wrapped_axes_device)
from particlemethod_fsi_tpu_torch.ops.neighbors import build_cell_grid
from particlemethod_fsi_tpu_torch.ops.walls import periodic_wrap
from particlemethod_fsi_tpu_torch.solver import Simulation
from particlemethod_fsi_tpu_torch.state import to_numpy

CHUNK = 20
# chunks that return before the first crossing, and the chunks at whose end
# the JAX package's ghost refresh may first see it (its test's window)
CLEAR_CHUNKS = 4
FIRST_WRAP_CHUNKS = (4, 5)


def _scene(boid, prim, generate):
    grid = generate(boid(
        particle_distance=L0, lower_domain=(0.0, 0.0, 0.0),
        upper_domain=(16 * L0, 12 * L0, L0),
        primitives=[prim("Cuboid", spacing=L0, type=1,
                         lower=(5 * L0, 3 * L0, 0), upper=(11 * L0, 9 * L0, L0))]))
    rng = np.random.default_rng(20)
    grid.velocity[:, :2] = rng.normal(scale=0.05, size=(grid.n, 2))
    grid.velocity[:, 0] += 0.5
    return grid


def _config():
    return dam_like_config(backend="pallas_t", pallas_block=32,
                           pallas_wmax=128).replace(gravity=(0.0, 0.0, 0.0))


def _port_sim():
    return Simulation(port_cfg(_config()),
                      _scene(BoidScene, Primitive, generate_grid),
                      device="cpu")


@functools.lru_cache(maxsize=None)
def _port_clear_states():
    """The states at the ends of the chunks before the crossing."""
    sim = _port_sim()
    states = [sim.state0]
    for _ in range(CLEAR_CHUNKS):
        states.append(sim.run_chunk(states[-1], CHUNK))
    return sim, states


def _wraps(sim, state) -> bool:
    """The test a step makes of the state it starts from: pairs of its
    positions, wrapped into the domain, span the periodic boundary."""
    pos = periodic_wrap(state.pos, sim._dmin_t, sim._width_t)
    return any(wrapped_axes_device(sim.cell_grid, pos, state.prop >= 0,
                                   sim._frame_support, True))


def _first_wrapping_state():
    """Single steps from the last clear state to the first state whose pairs
    span the boundary, and its step number (no step before it starts from
    a wrapping state, so the plan stays empty)."""
    sim, states = _port_clear_states()
    state, steps = states[-1], CHUNK * CLEAR_CHUNKS
    while not _wraps(sim, state):
        state, steps = sim.step(state), steps + 1
        assert steps <= CHUNK * FIRST_WRAP_CHUNKS[-1]
    assert sim._ghosts is None
    return sim, state, steps


def _copy(jstate):
    # the JAX chunk runners donate their carry on an accelerator
    return jax.tree_util.tree_map(lambda x: x.copy(), jstate)


def _jax_packed(grid, cfg, n_steps, chunk=CHUNK, state=None):
    """JAX ``packed`` states (numpy) after every ``chunk`` steps up to
    ``n_steps`` (from ``state``, a port state, if given)."""
    jsim = JaxSimulation(cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, backend="packed")), grid)
    js = jsim.state0
    if state is not None:
        js = js.replace(pos=jnp.asarray(state.pos.numpy()),
                        vel=jnp.asarray(state.vel.numpy()),
                        time=jnp.asarray(state.time.numpy()))
    out = [jax_to_numpy(js, jsim.n)]
    for _ in range(n_steps // chunk):
        js = jsim.run_chunk(_copy(js), chunk)
        out.append(jax_to_numpy(js, jsim.n))
    return out


@functools.lru_cache(maxsize=None)
def _drift_packed():
    return _jax_packed(_scene(JaxBoidScene, JaxPrimitive, jax_generate),
                       _config(), CHUNK * (FIRST_WRAP_CHUNKS[-1] + 1))


def _agree(got, want):
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=1e-9, atol=1e-13)


@pytest.mark.parametrize("runner", ["run_chunk", "run_chunk_guarded"])
def test_chunk_extends_the_frame_at_the_first_wrapping_state(runner):
    """The step that starts from the first wrapping state builds the plan
    (x covered) before its forces; the chunk runs on, and the states at
    steps 100 and 120 equal JAX ``packed``'s.  At the chunk boundary the
    plan is fresh: ``refresh_ghosts`` has nothing to do."""
    _, _, steps = _first_wrapping_state()
    sim = _port_sim()
    run = getattr(sim, runner)
    assert sim._ghosts is None
    state, refreshed_at, got = sim.state0, None, {}
    for chunk in range(FIRST_WRAP_CHUNKS[-1] + 1):
        out = run(state, CHUNK)
        state = out if runner == "run_chunk" else out[0]
        if runner == "run_chunk_guarded":
            assert out[1:] == (CHUNK, True)
        if refreshed_at is None and sim.ghost_refreshes:
            refreshed_at = chunk
        got[CHUNK * (chunk + 1)] = to_numpy(state, sim.n)
    assert refreshed_at in FIRST_WRAP_CHUNKS and refreshed_at >= CLEAR_CHUNKS
    # the step that starts from the state of step `steps`
    assert refreshed_at == steps // CHUNK
    assert sim.ghost_refreshes == 1 and spec_axes(sim._ghosts)[0]
    assert not sim.refresh_ghosts(state) and int(state.ghost_overflow) == 0
    want = _drift_packed()
    for at in (100, 120):
        _agree(got[at], want[at // CHUNK])


# the second scene: walls at the -x end and one fluid particle thrown
# toward +x against a strong -x gravity (m/s^2, m/s); it flies free of any
# pair and is back where it started after CHUNK steps
EXCURSION_GRAVITY, EXCURSION_SPEED = 6000.0, 6.3


def _excursion_grid(boid, prim, generate):
    grid = generate(boid(
        particle_distance=L0, lower_domain=(0.0, 0.0, 0.0),
        upper_domain=(16 * L0, 12 * L0, L0),
        primitives=[
            prim("Cuboid", spacing=L0, type=4, lower=(0.0, 3 * L0, 0),
                 upper=(3 * L0, 9 * L0, L0)),
            prim("Cuboid", spacing=L0, type=1, lower=(11 * L0, 6 * L0, 0),
                 upper=(12 * L0, 7 * L0, L0))]))
    grid.velocity[grid.prop == 1, 0] = EXCURSION_SPEED
    return grid


def _excursion_config():
    return _config().replace(gravity=(-EXCURSION_GRAVITY, 0.0, 0.0))


def _excursion_sim():
    return Simulation(port_cfg(_excursion_config()),
                      _excursion_grid(BoidScene, Primitive, generate_grid),
                      device="cpu")


@pytest.mark.parametrize("runner", ["run_chunk", "run_chunk_guarded"])
def test_a_wrap_that_comes_and_goes_inside_a_chunk_is_counted(runner):
    """The particle comes within the support of the walls across the x
    boundary and goes back inside one chunk: the chunk's two ends are
    clear, so only a test of every step's state sees those pairs.  The
    step that starts from the first wrapping state builds the plan; the
    diagnostics of that state count the particle's neighbours across the
    boundary; the chunk equals JAX ``packed``'s."""
    probe = _excursion_sim()
    states = [probe.state0]
    for _ in range(CHUNK):
        states.append(probe.step(states[-1]))
    wraps = [_wraps(probe, s) for s in states]
    assert not wraps[0] and not wraps[-1] and any(wraps)
    one = probe.state0.prop == 1
    x = [float(s.pos[one, 0]) for s in states]
    assert abs(x[-1] - x[0]) < 0.1 * L0 and max(x) < 16 * L0
    first = wraps.index(True)
    d = probe.diagnostics(states[first])
    assert int(d["neighbor_count"][one.numpy()][0]) > 0

    sim = _excursion_sim()
    out = getattr(sim, runner)(sim.state0, CHUNK)
    state = out if runner == "run_chunk" else out[0]
    assert sim.ghost_refreshes == 1 and spec_axes(sim._ghosts)[0]
    want = _jax_packed(_excursion_grid(JaxBoidScene, JaxPrimitive,
                                       jax_generate), _excursion_config(),
                       CHUNK)
    _agree(to_numpy(state, sim.n), want[-1])
    # the pairs were live: the particle did not fly free
    free = states[0].vel[one, 0] - EXCURSION_GRAVITY * CHUNK * 1e-4
    assert float((state.vel[one, 0] - free).abs()) > 1e-9


def test_a_chunk_from_a_wrapping_state_extends_its_first_step():
    """Both runners from the first wrapping state: the plan is built before
    the first step's forces; one step equals JAX ``packed``'s."""
    _, state, _ = _first_wrapping_state()
    want = _jax_packed(_scene(JaxBoidScene, JaxPrimitive, jax_generate),
                       _config(), 1, chunk=1, state=state)[-1]
    for runner in ("run_chunk", "run_chunk_guarded"):
        sim = _port_sim()
        out = getattr(sim, runner)(state, 1)
        got = out if runner == "run_chunk" else out[0]
        assert sim.ghost_refreshes == 1 and spec_axes(sim._ghosts)[0]
        _agree(to_numpy(got, sim.n), want)


def test_diagnostics_of_the_first_wrapping_state_extend_the_frame():
    """``diagnostics`` builds the plan for the state it is given, as a step
    does; its forces agree with the step's (a step's kick, undone)."""
    _, state, _ = _first_wrapping_state()
    sim = _port_sim()
    d = sim.diagnostics(state)
    assert sim.ghost_refreshes == 1 and spec_axes(sim._ghosts)[0]
    assert int(d["ghost_overflow"]) == 0
    assert int(d["neighbor_count"].max()) > 0
    # the step from the same state on the same plan: its kick is force/m dt
    nxt = sim.step(state)
    fluid = (state.prop == 1).numpy()
    mass = float(sim.tables.density[1]) * sim.volume
    kick = (nxt.vel.numpy() - state.vel.numpy())[fluid] * mass / sim.cfg.dt
    np.testing.assert_allclose(kick, d["force"][fluid], rtol=1e-9,
                               atol=1e-12 * float(np.abs(kick).max()))


def test_state_before_the_crossing_matches_jax_packed():
    _, states = _port_clear_states()
    want = _drift_packed()[CLEAR_CHUNKS]
    got = to_numpy(states[-1], len(want["prop"]))
    _agree(got, want)
    # the pair forces were live: the noise has decayed, not drifted on
    v0 = _scene(BoidScene, Primitive, generate_grid).velocity
    assert float(np.abs(got["vel"][:, :2] - v0[:, :2]).max()) > 1e-3


def test_packed_through_the_crossing_matches_jax_packed():
    """The port's own ``packed`` engine through the crossing: the minimum
    image of every pair and the cell wrap, no ghost plan; each chunk's end
    equals JAX ``packed``'s."""
    cfg = _config()
    sim = Simulation(port_cfg(cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, backend="packed"))),
        _scene(BoidScene, Primitive, generate_grid), device="cpu")
    want = _drift_packed()
    state = sim.state0
    for chunk in want[1:]:
        state = sim.run_chunk(state, CHUNK)
        _agree(to_numpy(state, len(chunk["prop"])), chunk)
    assert _wraps(sim, state)
    assert sim._ghosts is None and sim.ghost_refreshes == 0
    assert not sim.refresh_ghosts(state)
    assert sim.rebuilds == CHUNK * (len(want) - 1)


def test_cli_runs_through_the_crossing(tmp_path):
    """The command line runs through the crossing to its end: every output
    is written, the log says where the plan was built (once), and the last
    ``.prof`` is JAX ``packed``'s state to the print format."""
    n_chunks = FIRST_WRAP_CHUNKS[-1] + 1
    cfg = port_cfg(_config()).replace(
        output_interval=CHUNK * 1e-4, vtk_output_interval=CHUNK * 1e-4,
        end_time=CHUNK * 1e-4 * n_chunks)
    write_data_file(cfg, str(tmp_path / "drift.data"))
    write_grid_file(_scene(BoidScene, Primitive, generate_grid),
                    str(tmp_path / "drift.grid"))
    argv = [str(tmp_path / n) for n in ("drift.data", "drift.grid",
                                        "drift%03d.prof", "drift%03d.vtk",
                                        "drift.log")]
    rc = pcli.main([*argv, "4", "--scene", "dam", "--device", "cpu",
                    "--dtype", "float64", "--backend", "pallas_t"])
    assert rc == 0
    written = sorted(f for f in os.listdir(tmp_path) if f.endswith(".prof"))
    steps = [int(f[5:8]) for f in written]
    assert steps == list(range(0, CHUNK * n_chunks + 1, CHUNK))
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".vtk")]) == len(
        steps)
    log = (tmp_path / "drift.log").read_text()
    assert log.count("ghost spec refreshed inside the interval") == 1
    assert "WARNING" not in log and "WATCHDOG" not in log
    # JAX packed from the grid as the command line read it (velocities to
    # the print format's seven digits)
    want = _jax_packed(jax_read_grid(str(tmp_path / "drift.grid")),
                       _config(), CHUNK * n_chunks)[-1]
    last = read_grid_file(str(tmp_path / written[-1]))
    np.testing.assert_allclose(last.position, want["pos"], rtol=5.1e-7,
                               atol=1e-15)


def _numpy_cases():
    """Seeded positions in a 2-D and a 3-D grid, pads placed where they
    would change the answer if they counted."""
    rng = np.random.default_rng(3)
    cases = []
    for two_d in (True, False):
        dmin, dmax = np.zeros(3), np.array([0.02, 0.015, 0.01])
        grid = build_cell_grid(dmin, dmax, 2.5e-3, two_dimensional=two_d)
        for spread in (0.3, 0.9, 1.0):
            n = 40
            pos = dmin + (0.5 + spread * (rng.random((n, 3)) - 0.5)) * (
                dmax - dmin)
            valid = rng.random(n) < 0.8
            pos[~valid] = dmin + rng.choice([0.0, 1.0], size=(
                int((~valid).sum()), 3)) * (dmax - dmin)
            cases.append((grid, pos, valid, two_d, spread < 0.5))
        cases.append((grid, pos, np.zeros(n, dtype=bool), two_d, True))
    return cases


@pytest.mark.parametrize("case", range(8))
def test_device_form_of_wrapped_axes_matches_numpy(case):
    grid, pos, valid, two_d, pads_decide = _numpy_cases()[case]
    support = 2.5e-3
    want = wrapped_axes(grid, pos, valid, support, two_d)
    for dtype in (torch.float64, torch.float32):
        got = wrapped_axes_device(
            grid, torch.as_tensor(pos, dtype=dtype), torch.as_tensor(valid),
            support, two_d)
        assert got == wrapped_axes(grid, pos.astype(np.float32), valid,
                                   support, two_d)
        if dtype == torch.float64:
            assert got == want
    if pads_decide:
        # the valid rows do not wrap; counted as well, the pads would
        assert not any(want)
        assert any(wrapped_axes(grid, pos, np.ones_like(valid), support,
                                two_d))
