"""The port refuses a run once pairs start to span the periodic boundary.

The window sweeps clip windows at the domain edge; pairs across the periodic
boundary need ghost rows, which the port does not have yet.  Set-up refuses
such a scene, and so does every chunk, on the state it starts from, on
every state a step of it returns and so on the state it would return, and
``diagnostics`` (``Simulation._refuse_wrap``), where the JAX package
refreshes its ghosts at the chunk boundary (``tests/test_backends.py``, the
drifting block).  A second scene comes within the support across the
boundary and goes back inside one chunk.

The scene is that test's: a 6 x 6 fluid block in a 16 x 12 L0 domain,
drifting at 0.5 m/s in +x without gravity, here with seeded velocity noise
(sd 0.05 m/s) so that the pair forces are live; ``pallas_t``, block 32, CPU
float64, 20-step chunks.  Its first particles cross x = 16 L0 during the
fifth chunk (steps 80-100).  Before that the port agrees with the JAX
``packed`` engine, which always takes the minimum image, at the JAX
package's bar between its backends (pos rtol 1e-12 / atol 1e-15, vel rtol
1e-9 / atol 1e-13): the check changes nothing before the crossing."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from cases import L0, dam_like_config
from test_torch_common import port_cfg

from particlemethod_fsi_tpu.generator import BoidScene as JaxBoidScene
from particlemethod_fsi_tpu.generator import Primitive as JaxPrimitive
from particlemethod_fsi_tpu.generator import generate_grid as jax_generate
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
from particlemethod_fsi_tpu_torch import cli as pcli
from particlemethod_fsi_tpu_torch.generator import (
    BoidScene, Primitive, generate_grid)
from particlemethod_fsi_tpu_torch.io.data_file import write_data_file
from particlemethod_fsi_tpu_torch.io.grid_file import write_grid_file
from particlemethod_fsi_tpu_torch.ops.neighbors import build_cell_grid
from particlemethod_fsi_tpu_torch.solver import (
    Simulation, wrapped_axes, wrapped_axes_device)
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
    return any(wrapped_axes_device(sim.cell_grid, state.pos, state.prop >= 0,
                                   sim._frame_support, True))


def _first_wrapping_state():
    """Single steps (``step`` does not check) from the last clear state to
    the first state whose pairs span the boundary, and its step number."""
    sim, states = _port_clear_states()
    state, steps = states[-1], CHUNK * CLEAR_CHUNKS
    while not _wraps(sim, state):
        state, steps = sim.step(state), steps + 1
        assert steps <= CHUNK * FIRST_WRAP_CHUNKS[-1]
    return sim, state, steps


@pytest.mark.parametrize("runner", ["run_chunk", "run_chunk_guarded"])
def test_chunk_refuses_the_first_wrapping_state(runner):
    sim = _port_sim()
    run = getattr(sim, runner)
    state = sim.state0
    for chunk in range(FIRST_WRAP_CHUNKS[-1] + 1):
        try:
            out = run(state, CHUNK)
        except NotImplementedError as e:
            msg = str(e)
            break
        state = out if runner == "run_chunk" else out[0]
        if runner == "run_chunk_guarded":
            assert out[1:] == (CHUNK, True)
    else:
        pytest.fail("no chunk refused the wrapping state")
    assert chunk in FIRST_WRAP_CHUNKS and chunk >= CLEAR_CHUNKS
    # the error names the step whose state wraps first
    _, _, steps = _first_wrapping_state()
    assert "axis x " in msg and f"after {steps - CHUNK * chunk} steps" in msg
    assert "periodic ghosts are not ported" in msg
    # the chunk that refused returned nothing: the next one, from the last
    # state it did return, refuses again at the same step
    with pytest.raises(NotImplementedError,
                       match=f"axis x after {steps - CHUNK * chunk} steps"):
        run(state, CHUNK)


# the second scene: walls at the -x end and one fluid particle thrown
# toward +x against a strong -x gravity (m/s^2, m/s); it flies free of any
# pair and is back where it started after CHUNK steps
EXCURSION_GRAVITY, EXCURSION_SPEED = 6000.0, 6.3


def _excursion_sim():
    grid = generate_grid(BoidScene(
        particle_distance=L0, lower_domain=(0.0, 0.0, 0.0),
        upper_domain=(16 * L0, 12 * L0, L0),
        primitives=[
            Primitive("Cuboid", spacing=L0, type=4, lower=(0.0, 3 * L0, 0),
                      upper=(3 * L0, 9 * L0, L0)),
            Primitive("Cuboid", spacing=L0, type=1, lower=(11 * L0, 6 * L0, 0),
                      upper=(12 * L0, 7 * L0, L0))]))
    grid.velocity[grid.prop == 1, 0] = EXCURSION_SPEED
    return Simulation(port_cfg(_config().replace(
        gravity=(-EXCURSION_GRAVITY, 0.0, 0.0))), grid, device="cpu")


@pytest.mark.parametrize("runner", ["run_chunk", "run_chunk_guarded"])
def test_chunk_refuses_a_wrap_that_comes_and_goes_inside_it(runner):
    """The particle comes within the support of the walls across the x
    boundary and goes back inside one chunk: the chunk's two ends are clear,
    so only a test of every step's state sees the dropped pairs."""
    sim = _excursion_sim()
    states = [sim.state0]
    for _ in range(CHUNK):
        states.append(sim.step(states[-1]))
    wraps = [_wraps(sim, s) for s in states]
    assert not wraps[0] and not wraps[-1] and any(wraps)
    x = [float(s.pos[sim.state0.prop == 1, 0]) for s in states]
    assert abs(x[-1] - x[0]) < 0.1 * L0 and max(x) < 16 * L0
    first = wraps.index(True)
    with pytest.raises(NotImplementedError,
                       match=f"axis x after {first} steps of the chunk"):
        getattr(sim, runner)(sim.state0, CHUNK)


def test_chunk_refuses_a_wrapping_start_state():
    sim, state, _ = _first_wrapping_state()
    for runner in (sim.run_chunk, sim.run_chunk_guarded):
        with pytest.raises(NotImplementedError,
                           match="axis x in the state the chunk starts"):
            runner(state, 1)


def test_diagnostics_refuses_the_first_wrapping_state():
    sim, state, steps = _first_wrapping_state()
    assert CHUNK * CLEAR_CHUNKS < steps <= CHUNK * FIRST_WRAP_CHUNKS[-1]
    with pytest.raises(NotImplementedError,
                       match="axis x in the state of the diagnostics"):
        sim.diagnostics(state)
    # one step earlier the diagnostics run
    _, states = _port_clear_states()
    d = sim.diagnostics(states[-1])
    assert int(d["neighbor_count"].max()) > 0


def test_state_before_the_crossing_matches_jax_packed():
    _, states = _port_clear_states()
    jgrid = _scene(JaxBoidScene, JaxPrimitive, jax_generate)
    jsim = JaxSimulation(dam_like_config(backend="packed").replace(
        gravity=(0.0, 0.0, 0.0)), jgrid)
    js = jsim.state0
    for _ in range(CLEAR_CHUNKS):
        js = jsim.run_chunk(jax.tree_util.tree_map(lambda x: x.copy(), js),
                            CHUNK)
    want = jax_to_numpy(js, jsim.n)
    got = to_numpy(states[-1], jgrid.n)
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=1e-9, atol=1e-13)
    # the pair forces were live: the noise has decayed, not drifted on
    v0 = _scene(BoidScene, Primitive, generate_grid).velocity
    assert float(np.abs(got["vel"][:, :2] - v0[:, :2]).max()) > 1e-3


def test_cli_stops_at_the_wrapping_chunk(tmp_path):
    """The command line writes every output before the crossing, then the
    chunk's error ends the run: no output of a state whose pairs were
    dropped is written."""
    cfg = port_cfg(_config()).replace(
        output_interval=CHUNK * 1e-4, vtk_output_interval=CHUNK * 1e-4,
        end_time=CHUNK * 1e-4 * (FIRST_WRAP_CHUNKS[-1] + 2))
    write_data_file(cfg, str(tmp_path / "drift.data"))
    write_grid_file(_scene(BoidScene, Primitive, generate_grid),
                    str(tmp_path / "drift.grid"))
    argv = [str(tmp_path / n) for n in ("drift.data", "drift.grid",
                                        "drift%03d.prof", "drift%03d.vtk",
                                        "drift.log")]
    with pytest.raises(NotImplementedError, match="axis x "):
        pcli.main([*argv, "4", "--scene", "dam", "--device", "cpu",
                   "--dtype", "float64", "--backend", "pallas_t"])
    written = sorted(f for f in os.listdir(tmp_path) if f.endswith(".prof"))
    steps = [int(f[5:8]) for f in written]
    assert steps == list(range(0, steps[-1] + 1, CHUNK))
    assert CHUNK * CLEAR_CHUNKS <= steps[-1] < CHUNK * FIRST_WRAP_CHUNKS[-1]
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".vtk")]) == len(
        steps)


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
