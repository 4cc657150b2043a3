"""PyTorch port vs JAX package: the slice as a whole.  Ten coupled steps
through ``run_chunk`` on ``mini_fsi`` and on the bench scene (n_side=24), at
rebuild margins 0 and 0.5, port against the JAX ``pallas_t`` backend (Pallas
in interpret mode), float64 on the CPU.  Tolerances are the JAX package's own
bar between its backends (tests/test_backends.py): the pair sums are taken in
another order, nothing else differs."""

import jax
import numpy as np
import pytest
import torch

from cases import dam_like_config, mini_fsi
from test_torch_common import WINDOW_KW, bench_sims, port_cfg, port_grid
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
from particlemethod_fsi_tpu_torch.solver import Simulation
from particlemethod_fsi_tpu_torch.state import to_numpy

STEPS = 10


def _sims(scene, margin):
    if scene == "bench24":
        return bench_sims(24, rebuild_margin=margin)
    grid = mini_fsi()
    base = dict(scene=SCENES["dam"],
                young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))
    cfg = dam_like_config(rebuild_margin=margin, **WINDOW_KW).replace(**base)
    return (JaxSimulation(cfg, grid),
            Simulation(port_cfg(cfg), port_grid(grid), device="cpu"))


def _jax_rebuilds(jsim, steps):
    """Rebuild count of the JAX frame cache over one chunk (the cache lives
    inside ``run_chunk``'s scan, so the same step function is driven here)."""
    if not jsim._margin_cached:
        return steps
    step = jax.jit(jsim._step_core)
    s, c = jsim.state0, jsim._init_cache(jsim.state0)
    for _ in range(steps):
        s, c = step(s, c)
    return int(c["rebuilds"])


@pytest.mark.parametrize("margin", [0.0, 0.5])
@pytest.mark.parametrize("scene", ["mini_fsi", "bench24"])
def test_ten_steps_match_jax(scene, margin):
    jsim, psim = _sims(scene, margin)
    assert psim._margin_cached == jsim._margin_cached == (margin > 0)
    assert psim.has_structure and psim.cfg.substeps == 1
    want_rebuilds = _jax_rebuilds(jsim, STEPS)

    p0 = to_numpy(psim.state0)
    out = psim.run_chunk(psim.state0, STEPS)
    # the input state is left intact
    for k, v in to_numpy(psim.state0).items():
        np.testing.assert_array_equal(v, p0[k])
    got = to_numpy(out, psim.n)
    # run_chunk donates its carry on an accelerator: hand it a copy
    want = jax_to_numpy(
        jsim.run_chunk(jax.tree_util.tree_map(lambda x: x.copy(), jsim.state0),
                       STEPS), jsim.n)

    np.testing.assert_allclose(got["pos"], want["pos"], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(got["time"], want["time"], rtol=1e-12)
    assert psim.last_chunk_rebuilds == psim.rebuilds == want_rebuilds
    if margin > 0:
        assert 1 <= want_rebuilds < STEPS
    # the scene moved: fluid fell, the bar took load
    assert float(np.abs(got["pos"] - p0["pos"][: psim.n]).max()) > 1e-7
    s = (got["prop"] >= 2) & (got["prop"] < 4)
    assert float(np.abs(got["vel"][s]).max()) > 0


def test_step_rebuilds_every_time_and_keeps_its_input():
    _, psim = _sims("mini_fsi", 0.5)
    s0 = psim.state0
    before = to_numpy(s0)
    s1 = psim.step(s0)
    s2 = psim.step(s1)
    for k, v in to_numpy(s0).items():
        np.testing.assert_array_equal(v, before[k])
    assert float(s2.time) == pytest.approx(2 * psim.cfg.dt)
    # a second chunk starts from an empty cache again, as in the JAX package
    psim.run_chunk(s0, 3)
    first = psim.rebuilds
    psim.run_chunk(s0, 3)
    assert psim.rebuilds == 2 * first and psim.last_chunk_rebuilds == first


@pytest.mark.parametrize("what", ["rolling", "bar_first_mode", "moving_wall",
                                  "3d", "backend"])
def test_unported_paths_raise_by_name(what):
    """The paths that earlier slices refused run, each against its JAX
    path, three steps at the slice's bars: Rolling (rocking walls), the
    bar's first-mode profile, prescribed wall motion (translation and an
    in-plane rotation: the frame stays planar) and a 3-D frame with several
    z-planes of cells (plane-padded), against JAX ``pallas_t``; and the
    ``packed`` and ``gather`` engines (once refused with
    NotImplementedError), each against the same JAX engine, rebuilding
    every step with no ghost plan and no plane padding."""
    from cases import config_3d, mini_bar, mini_dam, mini_dam_3d
    from particlemethod_fsi_tpu.config import WallMotion

    grid = mini_dam()
    cfg = dam_like_config(**WINDOW_KW)
    if what == "backend":
        for backend in ("packed", "gather"):
            cfg = dam_like_config(backend=backend, rebuild_margin=0.5)
            jsim = JaxSimulation(cfg, grid)
            psim = Simulation(port_cfg(cfg), port_grid(grid), device="cpu")
            assert psim._backend == jsim._backend == backend
            assert psim.cell_capacity == jsim.cell_capacity == 16
            want = jax_to_numpy(jsim.run_chunk(jsim.state0, 3), jsim.n)
            got = to_numpy(psim.run_chunk(psim.state0, 3), psim.n)
            assert psim.rebuilds == 3 and psim._ghosts is None
            assert not psim._pad_planes and psim.ghost_refreshes == 0
            np.testing.assert_allclose(got["pos"], want["pos"], rtol=1e-12,
                                       atol=1e-15)
            np.testing.assert_allclose(got["vel"], want["vel"], rtol=1e-9,
                                       atol=1e-13)
            assert float(np.abs(got["pos"] - grid.position).max()) > 0
        return
    if what == "rolling":
        cfg = cfg.replace(scene=SCENES["rolling"])
    elif what == "bar_first_mode":
        grid = mini_bar()
        cfg = cfg.replace(scene=SCENES["bar"], gravity=(0.0, 0.0, 0.0),
                          young_modulus=(0.0, 0.0, 1e4, 1e5, 1e8, 1e4))
    elif what == "moving_wall":
        walls = list(cfg.walls)
        walls[4] = WallMotion(center=(0.012, 0.0, 0.0),
                              velocity=(0.1, 0.0, 0.0), omega=(0.0, 0.0, 2.0))
        cfg = cfg.replace(walls=tuple(walls))
    elif what == "3d":
        grid, cfg = mini_dam_3d(), config_3d(**WINDOW_KW)
    jsim = JaxSimulation(cfg, grid)
    psim = Simulation(port_cfg(cfg), port_grid(grid), device="cpu")
    assert psim._pcfg.planar == jsim._pcfg.planar == (what != "3d")
    assert psim._walls_static == jsim._walls_static == (
        what not in ("rolling", "moving_wall"))
    assert psim._pad_planes == jsim._pad_planes == (what == "3d")
    js = jsim.apply_initial_velocity_profile(jsim.state0)
    ps = psim.apply_initial_velocity_profile(psim.state0)
    want = jax_to_numpy(jsim.run_chunk(js, 3), jsim.n)
    got = to_numpy(psim.run_chunk(ps, 3), psim.n)
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=1e-9, atol=1e-13)
    np.testing.assert_array_equal(got["wall_center"], want["wall_center"])
    moved = np.abs(got["pos"] - grid.position).max(axis=1)
    if what in ("rolling", "moving_wall"):
        assert moved[(grid.prop >= 4) & (grid.prop < 6)].max() > 0
    if what == "bar_first_mode":
        assert np.abs(to_numpy(ps)["vel"][:, 1]).max() > 0
