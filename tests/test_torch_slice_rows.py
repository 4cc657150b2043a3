"""PyTorch port vs JAX package: the row-major backend (``backend="pallas"``)
as a whole -- ten coupled steps through ``run_chunk``, the guarded chunk,
the diagnostics, the automatic route of frames of 2^24 cells or more, and
the command line -- float64 on the CPU, the JAX side on its ``pallas``
backend (Pallas in interpret mode).

Tolerances: trajectories are held to the JAX package's own bar between its
backends (pos rtol 1e-12 / atol 1e-15, vel rtol 1e-9 / atol 1e-13; the pair
sums are taken in another order, nothing else differs), the diagnostics to
those of ``test_torch_diagnostics.py``, and the command line's ``.prof``
files to 1.5 units of the last printed digit, as in ``test_torch_cli.py``.

The JAX side runs one receiver block a grid program
(``pallas_subblocks=1``: a TPU layout choice that changes no sum and halves
its kernels' interpret-mode compile), and each scene's JAX run is made once
for the module and shared by the trajectory and diagnostics tests."""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest

from cases import dam_like_config, mini_dam, mini_fsi
from test_torch_cli import _argv, _columns_close, gate  # noqa: F401 (fixture)
from test_torch_common import bench_sims, port_cfg, port_grid, port_state
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)
from test_torch_diagnostics import _scales

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
from particlemethod_fsi_tpu_torch import cli as pcli
from particlemethod_fsi_tpu_torch import convert
from particlemethod_fsi_tpu_torch.io.grid_file import read_grid_file
from particlemethod_fsi_tpu_torch.ops import windows as pw
from particlemethod_fsi_tpu_torch.solver import Simulation
from particlemethod_fsi_tpu_torch.state import to_numpy

STEPS = 10
ROWS_KW = dict(backend="pallas", pallas_block=32, pallas_wmax=128,
               pallas_subblocks=1)
_FSI = dict(scene=SCENES["dam"], young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))


def _sims(scene, **numerics_kw):
    if scene == "bench24":
        return bench_sims(24, backend="pallas", pallas_subblocks=1,
                          **numerics_kw)
    grid = mini_fsi()
    cfg = dam_like_config(**{**ROWS_KW, **numerics_kw}).replace(**_FSI)
    return (JaxSimulation(cfg, grid),
            Simulation(port_cfg(cfg), port_grid(grid), device="cpu"))


def _copy(jstate):
    # the JAX chunk runners donate their carry on an accelerator
    return jax.tree_util.tree_map(lambda x: x.copy(), jstate)


@functools.lru_cache(maxsize=None)
def _jax_run(scene, margin):
    """The JAX side of a scene, run once: its Simulation, the state after 5
    steps, and the state after 10 (numpy)."""
    jsim, _ = _sims(scene, rebuild_margin=margin)
    half = jsim.run_chunk(_copy(jsim.state0), STEPS // 2)
    full = jsim.run_chunk(_copy(half), STEPS - STEPS // 2)
    return jsim, half, jax_to_numpy(full, jsim.n)


def _assert_trajectories_close(got, want):
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(got["time"], want["time"], rtol=1e-12)


@pytest.mark.parametrize("margin", [0.0, 0.5])
@pytest.mark.parametrize("scene", ["mini_fsi", "bench24"])
def test_ten_steps_match_jax(scene, margin):
    _, psim = _sims(scene, rebuild_margin=margin)
    jsim, _, want = _jax_run(scene, margin)
    assert jsim._backend == psim._backend == "pallas"
    # no C8 frame reuse on the row-major backend, whatever the margin
    assert not psim._margin_cached and not jsim._margin_cached
    assert psim.has_structure and psim.cfg.substeps == 1

    before = dict(pw.launch_counts)
    p0 = to_numpy(psim.state0)
    got = to_numpy(psim.run_chunk(psim.state0, STEPS), psim.n)
    _assert_trajectories_close(got, want)
    assert psim.last_chunk_rebuilds == psim.rebuilds == STEPS
    assert pw.launch_counts == before  # plain versions on the CPU
    # the scene moved: fluid fell, the bar took load
    assert float(np.abs(got["pos"] - p0["pos"][: psim.n]).max()) > 1e-7
    s = (got["prop"] >= 2) & (got["prop"] < 4)
    assert float(np.abs(got["vel"][s]).max()) > 0


@pytest.mark.parametrize("margin", [0.0, 0.5])
def test_guarded_chunk_equals_run_chunk(margin):
    """Without the frame cache the guard makes its own host read a step; on
    a healthy run the guarded chunk is ``run_chunk`` bit for bit."""
    _, psim = _sims("mini_fsi", rebuild_margin=margin)
    want = psim.run_chunk(psim.state0, 6)
    got, done, ok = psim.run_chunk_guarded(psim.state0, 6)
    assert (done, ok) == (6, True)
    assert psim.last_chunk_rebuilds == 6
    for k in ("pos", "vel", "time", "prop"):
        assert bool((getattr(got, k) == getattr(want, k)).all()), k


@pytest.mark.parametrize("scene", ["mini_fsi", "bench24"])
def test_diagnostics_match_jax(scene):
    _, psim = _sims(scene, rebuild_margin=0.5)
    jsim, jstate, _ = _jax_run(scene, 0.5)
    want = convert.diagnostics_from_numpy(jsim.diagnostics(jstate))
    got = psim.diagnostics(port_state(jstate))

    assert set(got) == set(want)
    scales = _scales(jsim, want)
    for k in sorted(want):
        g, w = got[k], np.asarray(want[k])
        assert g.shape == w.shape, k
        assert g.dtype.kind == w.dtype.kind, (k, g.dtype, w.dtype)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            scale = scales.get(k, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12 * scale,
                                       err_msg=k)
    assert int(got["neighbor_count"].max()) >= 8
    assert float(np.abs(got["virial_stress"]).max()) > 0
    assert int(got["window_overflow"]) > 0


def _huge_domain(grid, support: float):
    """The same particles in a domain widened (up and right) until its cell
    grid has 2^24 cells or more."""
    side = 4200 * support  # 4200^2 > 2^24 cells of width >= support
    grid = dataclasses.replace(grid)
    grid.domain_max = np.array(grid.domain_max, dtype=np.float64)
    grid.domain_max[:2] = np.asarray(grid.domain_min)[:2] + side
    return grid


def test_frames_of_2_24_cells_go_to_the_row_major_kernels():
    cfg = dam_like_config(**{**ROWS_KW, "backend": "pallas_t"})
    probe = JaxSimulation(cfg, mini_dam())
    grid = _huge_domain(mini_dam(), probe._frame_support)
    jsim = JaxSimulation(cfg, grid)
    psim = Simulation(port_cfg(cfg), port_grid(grid), device="cpu")
    assert psim._frame_grid.num_cells == jsim._frame_grid.num_cells >= 1 << 24
    assert psim._backend == jsim._backend == "pallas"
    # the same on 'auto'
    auto = Simulation(port_cfg(cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, backend="auto"))), port_grid(grid), device="cpu")
    assert auto._backend == "pallas"
    got = to_numpy(psim.run_chunk(psim.state0, 3), psim.n)
    want = jax_to_numpy(jsim.run_chunk(_copy(jsim.state0), 3), jsim.n)
    _assert_trajectories_close(got, want)
    assert psim.rebuilds == 3
    # below 2^24 cells pallas_t stays pallas_t
    small = Simulation(port_cfg(cfg), port_grid(mini_dam()), device="cpu")
    assert small._backend == "pallas_t"


@pytest.mark.parametrize("gate", [0.0003], indirect=True)
def test_command_line_on_pallas_matches_pallas_t(gate):
    """``--backend pallas`` on the gate case writes, to the text format's
    floor, the ``.prof`` files of the same run on ``pallas_t``."""
    flags = ("--end-time", "0.0003", "--device", "cpu")
    assert pcli.main(_argv(gate, gate / "rows", "--backend", "pallas",
                           *flags)) == 0
    assert pcli.main(_argv(gate, gate / "t", "--backend", "pallas_t",
                           *flags)) == 0
    names = sorted(os.listdir(gate / "rows"))
    assert names == sorted(os.listdir(gate / "t")) == [
        "gate.log", "gate000.prof", "gate000.vtk", "gate003.prof",
        "gate003.vtk", "m.jsonl"]
    for name in ("gate000.prof", "gate003.prof"):
        got = read_grid_file(gate / "rows" / name)
        want = read_grid_file(gate / "t" / name)
        assert got.time == want.time and got.n == want.n == 6724
        np.testing.assert_array_equal(got.prop, want.prop)
        for k in ("position", "initial_position", "velocity"):
            _columns_close(f"{name} {k}", getattr(got, k), getattr(want, k))
    moved = read_grid_file(gate / "rows" / "gate003.prof")
    assert float(np.abs(moved.velocity).max()) > 1e-4
