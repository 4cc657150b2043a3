"""The port's copy of the breaking-wave lattice (``models/wave.py``) against
``cases/wave/generate.py``, the script that imports the JAX package: the
grid the port writes at scale 0.06 (9,222 particles) is byte for byte the
file the script writes (both run in process); and the case loads into a Simulation that runs the
1-D halo on the window sweep (no axis wraps, so the local engine is
``pallas_t``)."""

import os
import runpy
import sys

import numpy as np
import torch

from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu_torch.config import NumericsConfig
from particlemethod_fsi_tpu_torch.models import wave
from particlemethod_fsi_tpu_torch.parallel import halo
from particlemethod_fsi_tpu_torch.parallel.comm import Comm
from particlemethod_fsi_tpu_torch.solver import Simulation, load_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_grid_is_the_generate_script_file(tmp_path, monkeypatch, capsys):
    jax_file, port_file = tmp_path / "jax.grid", tmp_path / "port.grid"
    monkeypatch.setattr(sys, "argv", ["generate.py", "--scale", "0.06",
                                      "--out", str(jax_file)])
    runpy.run_path(os.path.join(REPO, "cases", "wave", "generate.py"),
                   run_name="__main__")
    wave.main(["--scale", "0.06", "--out", str(port_file)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == ("9222 particles were generated "
                                "(types [0, 1554, 36, 0, 7632, 0])")
    assert port_file.read_bytes() == jax_file.read_bytes()


def test_wave_runs_the_halo_on_the_window_sweep(tmp_path):
    path = tmp_path / "wave.grid"
    wave.main(["--scale", "0.06", "--out", str(path)])
    cfg, grid = load_case(wave.DATA_FILE, path, scene="dam")
    assert not cfg.two_dimensional and grid.n == 9222
    sim = Simulation(cfg.replace(numerics=NumericsConfig(
        dtype="float64", rebuild_margin=0.5)), grid, device="cpu")
    assert sim._ghosts is None  # the gap beyond the walls: nothing wraps
    comm = Comm.local("cpu")
    runner = halo.make_halo_step(sim, comm)
    assert runner.engine == "pallas_t" and runner.use_c8
    state = halo.partition_state(sim, comm, runner.hcfg)
    g = halo.gather_state(sim, comm, state)
    assert np.array_equal(np.sort(g["oid"]), np.arange(grid.n))
    assert torch.equal(halo.to_slot_state(sim, comm, state).pos,
                       sim.state0.pos)
