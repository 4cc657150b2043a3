"""PyTorch port vs JAX package: the command line's multi-device run
(``--mesh N --mode {allgather,halo}``, ``--mesh-shape NXxNY``), float64 on
the CPU.

The port's command runs as a subprocess, ``--device cpu --host-devices 4
--mesh 4``: four gloo ranks, one process each, rank 0 writing every file
(bounded by a 120 s timeout that kills the whole process group); the JAX
command in process, ``--mesh 4`` on its virtual 8-device mesh.  The case is
``tests/cases.mini_fsi`` (221 particles, the coupled gate-like scene),
written as ``.data`` and ``.grid`` files, 20 steps of one output interval on
the packed engine, as ``tests/test_multichip_cli.py`` runs the JAX command:
the gate grid of ``cases/fsi_gate`` (6,724 particles) made the file take
some 80 s of one worker, over the minute it may take.

Tolerances are ``tests/test_multichip_cli.py``'s: the step-20 ``.prof``
positions within atol 1e-12 (all-gather) and 1e-9 (halo, with and without
rebalancing) of the port's one-device command and of the JAX command at
``--mesh 4``, and at ``--mesh-shape 2x2`` (the halo over rectangles, four
ranks; the JAX command on its virtual mesh).  The malformed, all-gather
and too-large mesh shapes exit 1 with the JAX command's messages.  The logs agree line by line (dates and seconds blanked; the
port's ``io writer`` and ``ranks`` lines aside)."""

import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

from cases import dam_like_config, mini_fsi
from test_torch_common import port_cfg, port_grid
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu import cli as jcli
from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu_torch import cli as pcli
from particlemethod_fsi_tpu_torch.io import write_data_file, write_grid_file
from particlemethod_fsi_tpu_torch.io.grid_file import read_grid_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"allgather": (["--mode", "allgather"], 1e-12),
         "halo": (["--mode", "halo"], 1e-9),
         "halo-no-rebalance": (["--mode", "halo", "--no-rebalance"], 1e-9)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("mcli")
    cfg = port_cfg(dam_like_config().replace(
        scene=SCENES["dam"], young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4),
        output_interval=0.002, vtk_output_interval=0.002))
    write_data_file(cfg, d / "fsi.data")
    write_grid_file(port_grid(mini_fsi()), d / "fsi.grid")
    return d


def _argv(case, out, *flags):
    out.mkdir(parents=True, exist_ok=True)
    return [str(case / "fsi.data"), str(case / "fsi.grid"),
            str(out / "o%03d.prof"), str(out / "o%03d.vtk"),
            str(out / "run.log"), "1", "--scene", "dam", "--dtype", "float64",
            "--end-time", "0.002", *flags]


def _run_port(case, out, *flags):
    """The port's command in a process group of its own, killed whole at
    the timeout (its ranks with it)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "particlemethod_fsi_tpu_torch.cli",
         *_argv(case, out, "--device", "cpu", *flags)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]
    return read_grid_file(out / "o020.prof")


def _run_jax(case, out, *flags):
    assert jcli.main(_argv(case, out, *flags)) == 0
    return read_grid_file(out / "o020.prof")


@pytest.fixture(scope="module")
def one_device(case):
    return _run_port(case, case / "one", "--backend", "packed")


def _log_lines(path):
    out = []
    for line in open(path).read().splitlines():
        if line.startswith(("io writer: ", "ranks: ")):
            continue
        line = re.sub(r" at (Mon|Tue|Wed|Thu|Fri|Sat|Sun) .*$", " at <date>",
                      line)
        out.append(re.sub(r"\d+\.\d+ \[sec\]", "<s> [sec]", line))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_mesh_4_matches_one_device_and_the_jax_command(case, one_device,
                                                       mode):
    flags, atol = MODES[mode]
    flags = ["--backend", "packed", "--mesh", "4", *flags]
    got = _run_port(case, case / f"port-{mode}", "--host-devices", "4",
                    *flags)
    want = _run_jax(case, case / f"jax-{mode}", *flags)
    assert got.n == want.n == mini_fsi().n
    np.testing.assert_array_equal(got.prop, want.prop)
    for ref in (one_device, want):
        np.testing.assert_allclose(got.position, ref.position, rtol=0,
                                   atol=atol)
    assert float(np.abs(got.velocity).max()) > 1e-3  # the scene moved
    log = (case / f"port-{mode}" / "run.log").read_text()
    assert "multi-chip: mode=%s mesh=4x1 devices platform=cpu" % (
        flags[flags.index("--mode") + 1]) in log
    assert "ranks: 4 processes, transport gloo" in log
    assert (_log_lines(case / f"port-{mode}" / "run.log")
            == _log_lines(case / f"jax-{mode}" / "run.log"))
    assert sorted(os.listdir(case / f"port-{mode}")) == [
        "o000.prof", "o000.vtk", "o020.prof", "o020.vtk", "run.log"]


def test_too_many_devices_returns_1_and_writes_no_prof(case):
    out = case / "over"
    rc = pcli.main(_argv(case, out, "--device", "cpu", "--mesh", "2"))
    assert rc == 1
    log = (out / "run.log").read_text()
    assert "ERROR: mesh of 2 devices but only 1 visible" in log
    assert not [f for f in os.listdir(out) if f.endswith(".prof")]


@pytest.mark.parametrize("mode", ["halo", "halo-no-rebalance"])
def test_mesh_shape_2x2_matches_one_device_and_the_jax_command(
        case, one_device, mode):
    """``--mesh-shape 2x2``: four gloo ranks on rectangles (equal-count x
    planes and per-column y planes, or equal width with
    ``--no-rebalance``), against the port's one-device command and the JAX
    command on its virtual mesh."""
    flags, atol = MODES[mode]
    flags = ["--backend", "packed", "--mesh-shape", "2x2", *flags]
    got = _run_port(case, case / f"port2d-{mode}", "--host-devices", "4",
                    *flags)
    want = _run_jax(case, case / f"jax2d-{mode}", *flags)
    assert got.n == want.n == mini_fsi().n
    np.testing.assert_array_equal(got.prop, want.prop)
    for ref in (one_device, want):
        np.testing.assert_allclose(got.position, ref.position, rtol=0,
                                   atol=atol)
    assert float(np.abs(got.velocity).max()) > 1e-3  # the scene moved
    log = (case / f"port2d-{mode}" / "run.log").read_text()
    assert "multi-chip: mode=halo mesh=2x2 devices platform=cpu" in log
    assert "ranks: 4 processes, transport gloo" in log
    halo_line = next(line for line in log.splitlines()
                     if line.startswith("halo: "))
    assert int(re.search(r"halo_cap_y=(\d+)", halo_line).group(1)) > 0
    assert (_log_lines(case / f"port2d-{mode}" / "run.log")
            == _log_lines(case / f"jax2d-{mode}" / "run.log"))


def test_mesh_shape_is_refused_by_name(case):
    """The JAX command's three refusals of a mesh shape, each logged with
    the JAX command's message and exit code 1, and before any rank starts,
    with no ``.prof`` written: not ``NXxNY``, outside the halo mode, more
    ranks than devices (the port given as many CPU ranks as the JAX
    command's eight virtual devices)."""
    for tag, flags, message in (
            ("form", ["--mesh-shape", "4"],
             "ERROR: --mesh-shape wants NXxNY (e.g. 4x2), got '4'"),
            ("mode", ["--mesh-shape", "2x2", "--mode", "allgather"],
             "ERROR: --mesh-shape is halo-mode only"),
            ("devices", ["--mesh-shape", "4x4"],
             "ERROR: mesh of 16 devices but only 8 visible")):
        out = case / f"shape-{tag}"
        assert pcli.main(_argv(case, out, "--device", "cpu",
                               "--host-devices", "8", *flags)) == 1
        assert message in (out / "run.log").read_text()
        assert os.listdir(out) == ["run.log"]
        jout = case / f"jax-shape-{tag}"
        assert jcli.main(_argv(case, jout, *flags)) == 1
        assert message in (jout / "run.log").read_text()
        assert not [f for f in os.listdir(jout) if f.endswith(".prof")]
