"""The port's full-case runner and its summary (``tools/full_cases`` and
``tools/case_summary`` of the port) against the JAX repository's: the
summary's text equals that of ``tools/case_summary.py`` for every committed
metrics file, the flags read from each ``cases/*/execute.sh`` are its one
solver command line, and a short run of the gate case on the CPU leaves its
files and a table; a run whose exit code or watchdog is not the one
expected fails; the stable bar's kinetic energy, which ``full_cases``
prints beside the JAX package's committed metrics, is the JAX package's on
the CPU."""

import dataclasses
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.config import NumericsConfig as JaxNumerics
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu.solver import load_case as jax_load_case
from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
from particlemethod_fsi_tpu_torch.config import NumericsConfig
from particlemethod_fsi_tpu_torch.generator import generate_case
from particlemethod_fsi_tpu_torch.solver import Simulation, load_case
from particlemethod_fsi_tpu_torch.state import to_numpy
from particlemethod_fsi_tpu_torch.tools import case_summary, full_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, "cases", "*",
                                                 "*.jsonl")))
CASE_DIRS = sorted(os.path.basename(os.path.dirname(p)) for p in glob.glob(
    os.path.join(REPO, "cases", "*", "execute.sh")))


def test_the_committed_metrics_and_case_scripts_are_all_covered():
    assert len(METRICS) == 8 and len(CASE_DIRS) == 8
    assert {run.case_dir for run in full_cases.RUNS.values()} <= set(
        CASE_DIRS)


@pytest.mark.parametrize("every", [10, 3])
@pytest.mark.parametrize("path", METRICS)
def test_case_summary_prints_the_jax_tools_text(path, every, capsys):
    want = subprocess.run(
        [sys.executable, os.path.join("tools", "case_summary.py"), path,
         str(every)], cwd=REPO, capture_output=True, text=True, timeout=60,
        check=True).stdout
    assert case_summary.main([os.path.join(REPO, path), str(every)]) == 0
    assert capsys.readouterr().out == want
    assert want.count("\n") > 3


@pytest.mark.parametrize("case_dir", CASE_DIRS)
def test_script_flags_are_the_scripts_one_command_line(case_dir):
    """The five file arguments, the output digits, the scene and the
    metrics file that ``run_case`` reads from them, and nothing of the
    shell line around them."""
    flags = full_cases.script_flags(case_dir)
    with open(os.path.join(REPO, "cases", case_dir, "execute.sh")) as f:
        line = [s for s in f if "particlemethod_fsi_tpu.cli" in s]
    assert len(line) == 1
    assert line[0].replace("'", "").split()[3:-1] == list(flags)
    assert [os.path.splitext(a)[1] for a in flags[:5]] == [
        ".data", ".grid", ".prof", ".vtk", ".log"]
    assert flags[5] == "4"
    assert flags.count("--scene") == flags.count("--metrics") == 1
    assert flags[flags.index("--metrics") + 1].endswith("_metrics.jsonl")


@pytest.mark.parametrize("text", [
    "python -m particlemethod_fsi_tpu.cli a.data a.grid \"$@\"\n" * 2,
    "python -m particlemethod_fsi_tpu.cli a.data a.grid\n",
    "python -m other.cli a.data a.grid \"$@\"\n",
], ids=["two-lines", "no-passthrough", "other-module"])
def test_script_flags_refuse_a_script_that_is_not_one_command_line(
        text, tmp_path, monkeypatch):
    (tmp_path / "x").mkdir()
    (tmp_path / "x" / "execute.sh").write_text("#!/bin/sh\n" + text)
    monkeypatch.setattr(full_cases, "CASES_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="not one solver command line"):
        full_cases.script_flags("x")


def test_gate_run_on_the_cpu(tmp_path, capsys):
    rc = full_cases.main(["--out", str(tmp_path), "--runs", "gate",
                          "--device", "cpu", "--end-time", "0.002"])
    out = capsys.readouterr().out
    assert rc == 0, out
    work = tmp_path / "gate"
    made = set(os.listdir(work))
    assert {"gate.boid", "gate.data", "gate.grid", "gate.log",
            "gate_metrics.jsonl", "gate000.prof", "gate000.vtk"} <= made
    assert "exit code 0 (expected 0), 21 steps, 1 .vtk, 1 .prof" in out
    assert case_summary.summary(work / "gate_metrics.jsonl", 10) in out
    # the JAX package's committed row at step 0 beside the port's
    assert "cases/fsi_gate/gate_metrics.jsonl" in out
    assert "| 0 | 0.0000 | 0.0000e+00 | +0.000e+00 | +0.000e+00 | - |" in out


def test_a_run_that_ends_otherwise_than_expected_fails(tmp_path):
    """The shipped bar must end in the watchdog's exit code 2; stopped at
    step 21 it exits 0 with no watchdog line, and the run fails."""
    res = full_cases.run_case("bar", str(tmp_path), device="cpu",
                              end_time=0.002)
    assert res.rc == 0 and not res.ok
    assert "exit code 0, expected 2" in res.problems
    assert any(p.startswith("first WATCHDOG at t=None") for p in res.problems)


def test_stable_bar_energy_equals_the_jax_package_on_the_cpu(tmp_path):
    """The bar's stable run (``--no-double-substep --bar-amplitude 0.002``)
    through 20 steps, float64 on the CPU in both packages: the kinetic
    energy of the mobile rows, as the command line's metrics count it, is
    the JAX package's.  The JAX package's committed metrics of this run
    (``cases/bar/bar_stable_metrics.committed.jsonl``, taken on a TPU)
    read 1 % more at step 20 (the side table of ``full_cases`` prints them
    beside the port's at every step it shows)."""
    for f in ("bar.boid", "bar.data"):
        os.symlink(os.path.join(REPO, "cases", "bar", f), tmp_path / f)
    generate_case(str(tmp_path / "bar"))

    def stable(cfg):
        return cfg.replace(
            compat=dataclasses.replace(cfg.compat,
                                       double_substep_position_update=False),
            scene=dataclasses.replace(cfg.scene, bar_amplitude=0.002))

    def energy(h, density, volume):
        mobile = (h["prop"] >= 0) & (h["prop"] < 4)
        mass = np.asarray(density)[np.clip(h["prop"], 0, 5)] * volume
        return float(0.5 * np.sum((mass[:, None] * h["vel"] ** 2)[mobile]))

    paths = (str(tmp_path / "bar.data"), str(tmp_path / "bar.grid"))
    cfg, grid = load_case(*paths, scene="bar", numerics=NumericsConfig(
        dtype="float64", backend="pallas_t", pallas_block=32))
    sim = Simulation(stable(cfg), grid, device="cpu")
    st = sim.run_chunk(sim.apply_initial_velocity_profile(sim.state0), 20)
    got = energy(to_numpy(st, sim.n), cfg.density, sim.volume)

    jcfg, jgrid = jax_load_case(*paths, scene="bar", numerics=JaxNumerics(
        dtype="float64", backend="packed", cell_capacity=12))
    jsim = JaxSimulation(stable(jcfg), jgrid)
    jst = jsim.run_chunk(jsim.apply_initial_velocity_profile(jsim.state0), 20)
    want = energy(jax_to_numpy(jst, jsim.n), jcfg.density, jsim.volume)
    assert got == pytest.approx(want, rel=1e-9)

    with open(os.path.join(REPO, "cases", "bar",
                           "bar_stable_metrics.committed.jsonl")) as f:
        tpu = [m for m in map(json.loads, f)
               if m.get("step") == 20 and "kinetic_energy" in m]
    assert tpu[0]["kinetic_energy"] > 1.005 * want
