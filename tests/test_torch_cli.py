"""PyTorch port vs JAX package: the command-line run, both driven in process
on the coupled gate case (``cases/fsi_gate``, 6,724 particles, grid generated
under ``tmp_path``), float64 on the CPU; the JAX command on its default
backend there, or on the engine the port is given with ``--backend packed``
or ``gather``.

Tolerances.  Output files are compared after parsing, block by block (a
vector's components together), to 1.5 units of the last printed digit (``%e``
prints seven significant digits) of the block's largest magnitude: the two
packages sum pairs in another order, so a value may fall on the other side
of a rounding boundary, and a value that is zero but for rounding (the x
acceleration of a fluid at rest) has no digits to compare.  Log files are
compared line by line after blanking dates, seconds and measured speeds.  A
checkpoint resumes bit for bit; a ``.prof`` restart resumes from seven-digit
text, so it is held to 1e-5 of the scene's size after ten more steps."""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu import cli as jcli
from particlemethod_fsi_tpu_torch import cli as pcli
from particlemethod_fsi_tpu_torch.generator import generate_case
from particlemethod_fsi_tpu_torch.io.grid_file import read_grid_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAST_DIGIT = 1.5e-6  # 1.5 units of the seventh significant digit


@pytest.fixture()
def gate(tmp_path, request):
    """``gate.data`` with both output intervals cut to 20 steps (or to the
    test's own parameter), and the grid from ``gate.boid``."""
    interval = getattr(request, "param", 0.002)
    text = open(os.path.join(REPO, "cases", "fsi_gate", "gate.data")).read()
    text = re.sub(r"(?m)^OutputInterval\s+\S+",
                  f"OutputInterval\t{interval}", text)
    text = re.sub(r"(?m)^VtkOutputInterval\s+\S+",
                  f"VtkOutputInterval\t{interval}", text)
    (tmp_path / "gate.data").write_text(text)
    shutil.copy(os.path.join(REPO, "cases", "fsi_gate", "gate.boid"), tmp_path)
    generate_case(str(tmp_path / "gate"))
    return tmp_path


def _argv(case, out, *flags):
    os.makedirs(out, exist_ok=True)
    return [str(case / "gate.data"), str(case / "gate.grid"),
            str(out / "gate%03d.prof"), str(out / "gate%03d.vtk"),
            str(out / "gate.log"), "4", "--scene", "dam", "--metrics",
            str(out / "m.jsonl"), "--dtype", "float64", *flags]


def _run_port(case, out, *flags):
    return pcli.main(_argv(case, out, "--device", "cpu", *flags))


def _columns_close(name, got, want, noise=0.0):
    """``noise``: the size below which the column is rounding error of
    float64 terms (the solid's strain is ``(F^T F - I) / 2`` with terms of
    size 1, its stress that times the moduli: at rest both are pure
    rounding, 1e-16 of those terms, and print digits all the same)."""
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LAST_DIGIT * scale + noise, err_msg=name)


def _parse_vtk(path):
    """{block name: [n, width] array} of a legacy-ASCII dump."""
    blocks, name, rows = {}, None, []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] in ("POINTS", "SCALARS", "VECTORS", "CELLS",
                          "CELL_TYPES", "POINT_DATA"):
                if name and rows:
                    blocks[name] = np.array(rows, dtype=np.float64)
                name = "POINTS" if tok[0] == "POINTS" else (
                    tok[1] if tok[0] in ("SCALARS", "VECTORS") else None)
                rows = []
            elif name and tok[0] != "LOOKUP_TABLE" and tok[0] != "#":
                rows.append([float(t) for t in tok])
    if name and rows:
        blocks[name] = np.array(rows, dtype=np.float64)
    return blocks


def _log_shape(path, *, port):
    """Log lines with what varies from run to run blanked: dates, seconds,
    speeds; times of events are kept."""
    out = []
    for line in open(path).read().splitlines():
        if port and line.startswith("io writer: "):
            continue  # the port also says which writer ran
        line = re.sub(r" at (Mon|Tue|Wed|Thu|Fri|Sat|Sun) .*$", " at <date>", line)
        line = re.sub(r"\d+\.\d+ \[sec\]", "<s> [sec]", line)
        line = re.sub(r"max speed \S+ exceeds limit \S+",
                      "max speed <v> exceeds limit <v>", line)
        out.append(line)
    return out


def _same_interval(gate, jdir, pdir):
    """The two commands' outputs of one 20-step interval agree: files,
    parsed values to the print format, log lines, metrics."""
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names == [
        "gate.log", "gate000.prof", "gate000.vtk", "gate020.prof",
        "gate020.vtk", "m.jsonl"]
    for name in ("gate000.prof", "gate020.prof"):
        got, want = read_grid_file(pdir / name), read_grid_file(jdir / name)
        assert got.time == want.time and got.n == want.n == 6724
        np.testing.assert_array_equal(got.prop, want.prop)
        np.testing.assert_array_equal(got.domain_max, want.domain_max)
        for k in ("position", "initial_position", "velocity"):
            _columns_close(f"{name} {k}", getattr(got, k), getattr(want, k))
    # t = 0 is the input: byte for byte
    assert ((pdir / "gate000.prof").read_bytes()
            == (jdir / "gate000.prof").read_bytes())
    moved = read_grid_file(pdir / "gate020.prof")
    assert float(np.abs(moved.velocity).max()) > 1e-3

    for name in ("gate000.vtk", "gate020.vtk"):
        got, want = _parse_vtk(pdir / name), _parse_vtk(jdir / name)
        assert list(got) == list(want) and len(want) == 27
        assert "VirialPressureAtParticle" in want and "neighbor" in want
        for k in want:
            # the virial of a fluid at rest is the EOS's rounding,
            # kappa * (sum - n0) with sums of size 1 and kappa = 1e4
            noise = {"stress": 1e-12 * 1e5, "strain": 1e-12,
                     "Virial": 1e-12 * 1e4}.get(k[:6], 0.0)
            _columns_close(f"{name} {k}", got[k], want[k], noise)
        assert float(np.abs(want["VirialPressureAtParticle"]).max()) > 0
        assert float(np.abs(want["stress11"]).max()) > 0 or name == "gate000.vtk"

    assert (_log_shape(pdir / "gate.log", port=True)
            == _log_shape(jdir / "gate.log", port=False))
    assert "io writer: " in (pdir / "gate.log").read_text()
    jm = [json.loads(ln) for ln in open(jdir / "m.jsonl")]
    pm = [json.loads(ln) for ln in open(pdir / "m.jsonl")]
    assert [sorted(m) for m in pm] == [sorted(m) for m in jm] and len(jm) == 4
    for a, b in zip(pm, jm):
        for k in ("step", "chunk", "neighbor_max", "cell_overflow",
                  "ghost_overflow"):
            assert a.get(k) == b.get(k), k
        for k in ("time", "max_speed", "kinetic_energy", "momentum_y"):
            if k in b:
                assert a[k] == pytest.approx(b[k], rel=1e-9, abs=1e-15), k
    return pm


def test_one_interval_matches_the_jax_command(gate):
    flags = ("--end-time", "0.002")
    assert jcli.main(_argv(gate, gate / "j", *flags)) == 0
    assert _run_port(gate, gate / "p", *flags) == 0
    _same_interval(gate, gate / "j", gate / "p")


@pytest.mark.parametrize("backend", ["packed", "gather"])
def test_candidate_engines_match_the_jax_command(gate, backend):
    """``--backend packed`` and ``--backend gather``: one interval of each
    against the JAX command on the same engine (its diagnostics are the
    packed engine's on both, with no window: ``window_len`` 0)."""
    flags = ("--end-time", "0.002", "--backend", backend)
    assert jcli.main(_argv(gate, gate / "j", *flags)) == 0
    assert _run_port(gate, gate / "p", *flags) == 0
    pm = _same_interval(gate, gate / "j", gate / "p")
    dumps = [m for m in pm if "neighbor_max" in m]
    assert len(dumps) == 2
    assert all(m["window_len"] == 0 and m["cell_overflow"] > 0 for m in dumps)


def test_diverging_dt_takes_the_same_watchdog_path(gate):
    """A time step fifty times the case's blows up inside the first
    interval: guard, two dt-halving recoveries from the t=0 snapshot, then a
    rollback and return code 2 -- the same lines in both logs."""
    flags = ("--end-time", "0.02", "--dt", "5e-3", "--elastic-dt", "1e-3")
    rc_j = jcli.main(_argv(gate, gate / "j", *flags))
    rc_p = _run_port(gate, gate / "p", *flags)
    assert rc_p == rc_j == 2
    plog = _log_shape(gate / "p" / "gate.log", port=True)
    assert plog == _log_shape(gate / "j" / "gate.log", port=False)
    text = "\n".join(plog)
    assert text.count("GUARD: divergence") == 3
    assert text.count("WATCHDOG: recovering") == 2
    assert "retries exhausted, aborting run" in text
    assert sorted(os.listdir(gate / "p")) == sorted(os.listdir(gate / "j"))


@pytest.mark.parametrize("gate", [0.001], indirect=True)
def test_restore_and_restart_grid_resume_the_run(gate):
    """Output every 10 steps, 20 steps in all; resumed from step 10."""
    whole = gate / "whole"
    assert _run_port(gate, whole, "--end-time", "0.002", "--checkpoint",
                     str(whole / "ck%03d.npz")) == 0
    want = read_grid_file(whole / "gate020.prof")
    assert want.time == pytest.approx(0.002)

    # a binary checkpoint resumes bit for bit (no rebuild margin: every step
    # builds its frame anew, so nothing depends on where the run started)
    ck = gate / "from_ck"
    assert _run_port(gate, ck, "--end-time", "0.002", "--restore",
                     str(whole / "ck010.npz")) == 0
    assert "restored checkpoint" in (ck / "gate.log").read_text()
    # the output clocks start at 0 whatever the time of the restart (as in
    # the JAX command): a snapshot at once, one step, a snapshot that puts
    # the clock right, then the rest of the interval
    assert sorted(n for n in os.listdir(ck) if n.endswith(".prof")) == [
        "gate010.prof", "gate011.prof", "gate020.prof"]
    assert ((ck / "gate020.prof").read_bytes()
            == (whole / "gate020.prof").read_bytes())

    # a .prof is a valid grid: seven-digit text, so close and not equal
    rs = gate / "from_prof"
    assert _run_port(gate, rs, "--end-time", "0.002", "--restart-grid",
                     str(whole / "gate010.prof")) == 0
    assert "restarting from" in (rs / "gate.log").read_text()
    got = read_grid_file(rs / "gate020.prof")
    assert got.time == pytest.approx(0.002)
    size = float(np.abs(want.position).max())
    diff = float(np.abs(got.position - want.position).max())
    assert 0 < diff < 1e-5 * size, diff


def test_without_a_device_flag_and_without_a_gpu_nothing_is_written(gate):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the command would run on it")
    out = gate / "none"
    os.makedirs(out)
    argv = [a for a in _argv(gate, out)]
    with pytest.raises(SystemExit) as e:
        pcli.main(argv)
    assert e.value.code not in (0, None) and "no CUDA device" in str(e.value.code)
    assert os.listdir(out) == []
    with pytest.raises(SystemExit):
        pcli.main(argv + ["--device", "cuda"])
    assert os.listdir(out) == []
    # more ranks than devices exits 1 and writes no .prof, with --mesh and
    # with --mesh-shape (the 2-axis rectangles: 2x2 is four ranks)
    assert pcli.main(argv + ["--device", "cpu", "--mesh-shape", "2x2"]) == 1
    assert "ERROR: mesh of 4 devices but only 1 visible" in (
        out / "gate.log").read_text()
    assert not [f for f in os.listdir(out) if f.endswith(".prof")]
    assert pcli.main(argv + ["--device", "cpu", "--mesh", "4"]) == 1
    assert not [f for f in os.listdir(out) if f.endswith(".prof")]


def test_bar_profile_matches_the_jax_command(tmp_path):
    """``--apply-velocity-profile`` with ``--bar-amplitude`` on the bar case
    (``cases/bar``: a cantilever excited in its first bending mode, five
    elastic substeps a step), ten steps with one output after five, as the
    JAX command runs it (``packed`` there): the snapshots to the print
    format, the tip moving up."""
    text = open(os.path.join(REPO, "cases", "bar", "bar.data")).read()
    text = re.sub(r"(?m)^OutputInterval\s+\S+", "OutputInterval\t0.0005", text)
    text = re.sub(r"(?m)^VtkOutputInterval\s+\S+", "VtkOutputInterval\t1",
                  text)
    (tmp_path / "bar.data").write_text(text)
    shutil.copy(os.path.join(REPO, "cases", "bar", "bar.boid"), tmp_path)
    generate_case(str(tmp_path / "bar"))

    def argv(out, *flags):
        os.makedirs(out, exist_ok=True)
        return [str(tmp_path / "bar.data"), str(tmp_path / "bar.grid"),
                str(out / "bar%03d.prof"), str(out / "bar%03d.vtk"),
                str(out / "bar.log"), "4", "--scene", "bar",
                "--apply-velocity-profile", "--bar-amplitude", "0.005",
                "--dtype", "float64", "--end-time", "0.001", *flags]

    assert jcli.main(argv(tmp_path / "j")) == 0
    assert pcli.main(argv(tmp_path / "p", "--device", "cpu")) == 0
    names = sorted(n for n in os.listdir(tmp_path / "j") if n.endswith(".prof"))
    assert names == ["bar000.prof", "bar005.prof", "bar010.prof"]
    assert sorted(n for n in os.listdir(tmp_path / "p")
                  if n.endswith(".prof")) == names
    for name in names:
        got = read_grid_file(tmp_path / "p" / name)
        want = read_grid_file(tmp_path / "j" / name)
        assert got.time == want.time and got.n == want.n == 800
        for k in ("position", "velocity"):
            _columns_close(f"{name} {k}", getattr(got, k), getattr(want, k))
    start = read_grid_file(tmp_path / "p" / "bar000.prof")
    end = read_grid_file(tmp_path / "p" / "bar010.prof")
    tip = int(np.argmax(start.initial_position[:, 0]))
    # the profile's tip speed: amplitude x c0 (c0 = sqrt(K / rho), K the
    # Bar module's 3.25e6) x f(x_tip) / f(L), which is just under 1
    assert start.velocity[tip, 1] == pytest.approx(
        0.005 * np.sqrt(3.25e6 / 1100), rel=0.01)
    assert end.position[tip, 1] > start.position[tip, 1]
