"""The port's golden acceptance tool (``tools/golden_acceptance`` of the
port) against the JAX package's: its production numerics field for field
against the JAX tool's, its comparison helpers against the JAX golden
tests' inline arithmetic (``tests/test_golden.py``) on seeded arrays, the
bar's tip errors in float32 at the C8 margin 0.5 on the CPU through step
100 against the JAX package's on the same grid (and under 1 % of the peak,
the JAX tool's bar), and the exit code 1 of both tools where there is no
GPU and no ``--device cpu``."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.config import NumericsConfig as JaxNumerics
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu.solver import load_case as jax_load_case
from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
from particlemethod_fsi_tpu_torch.generator import generate_case
from particlemethod_fsi_tpu_torch.tools import golden_acceptance as ga

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_production_numerics(backend):
    """The JAX tool's ``production_numerics`` (``tools/golden_acceptance.py``
    :43-45), which is a script that pins its own platform on import, so it
    is not run here: its one line is read and built with the JAX package's
    ``NumericsConfig``."""
    with open(os.path.join(REPO, "tools", "golden_acceptance.py")) as f:
        assert ("    return NumericsConfig(backend=backend, "
                "rebuild_margin=0.5)\n") in f.read()
    return JaxNumerics(backend=backend, rebuild_margin=0.5)


@pytest.mark.parametrize("backend", ["pallas_t", "pallas"])
def test_production_numerics_equal_the_jax_tools(backend):
    want = dataclasses.asdict(_jax_production_numerics(backend))
    got = dataclasses.asdict(ga.production_numerics(backend))
    assert got == want
    assert got["dtype"] == "float32" and got["rebuild_margin"] == 0.5


def _synthetic(seed=0, n=400, width=2.5):
    """A golden's rows (type, x, y, z, ...) and positions near them, some
    carried across the periodic x axis by one width."""
    rng = np.random.default_rng(seed)
    gold = np.zeros((n, 10))
    gold[:, 0] = rng.integers(0, 6, n)
    gold[:, 1] = rng.uniform(0.0, width, n)
    gold[:, 2] = rng.uniform(0.0, 0.41, n)
    pos = np.zeros((n, 3))
    pos[:, :2] = gold[:, 1:3] + rng.normal(0.0, 1e-4, (n, 2))
    wrap = rng.random(n) < 0.1
    pos[wrap, 0] += np.where(rng.random(wrap.sum()) < 0.5, width, -width)
    return pos, gold, width


# the JAX golden tests' inline arithmetic for each comparison
# (tests/test_golden.py:186-209 and :140-167)
def _jax_all(out_pos, g, w):
    return np.abs(out_pos[:, :2] - g[:, 1:3]).max()


def _jax_wall(out_pos, g, w):
    wall = g[:, 0].astype(int) == 4
    return np.abs(out_pos[wall, :2] - g[wall, 1:3]).max()


def _jax_structure(out_pos, g, w):
    struct_rows = (g[:, 0].astype(int) >= 2) & (g[:, 0].astype(int) < 4)
    return np.abs(out_pos[struct_rows, :2] - g[struct_rows, 1:3]).max()


def _jax_turek(which):
    def f(out_pos, g, w):
        d = out_pos[:, :2] - g[:, 1:3]
        d[:, 0] -= np.round(d[:, 0] / w) * w
        typ = g[:, 0].astype(int)
        rows = (typ >= 2) & (typ < 4) if which == "structure" else typ < 2
        return np.abs(d[rows]).max()
    return f


@pytest.mark.parametrize("which,periodic,jax_f", [
    (ga.ALL, False, _jax_all),
    (ga.WALL, False, _jax_wall),
    (ga.STRUCTURE, False, _jax_structure),
    (ga.STRUCTURE, True, _jax_turek("structure")),
    (ga.FLUID, True, _jax_turek("fluid")),
], ids=["all", "wall", "structure", "turek-structure", "turek-fluid"])
def test_comparisons_equal_the_jax_tests_arithmetic(which, periodic, jax_f):
    pos, gold, width = _synthetic()
    got = ga.max_dpos(pos, gold, ga.select(gold[:, 0], which),
                      width if periodic else None)
    assert got == jax_f(pos, gold, width)
    if not periodic and which == ga.ALL:
        # the wrapped rows dominate without the minimum image ...
        assert got > 2.0
    if periodic:
        # ... and vanish with it
        assert got < 1e-3


def test_rows_with_a_bar_fail_on_nan_and_rows_without_never_do():
    assert ga.Row("x", 1e-6, "m", 2e-5, 1.0).ok
    assert not ga.Row("x", 3e-5, "m", 2e-5, 1.0).ok
    assert not ga.Row("x", float("nan"), "m", 2e-5, 1.0).ok
    assert ga.Row("x", float("nan"), "m", None, 1.0).ok
    assert "FAIL (bar 2e-05)" in ga.format_row(ga.Row("x", 3e-5, "m", 2e-5,
                                                      1.0))


def test_every_barred_row_has_its_golden_and_divides_into_chunks():
    """Each check's golden is committed, every horizon is a whole number of
    the case's uniform chunks, and the barred rows carry the tool's bars."""
    bars = {}
    for name, case in ga.CASES.items():
        for check in case.checks:
            assert check.step % case.chunk == 0
            assert os.path.exists(os.path.join(
                ga.GOLD, case.gold_dir, case.pattern % check.step))
            for label, _, bar in check.rows:
                bars[f"{name}@{check.step}" + (f" {label}" if label
                                               else "")] = bar
    assert {k: v for k, v in bars.items() if v is not None} == {
        "dam@100": 5.0e-5, "dam@1000": 5.0e-4, "gate@100": 2.0e-5,
        "rolling1@100": 2.0e-5, "rolling@500": 2.0e-4,
        "rolling@500 wall": 2.0e-4, "hydro@200": 5.0e-4,
        "hydro@200 structure": 1.0e-4, "turek@100 structure": 5.0e-5,
        "turek@100 fluid": 2.0e-3}


def _jax_bar_tip_errors(tmp_path, last_step):
    """The JAX tool's sampling of the bar (``tools/golden_acceptance.py``
    ``bar``) with its production numerics, on the port generator's grid."""
    for f in ("bar.boid", "bar.data"):
        os.symlink(os.path.join(REPO, "cases", "bar", f), tmp_path / f)
    generate_case(str(tmp_path / "bar"))
    cfg, gd = jax_load_case(
        os.path.join(ga.GOLD, "bar", "bar.data"), str(tmp_path / "bar.grid"),
        scene="bar", numerics=_jax_production_numerics("pallas_t"))
    sim = JaxSimulation(cfg, gd)
    st = sim.apply_initial_velocity_profile(sim.state0)
    x0 = np.asarray(gd.initial_position)
    tip = int(np.argmax(x0[:, 0]))
    gold = np.genfromtxt(os.path.join(ga.GOLD, "bar", "tip_trajectory.csv"),
                         delimiter=",", names=True)
    step, errs = 0, []
    for t_g, uy_g in zip(gold["time"], gold["uy"]):
        target = int(round(t_g / cfg.dt))
        if target > last_step:
            break
        while step < target:
            st = sim.run_chunk(st, 20)
            step += 20
        out = jax_to_numpy(st, sim.n)
        errs.append(abs(float(out["pos"][tip, 1] - x0[tip, 1]) - uy_g))
    return np.array(errs)


def test_bar_row_float32_margin_half_through_step_100_on_the_cpu(tmp_path):
    """Each tip sample's error equals the JAX package's within a float32
    bar (1e-7 m; they differ by 2e-8 m here, in summation order), so a
    wrong tip, a late sample or a sign slip shows; the rows are made from
    them and the %-of-peak row is under the JAX tool's 1 %."""
    errs, clock = ga.bar_tip_errors("pallas_t", "cpu", last_step=100)
    want = _jax_bar_tip_errors(tmp_path, 100)
    assert clock.step == 100 and errs.shape == want.shape == (6,)
    np.testing.assert_allclose(errs, want, rtol=0, atol=1e-7)
    rows = ga.bar_rows(errs, clock)
    assert [r.name for r in rows] == ["bar tip (100 steps)",
                                      "bar tip %-of-peak"]
    abs_err, pct = rows
    assert abs_err.bar is None and pct.bar == 1.0
    assert abs_err.value == errs.max()
    assert pct.ok and 0.0 <= pct.value < 1.0, pct
    assert abs_err.ms_per_step > 0


@pytest.mark.parametrize("tool", ["golden_acceptance", "full_cases"])
def test_exits_1_without_a_gpu_and_without_device_cpu(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run on it")
    out = tmp_path / "runs"
    args = ["--out", str(out)] if tool == "full_cases" else []
    r = subprocess.run(
        [sys.executable, "-m", f"particlemethod_fsi_tpu_torch.tools.{tool}",
         *args], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stderr[-2000:]
    assert "no CUDA device" in r.stderr
    assert r.stdout == "" and not out.exists()
