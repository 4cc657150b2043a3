"""Golden acceptance of the production path: float32, the case scripts'
rebuild margin, the window sweeps on the card, against the trajectories the
reference binary wrote (``goldens/``, provenance in ``goldens/README.md``).

Counterpart of the repository's ``tools/golden_acceptance.py``.  The float64
golden checks (``tests/test_torch_golden.py`` on the CPU, the float64 golden
lines of ``chip_smoke.py`` on the card) hold the physics; this holds what a
user ships: float32, C8 frame reuse at ``rebuild_margin=0.5`` as
``cases/*/execute.sh`` run it (1.0 for the Turek channel, as its script
does), hundreds to thousands of steps.

    python -m particlemethod_fsi_tpu_torch.tools.golden_acceptance \\
        [--backend pallas_t|pallas] [--device cpu] [--cases dam bar ...]

runs on the GPU unless ``--device cpu`` is given (without a GPU it exits 1
before any step), prints one row per check -- the check, its value, the
unit, the case's ms/step so far (host clock around chunks that end in a
sync) and, for a row with a bar, PASS or FAIL -- and exits 1 if a barred
row fails.  Rows past the chaos horizon (``goldens/README.md``) are printed
without a bar.

Each grid comes from the case's committed ``.boid`` through the port's
generator (into a temporary directory); the Turek channel's from
:func:`~particlemethod_fsi_tpu_torch.models.turek.turek_grid` at 5 mm, the
44,000 rows of ``cases/turek/generate.py`` in its order.  Each case reads
the golden's own ``.data``.  The bars: the JAX tool's (dam 5.0e-5 m at step
100 and 5.0e-4 m at 1,000, the bar's tip within 1 % of its peak through
step 460), and for the other goldens 10x the bar of the JAX package's
float64 test at the same horizon (``tests/test_golden.py``), the rule the
JAX tool used for dam@1000.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import os
import shutil
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from particlemethod_fsi_tpu_torch.config import NumericsConfig

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
GOLD = os.path.join(REPO, "goldens")
CASES_DIR = os.path.join(REPO, "cases")

BACKENDS = ("pallas_t", "pallas")
# the C8 margin of cases/*/execute.sh; the Turek channel's script runs 1.0
MARGIN, TUREK_MARGIN = 0.5, 1.0
TUREK_L0 = 5e-3
BAR_CHUNK = 20  # steps between the bar's tip samples (and their divisor)
BAR_LAST_STEP = 460  # the reference binary diverges between 460 and 480


class Row(NamedTuple):
    """One printed check: ``bar`` None means printed without a bar."""

    name: str
    value: float
    unit: str
    bar: Optional[float]
    ms_per_step: float

    @property
    def ok(self) -> bool:
        return self.bar is None or bool(self.value < self.bar)


class Check(NamedTuple):
    """Rows of one golden at one step: ``(label, selection, bar)`` each."""

    step: int
    rows: tuple


class Case(NamedTuple):
    case_dir: str  # cases/<case_dir>/<grid>.boid (None: the Turek channel)
    grid: str
    gold_dir: str  # goldens/<gold_dir>/<data>, goldens/<gold_dir>/<pattern>
    data: str
    scene: str
    pattern: str  # the golden's file name at a step
    chunk: int  # uniform chunk length; divides every step of ``checks``
    checks: tuple
    margin: float = MARGIN  # the C8 margin of the case's execute.sh
    min_image: bool = False  # differences by the minimum image along x


# row selections by the golden's type column (tests/test_golden.py)
ALL, WALL, STRUCTURE, FLUID = "all", "wall", "structure", "fluid"

CASES = {
    "dam": Case("dam", "dam", "dam", "dam.data", "dam", "dam%d.prof.gz", 100,
                (Check(100, (("", ALL, 5.0e-5),)),
                 Check(1000, (("", ALL, 5.0e-4),)))),
    "gate": Case("fsi_gate", "gate", "gate", "gate.data", "dam",
                 "gate%d.prof.gz", 100,
                 (Check(100, (("", ALL, 2.0e-5),)),
                  Check(200, (("", ALL, None),)),
                  Check(1000, (("", ALL, None),)))),
    "rolling1": Case("rolling", "rolling", "rolling1", "r1f.data", "rolling1",
                     "r1f_%04d.prof.gz", 100,
                     (Check(100, (("", ALL, 2.0e-5),)),)),
    "rolling": Case("rolling", "rolling", "rolling", "rolling.data", "rolling",
                    "rolling%04d.prof.gz", 100,
                    (Check(500, (("", ALL, 2.0e-4), ("wall", WALL, 2.0e-4))),
                     Check(1000, (("", ALL, None), ("wall", WALL, None))))),
    "hydro": Case("hydroelastic", "hydro", "hydro", "hydro.data",
                  "hydroelastic", "hydro%04d.prof.gz", 100,
                  (Check(200, (("", ALL, 5.0e-4),
                               ("structure", STRUCTURE, 1.0e-4))),
                   Check(1000, (("", ALL, None),
                                ("structure", STRUCTURE, None))))),
    "turek": Case(None, "turek", "turek", "turek.data", "turek_hron",
                  "turek%04d.prof.gz", 100,
                  (Check(100, (("structure", STRUCTURE, 5.0e-5),
                               ("fluid", FLUID, 2.0e-3))),
                   Check(500, (("structure", STRUCTURE, None),
                               ("fluid", FLUID, None)))),
                  margin=TUREK_MARGIN, min_image=True),
}
# the order rows are printed in: the JAX tool's cases first
ORDER = ("dam", "bar", "gate", "rolling1", "rolling", "hydro", "turek")


def production_numerics(backend: str) -> NumericsConfig:
    """What ``cases/dam/execute.sh`` resolves to (the JAX tool's
    ``production_numerics``): float32, the C8 margin 0.5."""
    return NumericsConfig(backend=backend, rebuild_margin=MARGIN)


def load_golden(path):
    """``(time, rows)`` of a gzipped ``.prof`` written by the reference."""
    with gzip.open(path, "rt") as f:
        t = float(f.readline())
        f.readline()
        rows = np.loadtxt(f)
    return t, rows


def select(gold_type, which: str) -> np.ndarray:
    """Rows of a golden by its type column: every row, the walls (type 4),
    the structure (types 2-3) or the fluid (types 0-1)."""
    typ = np.asarray(gold_type).astype(int)
    if which == ALL:
        return np.ones(typ.shape, bool)
    if which == WALL:
        return typ == 4
    if which == STRUCTURE:
        return (typ >= 2) & (typ < 4)
    if which == FLUID:
        return typ < 2
    raise ValueError(f"unknown row selection {which!r}")


def max_dpos(pos, gold, rows=None, width_x: Optional[float] = None) -> float:
    """Largest |x|, |y| difference of ``pos`` (``[N, 3]``, the golden's row
    order) from the golden's position columns over ``rows`` (all when
    None); with ``width_x``, the minimum image along the periodic x axis."""
    d = np.asarray(pos)[:, :2] - gold[:, 1:3]
    if width_x is not None:
        d[:, 0] -= np.round(d[:, 0] / width_x) * width_x
    if rows is not None:
        d = d[rows]
    return float(np.abs(d).max())


def case_simulation(tmp: str, case_dir: Optional[str], grid: str, data: str,
                    scene: str, numerics: NumericsConfig, device=None):
    """``(Simulation, GridData)``: the grid of ``cases/<case_dir>/<grid>.boid``
    through the port's generator into ``tmp`` (the Turek channel at 5 mm
    where ``case_dir`` is None), the physics of ``data`` (a path), the scene
    module ``scene``, on ``device`` (the card unless ``"cpu"``)."""
    from particlemethod_fsi_tpu_torch.generator import generate_case
    from particlemethod_fsi_tpu_torch.io.grid_file import write_grid_file
    from particlemethod_fsi_tpu_torch.models.turek import turek_grid
    from particlemethod_fsi_tpu_torch.solver import Simulation, load_case

    path = os.path.join(tmp, grid)
    if not os.path.exists(path + ".grid"):
        if case_dir is None:
            write_grid_file(turek_grid(TUREK_L0), path + ".grid")
        else:
            shutil.copy(os.path.join(CASES_DIR, case_dir, grid + ".boid"), tmp)
            generate_case(path)
    cfg, gd = load_case(data, path + ".grid", scene=scene, numerics=numerics)
    return Simulation(cfg, gd, device=device), gd


class _Clock:
    """Steps a state in chunks, timing each by the host clock around the
    chunk and a sync: ``ms_per_step`` over the steps so far."""

    def __init__(self, sim, state):
        self.sim, self.state = sim, state
        self.step, self.seconds = 0, 0.0

    def run_to(self, target: int, chunk: int):
        sync = (torch.cuda.synchronize if self.sim.device.type == "cuda"
                else (lambda: None))
        while self.step < target:
            n = min(chunk, target - self.step)
            t0 = time.perf_counter()
            self.state = self.sim.run_chunk(self.state, n)
            sync()
            self.seconds += time.perf_counter() - t0
            self.step += n
        return self.state

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.seconds / max(self.step, 1)


def case_rows(name: str, backend: str, device=None):
    """The rows of one golden case (not the bar) on ``backend``, and the
    steps it took."""
    from particlemethod_fsi_tpu_torch.state import to_numpy

    case = CASES[name]
    numerics = dataclasses.replace(production_numerics(backend),
                                   rebuild_margin=case.margin)
    with tempfile.TemporaryDirectory(prefix="fsi_accept_") as tmp:
        sim, _ = case_simulation(
            tmp, case.case_dir, case.grid,
            os.path.join(GOLD, case.gold_dir, case.data), case.scene,
            numerics, device)
    width = float(sim.domain_width[0]) if case.min_image else None
    clock, rows = _Clock(sim, sim.state0), []
    for check in case.checks:
        out = to_numpy(clock.run_to(check.step, case.chunk), sim.n)
        _, gold = load_golden(os.path.join(GOLD, case.gold_dir,
                                           case.pattern % check.step))
        for label, which, bar in check.rows:
            value = max_dpos(out["pos"], gold, select(gold[:, 0], which),
                             width)
            rows.append(Row(f"{name}@{check.step}" + (f" {label}" if label
                                                      else ""),
                            value, "m max|dpos|", bar, clock.ms_per_step))
    return rows, clock.step


def bar_tip_errors(backend: str, device=None,
                   last_step: int = BAR_LAST_STEP):
    """The bar excited in its first bending mode: its tip's |error| in m
    against ``goldens/bar/tip_trajectory.csv`` at every row of the file
    through ``last_step``, and the :class:`_Clock` that stepped it."""
    from particlemethod_fsi_tpu_torch.state import to_numpy

    with tempfile.TemporaryDirectory(prefix="fsi_accept_") as tmp:
        sim, gd = case_simulation(
            tmp, "bar", "bar", os.path.join(GOLD, "bar", "bar.data"), "bar",
            production_numerics(backend), device)
    x0 = np.asarray(gd.initial_position)
    tip = int(np.argmax(x0[:, 0]))
    clock = _Clock(sim, sim.apply_initial_velocity_profile(sim.state0))
    errs = []
    for t_g, uy_g in zip(*_tip_trajectory()):
        target = int(round(t_g / sim.cfg.dt))
        if target > last_step:
            break
        out = to_numpy(clock.run_to(target, BAR_CHUNK), sim.n)
        errs.append(abs(float(out["pos"][tip, 1] - x0[tip, 1]) - uy_g))
    return np.array(errs), clock


def _tip_trajectory():
    """``(time, uy)`` of the reference binary's tip samples."""
    gold = np.genfromtxt(os.path.join(GOLD, "bar", "tip_trajectory.csv"),
                         delimiter=",", names=True)
    return gold["time"], gold["uy"]


def bar_rows(errs, clock) -> list:
    """The bar's two rows from :func:`bar_tip_errors`: the largest error in
    m (no bar) and in % of the trajectory's peak (bar 1 %)."""
    peak = float(np.abs(_tip_trajectory()[1]).max())
    return [Row(f"bar tip ({clock.step} steps)", float(errs.max()),
                "m abs err", None, clock.ms_per_step),
            Row("bar tip %-of-peak", 100.0 * float(errs.max()) / peak, "%",
                1.0, clock.ms_per_step)]


def run_acceptance(backend: str, device=None, cases=ORDER, emit=None):
    """Every row of ``cases`` (in :data:`ORDER`) on ``backend``, and the
    steps taken in all; each case's rows also go to ``emit`` as it ends."""
    rows, steps = [], 0
    for name in ORDER:
        if name not in cases:
            continue
        if name == "bar":
            errs, clock = bar_tip_errors(backend, device)
            made, n = bar_rows(errs, clock), clock.step
        else:
            made, n = case_rows(name, backend, device)
        rows += made
        steps += n
        if emit:
            for row in made:
                emit(row)
    return rows, steps


def format_row(row: Row) -> str:
    verdict = ""
    if row.bar is not None:
        verdict = "PASS" if row.ok else f"FAIL (bar {row.bar:g})"
    return (f"{row.name:26s} {row.value:12.4e} {row.unit:12s} "
            f"{row.ms_per_step:9.3f} ms/step  {verdict}").rstrip()


def main(argv=None) -> int:
    from particlemethod_fsi_tpu_torch.solver import resolve_device

    ap = argparse.ArgumentParser(
        prog="golden_acceptance",
        description="the float32 production path against the reference "
                    "binary's goldens")
    ap.add_argument("--backend", default="pallas_t", choices=BACKENDS)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the GPU; without one, exit 1")
    ap.add_argument("--cases", nargs="+", default=list(ORDER), choices=ORDER)
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"golden_acceptance: {e}", file=sys.stderr)
        return 1
    kind = device.type
    if kind == "cuda":
        from particlemethod_fsi_tpu_torch.ops import cuda_loader

        t0 = time.time()
        cuda_loader.load()
        kind = (f"cuda ({torch.cuda.get_device_name(device)}; kernels "
                f"built or loaded in {time.time() - t0:.1f} s)")
    print(f"# device={kind} backend={args.backend} dtype=float32 "
          f"rebuild_margin={MARGIN} (turek {TUREK_MARGIN}), as "
          f"cases/*/execute.sh run", flush=True)
    rows, _ = run_acceptance(args.backend, device, args.cases,
                             emit=lambda r: print(format_row(r), flush=True))
    return 0 if all(r.ok for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
