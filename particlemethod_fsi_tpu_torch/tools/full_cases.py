"""Full-schedule runs of the shipped cases through the port's command line.

Counterpart of the repository's ``tools/run_full_cases.sh``: the dam break
to EndTime 1.0 (10,000 steps), the coupled gate to 0.5 (5,000), the bar as
shipped (``--apply-velocity-profile``: the reference binary itself diverges
between steps 460 and 480, so the run must end in the watchdog's exit code
2) and the bar's stable run (``--no-double-substep --bar-amplitude 0.002``)
to 0.3 s (3,000 steps).

    python -m particlemethod_fsi_tpu_torch.tools.full_cases --out DIR \\
        [--runs dam gate bar bar_stable] [--device cpu] [--end-time T]

Each run copies its case's ``.boid`` and ``.data`` into ``DIR/<run>/``
(never into ``cases/``), makes the grid with the port's generator and runs
``python -m particlemethod_fsi_tpu_torch.cli`` there in a subprocess with
the flags of the case's ``execute.sh`` (:func:`script_flags`), a timeout,
and no ``--backend`` (so ``auto``, the field-major window sweep), on the
GPU unless ``--device cpu`` (without a GPU it exits 1 before any run).  For
each run it prints the exit code against the one expected, the steps, the
files, the ms/step of the stepping (the metrics' chunk clocks), the seconds
an output interval, the ``case_summary`` table and, beside it, the JAX
package's committed metrics at the same steps (physics columns only: they
were taken on a TPU, and the fluid cases are chaotic after the impact, so
they get no bar).  A wrong exit code, a missing file, a non-finite position
in the last ``.prof`` or ``.vtk``, or a watchdog outside its window fails
the run, and the command exits 1.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np

from particlemethod_fsi_tpu_torch.tools import case_summary

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CASES_DIR = os.path.join(REPO, "cases")


def script_flags(case_dir: str) -> tuple:
    """The solver's arguments in ``cases/<case_dir>/execute.sh``: its one
    ``python -m <cli>`` line less the module and the trailing ``"$@"``."""
    with open(os.path.join(CASES_DIR, case_dir, "execute.sh")) as f:
        lines = [s for s in f if s.startswith("python -m ")]
    toks = shlex.split(lines[0]) if len(lines) == 1 else []
    if (toks[:3] != ["python", "-m", "particlemethod_fsi_tpu.cli"]
            or toks[-1:] != ["$@"]):
        raise ValueError(f"cases/{case_dir}/execute.sh: not one solver "
                         f"command line")
    return tuple(toks[3:-1])


class Run(NamedTuple):
    case_dir: str
    extra: tuple  # flags after the script's own
    rc: int  # the exit code the run must give
    jax_metrics: Optional[str]  # the JAX package's, under cases/
    every: int  # case_summary's every_k
    watchdog: Optional[tuple] = None  # (lo, hi) of the first WATCHDOG's t


RUNS = {
    "dam": Run("dam", (), 0, "dam/dam_metrics.jsonl", 10),
    "gate": Run("fsi_gate", (), 0, "fsi_gate/gate_metrics.jsonl", 10),
    # steps 440-500 (the JAX run's first watchdog: t = 0.048)
    "bar": Run("bar", (), 2, None, 10, (0.044, 0.050)),
    "bar_stable": Run("bar", ("--no-double-substep", "--bar-amplitude",
                              "0.002"), 0,
                      "bar/bar_stable_metrics.committed.jsonl", 30),
}
TIMEOUT = 1800.0  # seconds a run may take


class Result(NamedTuple):
    name: str
    rc: Optional[int]  # None: the run timed out
    problems: tuple  # empty: the run is as it must be
    report: str

    @property
    def ok(self) -> bool:
        return not self.problems


def _seq_files(directory: str, pattern: str) -> list:
    """The files of a printf pattern like ``dam%03d.vtk``, by number."""
    head, tail = pattern.split("%03d")
    found = []
    for path in glob.glob(os.path.join(directory, head + "*" + tail)):
        num = os.path.basename(path)[len(head):-len(tail)]
        if num.isdigit():
            found.append((int(num), path))
    return [p for _, p in sorted(found)]


def _vtk_points(path: str) -> np.ndarray:
    with open(path) as f:
        for line in f:
            if line.startswith("POINTS"):
                n = int(line.split()[1])
                return np.loadtxt(f, max_rows=n, ndmin=2)
    return np.zeros((0, 3))


def _first_watchdog(log_path: str) -> Optional[float]:
    """The time the log's first ``WATCHDOG:`` line names."""
    with open(log_path) as f:
        for line in f:
            if line.startswith("WATCHDOG:"):
                m = re.search(r"at t=(\S+)", line)
                return float(m.group(1)) if m else math.nan
    return None


def _outputs(want: float, interval: float) -> int:
    """Dumps of an output interval from t = 0 through ``want``."""
    return int(math.floor(want / interval + 1e-6)) + 1


def _beside(rows: list, every: int, jax_path: Optional[str]) -> str:
    """The JAX package's committed metrics at the steps of the summary's
    rows, and the port's wall seconds since the row above."""
    jax = {}
    if jax_path:
        jax = {m["step"]: m for m in case_summary.output_rows(
            os.path.join(CASES_DIR, jax_path))}
    lines = ["JAX package's committed metrics at the same steps ("
             + (f"cases/{jax_path}; taken on a TPU, physics columns, no bar"
                if jax_path else "none committed for this run")
             + "), and the port's wall seconds since the row above:",
             "| step | max speed [m/s] | KE [J] | px [kg m/s] | py [kg m/s] "
             "| port s |", "|---|---|---|---|---|---|"]
    last = None
    for m in case_summary.picks(rows, every):
        j = jax.get(m["step"])
        cols = (f"{j['max_speed']:.4f} | {j['kinetic_energy']:.4e} | "
                f"{j['momentum_x']:+.3e} | {j['momentum_y']:+.3e}" if j
                else "- | - | - | -")
        since = "-" if last is None else f"{m['wall_time'] - last:.3f}"
        lines.append(f"| {m['step']} | {cols} | {since} |")
        last = m["wall_time"]
    return "\n".join(lines) + "\n"


def run_case(name: str, out_dir: str, device: Optional[str] = None,
             end_time: Optional[float] = None) -> Result:
    """One run of :data:`RUNS` in ``out_dir/<name>``: set-up, the command
    line in a subprocess, and the checks of what it left."""
    from particlemethod_fsi_tpu_torch.generator import generate_case
    from particlemethod_fsi_tpu_torch.io.data_file import parse_data_file
    from particlemethod_fsi_tpu_torch.io.grid_file import read_grid_file

    run = RUNS[name]
    flags = script_flags(run.case_dir)
    data, grid, prof, vtk, log = flags[:5]
    metrics = flags[flags.index("--metrics") + 1]
    stem = grid[:-len(".grid")]
    work = os.path.join(out_dir, name)
    os.makedirs(work, exist_ok=True)
    for f in (stem + ".boid", data):
        shutil.copy(os.path.join(CASES_DIR, run.case_dir, f), work)
    generate_case(os.path.join(work, stem))
    cmd = [sys.executable, "-m", "particlemethod_fsi_tpu_torch.cli", *flags,
           *run.extra]
    if device:
        cmd += ["--device", device]
    if end_time is not None:
        cmd += ["--end-time", repr(end_time)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    problems = []
    t0 = time.time()
    with open(os.path.join(work, "run.out"), "w") as out:
        try:
            rc = subprocess.run(cmd, cwd=work, stdout=out,
                                stderr=subprocess.STDOUT, env=env,
                                timeout=TIMEOUT).returncode
        except subprocess.TimeoutExpired:
            rc = None
            problems.append(f"timed out after {TIMEOUT:g} s")
    seconds = time.time() - t0
    if rc is not None and rc != run.rc:
        problems.append(f"exit code {rc}, expected {run.rc}")

    cfg = parse_data_file(os.path.join(work, data))
    end = cfg.end_time if end_time is None else end_time
    vtks = _seq_files(work, vtk)
    profs = _seq_files(work, prof)
    lines = []
    mpath = os.path.join(work, metrics)
    if os.path.exists(mpath):
        with open(mpath) as f:
            lines = [json.loads(s) for s in f]
    chunks = [m for m in lines if "chunk" in m]
    rows = [m for m in lines if "kinetic_energy" in m]
    steps = sum(m["chunk"] for m in chunks)
    if run.rc == 0:
        want_vtk = _outputs(end, cfg.vtk_output_interval)
        want_prof = _outputs(end, cfg.output_interval)
        if (len(vtks), len(profs)) != (want_vtk, want_prof):
            problems.append(f"{len(vtks)} .vtk and {len(profs)} .prof, "
                            f"expected {want_vtk} and {want_prof}")
        if not chunks or chunks[-1]["time"] < end - 0.5 * cfg.dt:
            problems.append(f"stopped short of t={end:g}")
    wd = None
    if os.path.exists(os.path.join(work, log)):
        wd = _first_watchdog(os.path.join(work, log))
    else:
        problems.append(f"no {log}")
    if run.watchdog is not None:
        lo, hi = run.watchdog
        if wd is None or not lo <= wd <= hi:
            problems.append(f"first WATCHDOG at t={wd}, expected within "
                            f"[{lo:g}, {hi:g}]")
    elif wd is not None:
        problems.append(f"WATCHDOG at t={wd:g}")
    if not vtks or not profs or not rows:
        problems.append("no .vtk, .prof or metrics row was written")
    else:
        last = read_grid_file(profs[-1])
        if not (np.isfinite(last.position).all()
                and np.isfinite(_vtk_points(vtks[-1])).all()):
            problems.append("non-finite positions in the last .prof or .vtk")

    step_s = sum(m["chunk_seconds"] for m in chunks)
    per_interval = ((rows[-1]["wall_time"] - rows[0]["wall_time"])
                    / (len(rows) - 1) if len(rows) > 1 else math.nan)
    head = (f"== {name} (cases/{run.case_dir}, flags of its execute.sh"
            + (" + " + " ".join(run.extra) if run.extra else "")
            + f"): exit code {rc} (expected {run.rc}), {steps} steps, "
            f"{len(vtks)} .vtk, {len(profs)} .prof, {seconds:.1f} s; "
            f"ms/step {1e3 * step_s / max(steps, 1):.3f} (stepping, the "
            f"chunk clocks), {per_interval:.3f} s an output interval (wall)"
            + (f"; first WATCHDOG at t={wd:g}" if wd is not None else "")
            + ("; " + "; ".join(problems) if problems else "; ok"))
    report = head + "\n"
    if rows:
        report += (case_summary.summary(mpath, run.every)
                   + _beside(rows, run.every, run.jax_metrics))
    return Result(name, rc, tuple(problems), report)


def main(argv=None) -> int:
    from particlemethod_fsi_tpu_torch.solver import resolve_device

    ap = argparse.ArgumentParser(
        prog="full_cases",
        description="the shipped cases for their full schedules through "
                    "the port's command line")
    ap.add_argument("--out", default=None,
                    help="directory for the runs (default: a new "
                         "temporary one, kept)")
    ap.add_argument("--runs", nargs="+", default=list(RUNS), choices=RUNS)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the GPU; without one, exit 1")
    ap.add_argument("--end-time", type=float, default=None,
                    help="stop every run here instead of the .data's EndTime")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"full_cases: {e}", file=sys.stderr)
        return 1
    out = args.out or tempfile.mkdtemp(prefix="fsi_full_cases_")
    print(f"# runs in {out}", flush=True)
    ok = True
    for name in args.runs:
        res = run_case(name, out, args.device, args.end_time)
        print(res.report, flush=True)
        ok &= res.ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
