"""The window-sweep kernels of this source tree against those of another
tree, on the card, in one process: bit for bit and in turns.

No counterpart in the JAX package.  Both libraries are built by
``ops/cuda_loader``: this tree's from its ``csrc/``, the other from the
``csrc/`` given by ``--other``.  The inputs are those of the two 1M scenes, the bench
scene (``build_case(1000)``) and the Turek channel (``build_turek(1e-3)``,
a ghost-extended frame), after a few steps, float32, one fresh frame as
the step builds it with its window table on each backend, and the fields
of phase 1 on that frame: the key rule's inputs for kernels 1-3
(``fsi_phase1_sweep``, also with the count, ``fsi_phase2_sweep``,
``fsi_virial_sweep``), the row rule's for kernels 4-6 (``fsi_phase1_rows``,
``fsi_phase2_rows``, ``fsi_virial_rows``).  Each kernel of each library runs on the same inputs;
the outputs are compared bit for bit and the times are taken in turns,
other, this, this, other, twice over: warm (mean of ``REPS`` back-to-back
launches by CUDA events) and cold (mean of ``COLD_REPS`` launches, each
after a write over a buffer larger than L2).  With ``--sass`` it also compares the two libraries'
machine code (``cuobjdump -sass``) function by function.  Prints one JSON
line, after the card's name and power limit.

    python -m particlemethod_fsi_tpu_torch.tools.window_ab --other DIR/csrc

``DIR`` is an unpacked copy of another revision of this package with the
same C interface (for example ``git archive`` of a parent commit).  Needs
one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from particlemethod_fsi_tpu_torch.ops import cuda_loader
from particlemethod_fsi_tpu_torch.ops import windows as pw
from particlemethod_fsi_tpu_torch.ops import windows_t as pwt

SCENES = ("bench", "turek")
N_SIDE = 1000  # the bench scene, 1,012,666 particles
TUREK_L0 = 1e-3  # the Turek channel, 1,040,000 particles
STEPS = 20     # steps run before the frame is taken
REPS = 50      # back-to-back launches a warm timing
COLD_REPS = 10  # launches a cold timing
L2_FLUSH_BYTES = 256 * 2**20  # larger than the card's L2 (50 MB on an H100)


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_ms_cold(fn, reps: int) -> float:
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def _calls():
    """name -> function of the kernels' launches on the scenes' inputs
    (``<scene>/<kernel>``)."""
    calls = {}
    for scene in SCENES:
        for backend in ("pallas_t", "pallas"):
            calls.update({f"{scene}/{k}": v
                          for k, v in _scene_calls(scene, backend).items()})
    return calls


def _scene_calls(scene: str, backend: str):
    """name -> function of the kernels' launches on one scene's frame on
    one backend."""
    from particlemethod_fsi_tpu_torch.models import build_case, build_turek
    from particlemethod_fsi_tpu_torch.ops.walls import periodic_wrap

    calls = {}
    sim = (build_case(N_SIDE, backend=backend) if scene == "bench"
           else build_turek(TUREK_L0, backend=backend))
    state = sim.run_chunk(sim.state0, STEPS)
    grid, ks, cfg, tables = (sim._frame_grid, sim.kernels, sim._pcfg,
                             sim.tables)
    pos = periodic_wrap(state.pos, sim._dmin_t, sim._width_t)
    frame = sim._frame(*sim._frame_inputs(pos, state.vel, state.prop)[0])
    win = pw.compute_windows(frame, grid, cfg)
    kw = dict(volume=sim.volume, two_dimensional=sim.cfg.two_dimensional)
    if backend == "pallas_t":
        offs, _ = pw.row_offsets(grid)
        f1 = pwt.phase1_fields_t(frame, grid, ks, tables, cfg=cfg,
                                 windows=win)
        a = (frame, f1["pressure_p"], f1["pressure_a"],
             f1["gravity_center"], pwt.inverse_viscosity(f1["mu"]), *win,
             offs, ks, cfg, tables)
        p1 = (frame, *win, offs, ks, cfg, tables)
        calls["phase1_sweep"] = lambda p1=p1, s=grid.support: (
            pwt.phase1_sweep(*p1, support=s))
        calls["phase1_sweep_count"] = lambda p1=p1, s=grid.support: (
            pwt.phase1_sweep(*p1, support=s, count=True))
        calls["phase2_sweep"] = lambda a=a, kw=kw: pwt.phase2_sweep(
            *a, **kw)
        calls["virial_sweep"] = lambda a=a, kw=kw: pwt.virial_sweep(
            *a, **kw)
    else:
        f1 = pw.phase1_fields(frame, grid, ks, tables, cfg=cfg,
                              windows=win)
        a = (frame, f1["pressure_p"], f1["pressure_a"],
             f1["gravity_center"].contiguous(), f1["mu"], *win, grid, ks,
             cfg, tables)
        calls["phase1_rows"] = lambda p1=(frame, *win, grid, ks, cfg,
                                          tables): pw.phase1_rows_sweep(*p1)
        calls["phase2_rows"] = lambda a=a, kw=kw: pw.phase2_rows_sweep(
            *a, **kw)
        calls["virial_rows"] = lambda a=a, kw=kw: pw.virial_rows_sweep(
            *a, **kw)
    return calls


def _compare_sass(this, other) -> dict:
    """For each kernel family (the source's template name), how many of its
    functions the two libraries compile to the same machine code."""
    a, b = cuda_loader.sass(this), cuda_loader.sass(other)
    out = {}
    for name in sorted(set(a) | set(b)):
        fam = re.sub(r"^_Z\d+", "", name).split("I")[0]
        st = out.setdefault(fam, {"same": 0, "differ": 0, "only_one": 0})
        if name not in a or name not in b:
            st["only_one"] += 1
        else:
            st["same" if a[name] == b[name] else "differ"] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="csrc/ directory of the other tree")
    ap.add_argument("--sass", action="store_true",
                    help="also compare the machine code function by function")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_ab: no CUDA device", file=sys.stderr)
        return 1
    this = cuda_loader.load()
    other = cuda_loader.build(args.other.resolve())
    result = {}
    for name, call in _calls().items():
        with cuda_loader.using(other):
            a = call()
        b = call()
        torch.cuda.synchronize()
        times = {"other": [], "this": []}
        cold = {"other": [], "this": []}
        for who in ("other", "this", "this", "other") * 2:
            with cuda_loader.using(other if who == "other" else this):
                times[who].append(_time_ms(call, REPS))
                cold[who].append(_time_ms_cold(call, COLD_REPS))
        result[name] = dict(
            bit_equal=bool(torch.equal(a, b)),
            max_abs_diff=float((a.double() - b.double()).abs().max()),
            ms_other=times["other"], ms_this=times["this"],
            speedup=(sum(times["other"]) / sum(times["this"])),
            cold_ms_other=cold["other"], cold_ms_this=cold["this"],
            cold_speedup=(sum(cold["other"]) / sum(cold["this"])))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    line = {"n_side": N_SIDE, "steps": STEPS, "reps": REPS,
            "other": str(args.other), "kernels": result}
    if args.sass:
        line["sass"] = _compare_sass(this, other)
    print(card)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
