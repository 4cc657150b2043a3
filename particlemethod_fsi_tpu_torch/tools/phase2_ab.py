"""The phase-2 kernels of this source tree against those of another, on the
card, in one process: bit for bit and in turns.

No counterpart in the JAX package.  Both libraries are built from their
``csrc/`` directories by ``ops/cuda_loader``; the inputs are the
1M-particle bench scene's (``build_case(1000)``) after a few steps, float32,
one fresh frame with its window table, and the phase-2 fields of phase 1 on
that frame: the key rule's inputs for kernel 2 (``fsi_phase2_sweep``), the
row rule's for kernel 5 (``fsi_phase2_rows``).  Each kernel of each library
runs on the same inputs; the outputs are compared bit for bit and the warm
times (mean of ``REPS`` back-to-back launches by CUDA events) are taken in
turns, other, this, this, other, twice over.  Kernels 1 and 3 of both
libraries are compared and timed the same way, as a control.  Prints one
JSON line, after the card's name and power limit.

    python -m particlemethod_fsi_tpu_torch.tools.phase2_ab --other DIR/csrc

``DIR`` is an unpacked copy of another revision of this package with the
same C interface (for example ``git archive`` of a parent commit).  Needs
one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from particlemethod_fsi_tpu_torch.ops import cuda_loader
from particlemethod_fsi_tpu_torch.ops import windows as pw
from particlemethod_fsi_tpu_torch.ops import windows_t as pwt

N_SIDE = 1000  # the bench scene, 1,012,666 particles
STEPS = 20     # steps run before the frame is taken
REPS = 50      # back-to-back launches a warm timing


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


def _calls():
    """name -> function of the kernels' launches on the scene's inputs."""
    from particlemethod_fsi_tpu_torch.models import build_case
    from particlemethod_fsi_tpu_torch.ops import packed_engine as pk

    calls = {}
    for backend in ("pallas_t", "pallas"):
        sim = build_case(N_SIDE, backend=backend)
        state = sim.run_chunk(sim.state0, STEPS)
        grid, ks, cfg, tables = (sim._frame_grid, sim.kernels, sim._pcfg,
                                 sim.tables)
        frame = pk.sort_frame(state.pos, state.vel, state.prop, grid)
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
            calls["phase2_rows"] = lambda a=a, kw=kw: pw.phase2_rows_sweep(
                *a, **kw)
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="csrc/ directory of the other source tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase2_ab: no CUDA device", file=sys.stderr)
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
        for who in ("other", "this", "this", "other") * 2:
            with cuda_loader.using(other if who == "other" else this):
                times[who].append(_time_ms(call, REPS))
        result[name] = dict(
            bit_equal=bool(torch.equal(a, b)),
            max_abs_diff=float((a.double() - b.double()).abs().max()),
            ms_other=times["other"], ms_this=times["this"],
            speedup=(sum(times["other"]) / sum(times["this"])))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"n_side": N_SIDE, "steps": STEPS, "reps": REPS,
                      "kernels": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
