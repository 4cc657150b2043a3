#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc`` and fails (exit code != 0) without
them; it never runs on the CPU.  Phases, each failing the run on its first
fault:

1. the card: name and power limit as ``nvidia-smi`` gives them;
2. build: the CUDA kernels under ``particlemethod_fsi_tpu_torch/csrc/`` are
   compiled from source (seconds printed as set-up);
3. kernels: each hand-written kernel (phase 1, phase 2 and virial sweeps)
   against its plain PyTorch version on the card -- (a) the ``double``
   instances on small seeded frames for every specialization branch, rtol
   1e-12; (b) the ``float`` instances on the 1M-particle main-path frame,
   where the kernel must lie as close to a float64 evaluation as the plain
   float32 version does; both timed, the kernel with its inputs warm in L2
   (back-to-back launches) and cold (L2 flushed before every launch);
4. a small coupled scene in float64, card (kernels) against CPU (plain
   versions), ten steps; and the gate case (6,724 particles, float64, 100
   steps through ``load_case``) against the reference binary's golden;
5. the step path: the coupled dam break on an elastic bar at
   ``n_side=1000`` (1,012,666 particles), float32, a warm-up chunk and three
   timed chunks of 20 steps through ``Simulation.run_chunk``; finite
   positions, launch counts equal to the steps taken, rebuild count, ms/step,
   and where the step's time goes from CUDA events; then guarded against
   unguarded chunks and the split of one ``diagnostics`` call;
6. the command-line path: the same scene written as ``.data`` and ``.grid``
   into a temporary directory, ``cli.main`` in process on the card for one
   output interval with the watchdog on; two ``.prof``, two ``.vtk`` with
   virial pressure, log and metrics written, read back and checked; launch
   counts of all three kernels; seconds of the writers and readers.

``python3 chip_smoke.py --kernels-only`` stops after phase 3a (build, register
counts, double instances): the short first run of a new kernel.

Output: one line per phase, then a ``{"kernels": [...]}`` JSON line, then as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N_SIDE = 1000
CHUNK = 20
TIMED_CHUNKS = 3
CLI_STEPS = 20  # steps of the command-line phase's one output interval

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12
# float operations the main-path pair math needs for one pair inside the
# kernel radius (planar, no surface tension, uniform radii), counted from
# the formulas: separation and rij2 (5), rsqrt, r, q, 1-q (4); phase 1 adds
# the wp sum (2) and the divergence (9); phase 2 adds the unit vector (2),
# the pressure term (5), the viscosity term (14) and the force sums (4); the
# virial adds the unit vector (2), the pressure term with P_i alone (3), the
# half-weighted viscosity term with its finite test folded in (15), the force
# components (2) and the four products and sums of the outer product (8)
PHASE1_FLOP_PER_PAIR = 20
PHASE2_FLOP_PER_PAIR = 34
VIRIAL_FLOP_PER_PAIR = 39
# bytes a particle that the function needs at the main path's flags (planar,
# no surface tension, uniform ratios and radii, no count), float32.  Phase 1
# reads x, y, vx, vy and the key and writes the wp sum and the divergence;
# the density-A, gravity-centre and count rows are zero there and z, vz are
# never used.  Phase 2 reads x, y, vx, vy, pressure P, 1/mu, key and type and
# writes fx, fy.  The virial reads x, y, vx, vy, pressure P, 1/mu and the key
# and writes the four in-plane components.  (The kernels as written move
# more: pos and vel are staged as [N,3] rows and every output row is written.)
PHASE1_BYTES_PER_PARTICLE = 5 * 4 + 2 * 4
PHASE2_BYTES_PER_PARTICLE = 8 * 4 + 2 * 4
VIRIAL_BYTES_PER_PARTICLE = 7 * 4 + 4 * 4
# larger than the card's L2 (50 MB on an H100): writing it evicts the inputs
L2_FLUSH_BYTES = 256 * 2**20


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

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


def time_ms_cold(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, each after a write
    over a buffer larger than L2, so that the inputs come from device
    memory.  Only ``fn()`` lies between a call's two events."""
    import torch

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


# ---------------------------------------------------------------------------
# phase 3a: double instances on small seeded frames, every branch
# ---------------------------------------------------------------------------

_RATIO = [[1.0] * 6 for _ in range(6)]
_RATIO[1][4] = 0.5
_RATIO[4][1] = 0.8
_SURFACE = dict(surface_tension=(0.05, 0.05, 0.0, 0.0, 0.05, 0.0))
_ASYM = dict(interaction_ratio=tuple(tuple(r) for r in _RATIO))

SMALL_CASES = {
    # name: (three_d, config changes, count)
    "main_path_flags": (False, {}, False),
    "main_path_flags+count": (False, {}, True),
    "surface_tension+ratios": (False, {**_SURFACE, **_ASYM}, False),
    "surface_tension+uniform_ratio": (False, _SURFACE, False),
    "nonuniform_radii+count": (False, {**_SURFACE, **_ASYM,
                                       "radius_ratio_a": 2.1,
                                       "radius_ratio_v": 2.3}, True),
    "3d": (True, {}, True),
    "3d+surface_tension+ratios": (True, {**_SURFACE, **_ASYM}, False),
    "3d+nonuniform_radii": (True, {**_SURFACE, **_ASYM, "radius_ratio_a": 2.2,
                                   "radius_ratio_v": 2.4}, False),
}


def small_case(name: str, device):
    """A small seeded frame with its statics and seeded phase-2 inputs."""
    import torch
    from particlemethod_fsi_tpu_torch.generator import (
        BoidScene, Primitive, generate_grid)
    from particlemethod_fsi_tpu_torch.models import bench_config, bench_grid
    from particlemethod_fsi_tpu_torch.ops import packed_engine as pk
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.ops.fluid import TypeTables
    from particlemethod_fsi_tpu_torch.ops.neighbors import build_cell_grid
    from particlemethod_fsi_tpu_torch.ops.smoothing import build_kernels
    from particlemethod_fsi_tpu_torch.solver import (
        adjust_domain, make_window_config)
    from particlemethod_fsi_tpu_torch.state import make_state

    three_d, changes, count = SMALL_CASES[name]
    l0 = 1e-3
    if three_d:
        grid = generate_grid(BoidScene(
            particle_distance=l0, lower_domain=(-3 * l0, 0.0, -3 * l0),
            upper_domain=(15 * l0, 20 * l0, 12 * l0),
            primitives=[
                Primitive("Cuboid", spacing=l0, type=1, lower=(0, 3 * l0, 0),
                          upper=(6 * l0, 11 * l0, 6 * l0)),
                Primitive("Cuboid", spacing=l0, type=2,
                          lower=(7 * l0, 3 * l0, 0),
                          upper=(9 * l0, 9 * l0, 6 * l0)),
                Primitive("Cuboid", spacing=l0, type=4,
                          lower=(-2 * l0, 0, -2 * l0),
                          upper=(12 * l0, 3 * l0, 10 * l0)),
            ]))
    else:
        grid = bench_grid(24)
    rng = np.random.default_rng(len(name))
    nd = 3 if three_d else 2
    free = grid.prop < 4
    grid.position[free, :nd] += rng.normal(scale=0.05 * l0,
                                           size=(int(free.sum()), nd))
    grid.velocity[:, :nd] = rng.normal(scale=0.05, size=(grid.n, nd))
    # an inviscid fluid type exercises mu == 0 -> 1/mu == inf -> mu_h == 0
    cfg = bench_config(dtype="float64", pallas_block=32).replace(
        two_dimensional=not three_d,
        shear_viscosity=(1e-2, 0.0, 1e-2, 1e-1, 1e3, 1e-1), **changes)
    ks = build_kernels(
        spacing=l0, radius_ratio_a=cfg.radius_ratio_a,
        radius_ratio_p=cfg.radius_ratio_p, radius_ratio_v=cfg.radius_ratio_v,
        surface_tension=cfg.surface_tension,
        two_dimensional=cfg.two_dimensional)
    dmin, dmax = adjust_domain(grid.domain_min, grid.domain_max, l0,
                               cfg.two_dimensional)
    cgrid = build_cell_grid(dmin, dmax, ks.support_radius + 0.5 * l0,
                            two_dimensional=cfg.two_dimensional)
    wcfg = make_window_config(cfg, ks, planar=not three_d)
    tables = TypeTables.from_config(cfg, ks, torch.float64, device)
    st = make_state(grid.prop, grid.position, grid.initial_position,
                    grid.velocity, dtype=torch.float64, device=device)
    frame = pk.sort_frame(st.pos, st.vel, st.prop, cgrid)
    win = pw.compute_windows(frame, cgrid, wcfg)
    n = frame.pos.shape[0]

    def seeded(scale, *shape):
        return torch.as_tensor(rng.normal(scale=scale, size=shape)).to(device)

    mu = tables.shear_viscosity[torch.clamp(frame.prop, 0, 5).long()]
    p2_inputs = dict(pp=seeded(1e2, n), pa=seeded(1e1, n),
                     gc=seeded(1e-3, n, 3), mu=mu)
    return frame, win, cgrid, ks, wcfg, tables, p2_inputs, count, cfg


def check_small_cases(device) -> dict:
    """Kernel (double) against plain version (double) on the card, for every
    branch.  Tolerance: rtol 1e-12 plus atol 1e-12 of the row's largest
    magnitude -- the two sum the same float64 terms in another order (the
    seeded inputs make the terms of a row comparable in size, so nothing
    cancels beyond that)."""
    import torch
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.ops import windows_t as pwt

    worst = {"phase1_sweep": 0.0, "phase2_sweep": 0.0, "virial_sweep": 0.0}

    def compare(kname, case, got, want):
        for r in range(want.shape[0]):
            scale = float(want[r].abs().max())
            err = float((got[r] - want[r]).abs().max())
            if scale > 0:
                worst[kname] = max(worst[kname], err / scale)
            ok = torch.allclose(got[r], want[r], rtol=1e-12,
                                atol=1e-12 * scale)
            if not ok:
                fail(f"{kname} double, case {case!r}, row {r}: max abs err "
                     f"{err:.3e} against scale {scale:.3e}")

    for case in SMALL_CASES:
        (frame, win, cgrid, ks, wcfg, tables, p2, count,
         cfg) = small_case(case, device)
        offs, _ = pw.row_offsets(cgrid)
        got1 = pwt.phase1_sweep(frame, *win, offs, ks, wcfg, tables,
                                support=cgrid.support, count=count)
        want1 = pwt.phase1_sweep_plain(frame, *win, offs, ks, wcfg, tables,
                                       support=cgrid.support, count=count)
        torch.cuda.synchronize()
        compare("phase1_sweep", case, got1, want1)
        live = [pwt.P1_WP, pwt.P1_DIV]
        if wcfg.surface_tension:
            live += [pwt.P1_DA, pwt.P1_GX, pwt.P1_GY]
        if count:
            live.append(pwt.P1_COUNT)
        if not wcfg.planar and wcfg.surface_tension:
            live.append(pwt.P1_GZ)
        for r in live:
            if not float(want1[r].abs().max()) > 0:
                fail(f"phase1_sweep case {case!r}: row {r} is all zero")

        invmu = pwt.inverse_viscosity(p2["mu"])
        args = (frame, p2["pp"], p2["pa"], p2["gc"], invmu, *win, offs, ks,
                wcfg, tables)
        kw = dict(volume=1e-3 ** (2 if cfg.two_dimensional else 3),
                  two_dimensional=cfg.two_dimensional)
        got2 = pwt.phase2_sweep(*args, **kw)
        want2 = pwt.phase2_sweep_plain(*args, **kw)
        torch.cuda.synchronize()
        compare("phase2_sweep", case, got2, want2)
        for r in range(2 if wcfg.planar else 3):
            if not float(want2[r].abs().max()) > 0:
                fail(f"phase2_sweep case {case!r}: row {r} is all zero")

        got3 = pwt.virial_sweep(*args, **kw)
        want3 = pwt.virial_sweep_plain(*args, **kw)
        torch.cuda.synchronize()
        compare("virial_sweep", case, got3, want3)
        for r in range(9):
            live = r in (0, 1, 3, 4) or not wcfg.planar
            if live != (float(want3[r].abs().max()) > 0):
                fail(f"virial_sweep case {case!r}: row {r} is "
                     f"{'all zero' if live else 'not zero'}")
    return worst


# ---------------------------------------------------------------------------
# phase 3b: float instances on the 1M main-path frame
# ---------------------------------------------------------------------------


def check_and_time_main_frame(sim, state) -> list:
    """The three kernels in float32 on the main path's own frame, against
    their plain versions, with times and the roofline bound."""
    import torch
    from particlemethod_fsi_tpu_torch.ops import packed_engine as pk
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.ops import windows_t as pwt
    from particlemethod_fsi_tpu_torch.ops.packed_engine import SortedFrame

    grid, ks, wcfg, tables = (sim._frame_grid, sim.kernels, sim._pcfg,
                              sim.tables)
    frame = pk.sort_frame(state.pos, state.vel, state.prop, grid)
    win = pw.compute_windows(frame, grid, wcfg)
    offs, _ = pw.row_offsets(grid)
    n = frame.pos.shape[0]
    frame64 = SortedFrame(key=frame.key, pos=frame.pos.double(),
                          vel=frame.vel.double(), prop=frame.prop,
                          orig=frame.orig)
    tables64 = type(tables).from_config(sim.cfg, ks, torch.float64, sim.device)

    def judge(kname, k32, p32, p64):
        """The float32 kernel must be as close to the float64 evaluation as
        the plain float32 version is (x8, plus 1e-6 of the row's scale):
        both round every term to float32 and sum some tens of them, in
        another order, with rsqrt approximated in float32."""
        worst = 0.0
        for r in range(p64.shape[0]):
            scale = float(p64[r].abs().max())
            err_k = float((k32[r].double() - p64[r]).abs().max())
            err_p = float((p32[r].double() - p64[r]).abs().max())
            worst = max(worst, float((k32[r] - p32[r]).abs().max()))
            if not err_k <= 8 * err_p + 1e-6 * scale:
                fail(f"{kname} float32 at 1M, row {r}: kernel is {err_k:.3e} "
                     f"from the float64 result, the plain version "
                     f"{err_p:.3e} (scale {scale:.3e})")
        return worst

    # true pairs inside the kernel radius, for the operations bound
    cnt = pwt.phase1_sweep(frame, *win, offs, ks, wcfg, tables,
                           support=ks.radius_p, count=True)[pwt.P1_COUNT]
    true_pairs = float(cnt.double().sum())
    tested_pairs = float(win[1].double().sum()) * wcfg.block
    table_bytes = (win[0].numel() + win[1].numel()) * 4
    rows = []

    # ---- phase 1
    p1 = dict(support=grid.support, count=False)
    k1 = pwt.phase1_sweep(frame, *win, offs, ks, wcfg, tables, **p1)
    pl1 = pwt.phase1_sweep_plain(frame, *win, offs, ks, wcfg, tables, **p1)
    plain1_ms = time_ms(lambda: pwt.phase1_sweep_plain(
        frame, *win, offs, ks, wcfg, tables, **p1), 2)
    pl1_64 = pwt.phase1_sweep_plain(frame64, *win, offs, ks, wcfg, tables64,
                                    **p1)
    err1 = judge("phase1_sweep", k1, pl1, pl1_64)

    def run1():
        return pwt.phase1_sweep(frame, *win, offs, ks, wcfg, tables, **p1)

    ms1, cold1 = time_ms(run1, 50), time_ms_cold(run1, 10)
    bytes1 = n * PHASE1_BYTES_PER_PARTICLE + table_bytes
    rows.append(_row("phase1_sweep", "phase1_sweep.cu",
                     "particlemethod_fsi_tpu/ops/pallas_windows_t.py:172",
                     err1, ms1, cold1, plain1_ms, bytes1,
                     true_pairs * PHASE1_FLOP_PER_PAIR))

    # ---- phase 2, on the fields of phase 1 + EOS
    f1 = pwt.phase1_fields_t(frame, grid, ks, tables, cfg=wcfg, windows=win)
    # the same float32-valued inputs for all three evaluations
    pp, pa, gc = f1["pressure_p"], f1["pressure_a"], f1["gravity_center"]
    invmu = pwt.inverse_viscosity(f1["mu"])
    kw = dict(volume=sim.volume, two_dimensional=sim.cfg.two_dimensional)
    a32 = (frame, pp, pa, gc, invmu, *win, offs, ks, wcfg, tables)
    a64 = (frame64, pp.double(), pa.double(), gc.double(), invmu.double(),
           *win, offs, ks, wcfg, tables64)
    k2 = pwt.phase2_sweep(*a32, **kw)
    pl2 = pwt.phase2_sweep_plain(*a32, **kw)
    plain2_ms = time_ms(lambda: pwt.phase2_sweep_plain(*a32, **kw), 2)
    pl2_64 = pwt.phase2_sweep_plain(*a64, **kw)
    err2 = judge("phase2_sweep", k2, pl2, pl2_64)

    def run2():
        return pwt.phase2_sweep(*a32, **kw)

    ms2, cold2 = time_ms(run2, 50), time_ms_cold(run2, 10)
    bytes2 = n * PHASE2_BYTES_PER_PARTICLE + table_bytes
    rows.append(_row("phase2_sweep", "phase2_sweep.cu",
                     "particlemethod_fsi_tpu/ops/pallas_windows_t.py:330",
                     err2, ms2, cold2, plain2_ms, bytes2,
                     true_pairs * PHASE2_FLOP_PER_PAIR))
    # ---- virial, on the same fields
    k3 = pwt.virial_sweep(*a32, **kw)
    pl3 = pwt.virial_sweep_plain(*a32, **kw)
    plain3_ms = time_ms(lambda: pwt.virial_sweep_plain(*a32, **kw), 2)
    pl3_64 = pwt.virial_sweep_plain(*a64, **kw)
    err3 = judge("virial_sweep", k3, pl3, pl3_64)

    def run3():
        return pwt.virial_sweep(*a32, **kw)

    ms3, cold3 = time_ms(run3, 50), time_ms_cold(run3, 10)
    bytes3 = n * VIRIAL_BYTES_PER_PARTICLE + table_bytes
    rows.append(_row("virial_sweep", "virial_sweep.cu",
                     "particlemethod_fsi_tpu/ops/pallas_windows_t.py:745",
                     err3, ms3, cold3, plain3_ms, bytes3,
                     true_pairs * VIRIAL_FLOP_PER_PAIR))
    print(f"kernels at 1M: frame rows {n}, window senders tested per "
          f"receiver {tested_pairs / n:.1f}, pairs inside the kernel radius "
          f"per receiver {true_pairs / n:.2f}, longest window "
          f"{int(win[1].max())}")
    return rows


def _row(name, source, replaces, err, ms, cold_ms, plain_ms, nbytes, flops):
    """One entry of the ``kernels`` line.  ``max_err`` and ``kernel_ms``
    repeat ``max_abs_err`` and ``ms`` under a second name; ``ms`` is with the
    inputs warm in L2, ``cold_l2_ms`` with L2 flushed before each launch."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S * 1e3
    return {
        "name": name, "route": "cuda",
        "source": f"particlemethod_fsi_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": None, "max_abs_err": err,
        "max_err": err, "ms": ms, "kernel_ms": ms, "cold_l2_ms": cold_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "bound_bytes": nbytes,
        "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
        "roofline_share": max(t_bytes, t_ops) / ms,
    }


# ---------------------------------------------------------------------------
# phase 4: small coupled scene, card against CPU
# ---------------------------------------------------------------------------


def check_small_scene():
    """Ten coupled steps of the bench scene at n_side=24 in float64: the
    card (CUDA kernels) against the CPU (plain versions).  Tolerance: the
    bar the repository holds its backends to among themselves (pos rtol
    1e-12 / atol 1e-15, vel rtol 1e-9 / atol 1e-13): only the order of the
    pair sums differs."""
    from particlemethod_fsi_tpu_torch.models import build_case
    from particlemethod_fsi_tpu_torch.state import to_numpy

    kw = dict(dtype="float64", pallas_block=32)
    gpu = build_case(24, **kw)
    cpu = build_case(24, device="cpu", **kw)
    a = to_numpy(gpu.run_chunk(gpu.state0, 10), gpu.n)
    b = to_numpy(cpu.run_chunk(cpu.state0, 10), cpu.n)
    if gpu.rebuilds != cpu.rebuilds:
        fail(f"small scene: rebuilds differ, card {gpu.rebuilds} cpu "
             f"{cpu.rebuilds}")
    try:
        np.testing.assert_allclose(a["pos"], b["pos"], rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(a["vel"], b["vel"], rtol=1e-9, atol=1e-13)
    except AssertionError as e:
        fail(f"small scene: card and CPU disagree: {e}")
    return float(np.abs(a["pos"] - b["pos"]).max()), gpu.rebuilds


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------


def run_main_path():
    import torch
    from particlemethod_fsi_tpu_torch.models import build_case
    from particlemethod_fsi_tpu_torch.ops import windows_t as pwt

    t0 = time.time()
    sim = build_case(N_SIDE)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    if sim.n != 1_012_666 or sim.n_pad != 1_012_736:
        fail(f"main path: {sim.n} particles in {sim.n_pad} slots")
    flags = sim._pcfg
    if (flags.surface_tension or not flags.uniform_ratio or not flags.planar
            or not flags.uniform_radii or flags.block != 64
            or sim.dtype != torch.float32 or sim.cfg.substeps != 1):
        fail(f"main path: unexpected specialization {flags}")

    pwt.reset_launch_counts()
    state = sim.run_chunk(sim.state0, CHUNK)  # warm-up
    torch.cuda.synchronize()
    chunk_ms = []
    for c in range(TIMED_CHUNKS):
        if c == TIMED_CHUNKS - 1:
            sim.profile_events = []
        torch.cuda.synchronize()
        t0 = time.time()
        state = sim.run_chunk(state, CHUNK)
        torch.cuda.synchronize()
        chunk_ms.append((time.time() - t0) * 1e3 / CHUNK)
    events, sim.profile_events = sim.profile_events, None
    counts = dict(pwt.launch_counts)
    steps = CHUNK * (TIMED_CHUNKS + 1)

    if not bool(torch.isfinite(state.pos).all()):
        fail("main path: positions are not all finite")
    if tuple(state.pos.shape) != (sim.n_pad, 3):
        fail(f"main path: positions have shape {tuple(state.pos.shape)}")
    if counts != {"phase1_sweep": steps, "phase2_sweep": steps,
                  "virial_sweep": 0}:
        fail(f"main path: launch counts {counts} after {steps} steps")
    if not 0 < sim.rebuilds < steps:
        fail(f"main path: {sim.rebuilds} rebuilds in {steps} steps")
    if abs(float(state.time) - steps * sim.cfg.dt) > 1e-3 * steps * sim.cfg.dt:
        fail(f"main path: time {float(state.time)} after {steps} steps")
    speed = float(state.vel[: sim.n].norm(dim=1).max())
    fell = float((sim.state0.pos[: sim.n, 1] - state.pos[: sim.n, 1]).max())
    # free fall over 80 steps of 1e-4 s: g t^2 / 2 = 3.1e-4 m, v = 0.078 m/s
    if not (0 < speed < 5.0 and 0 < fell < 5e-3):
        fail(f"main path: max speed {speed}, largest drop {fell}")

    # where the step's time goes: intervals between the marks of each step
    spans: dict = {}
    for (_, a), (name, b) in zip(events, events[1:]):
        if name != "begin":
            spans[name] = spans.get(name, 0.0) + a.elapsed_time(b)
    label = {"frame": "wrap, rebuild test, sort and windows",
             "phase1": "phase 1 + EOS", "phase2": "phase 2",
             "integrate": "gravity, unsort, kick, convection",
             "solid": "elastic solid"}
    breakdown = {label[k]: v / CHUNK for k, v in spans.items()}
    ms = float(np.median(chunk_ms))
    print(f"main path: {sim.n} particles ({sim.n_pad} slots), float32, "
          f"set-up {setup_s:.1f} s, {steps} steps, rebuilds {sim.rebuilds}, "
          f"ms/step by chunk {[round(m, 3) for m in chunk_ms]}, median "
          f"{ms:.3f} ms/step, {sim.n / ms * 1e3:.4g} particle-steps/s, "
          f"max speed {speed:.4f} m/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    print("main path, ms/step by section (CUDA events, last chunk): "
          + json.dumps({k: round(v, 4) for k, v in breakdown.items()})
          + f"; sum {sum(breakdown.values()):.3f} of {chunk_ms[-1]:.3f}")
    return sim, state, counts


def time_guarded_and_diagnostics(sim, state):
    """At 1M on the card: guarded against unguarded chunks, in turns within
    this one call (unguarded, guarded, guarded, unguarded, twice over), and
    the split of one ``diagnostics`` call."""
    import torch

    def chunk_ms(guarded: bool):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.time()
        if guarded:
            state, done, ok = sim.run_chunk_guarded(state, CHUNK)
            if (done, ok) != (CHUNK, True):
                fail(f"guarded chunk at 1M stopped after {done} steps")
        else:
            state = sim.run_chunk(state, CHUNK)
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3 / CHUNK

    order = [False, True, True, False] * 2
    ms = [chunk_ms(g) for g in order]
    unguarded = [m for m, g in zip(ms, order) if not g]
    guarded = [m for m, g in zip(ms, order) if g]
    print(f"guard at 1M, ms/step over {CHUNK}-step chunks in turns "
          f"(u g g u u g g u): unguarded {[round(m, 3) for m in unguarded]}, "
          f"guarded {[round(m, 3) for m in guarded]}; medians "
          f"{np.median(unguarded):.3f} and {np.median(guarded):.3f}")

    sim.diagnostics(state)  # warm-up
    sim.profile_events = []
    torch.cuda.synchronize()
    t0 = time.time()
    d = sim.diagnostics(state)
    total_ms = (time.time() - t0) * 1e3
    events, sim.profile_events = sim.profile_events, None
    spans = {name: a.elapsed_time(b)
             for (_, a), (name, b) in zip(events, events[1:])}
    host = {k: v * 1e3 for k, v in sim.last_diagnostics_seconds.items()}
    device_ms = sum(spans.values())
    if not (np.isfinite(d["virial_pressure"]).all()
            and float(np.abs(d["virial_pressure"]).max()) > 0):
        fail("diagnostics at 1M: virial pressure is zero or not finite")
    print("diagnostics at 1M, ms by section of one call (CUDA events): "
          + json.dumps({k: round(v, 3) for k, v in spans.items()})
          + f"; device sum {device_ms:.3f}; host clock: device work and "
          f"copies to the host {host['device_and_copies']:.1f}, numpy "
          f"assembly {host['host_assembly']:.1f}, whole call {total_ms:.1f}")
    return state, dict(unguarded_ms=float(np.median(unguarded)),
                       guarded_ms=float(np.median(guarded)))


# ---------------------------------------------------------------------------
# phase 4b: the gate case against the reference binary's golden
# ---------------------------------------------------------------------------


def check_gate_golden(tmp: str):
    """The coupled gate case (``cases/fsi_gate``), float64, 100 steps on the
    card through ``load_case``, against ``goldens/gate/gate100.prof.gz``
    written by the reference binary.  Tolerance: positions within 2.0e-6 m,
    the bar of the CPU tests (the ``%e`` six-digit floor plus drift)."""
    from particlemethod_fsi_tpu_torch.config import NumericsConfig
    from particlemethod_fsi_tpu_torch.generator import generate_case
    from particlemethod_fsi_tpu_torch.solver import Simulation, load_case
    from particlemethod_fsi_tpu_torch.state import to_numpy

    here = os.path.dirname(os.path.abspath(__file__))
    shutil.copy(os.path.join(here, "cases", "fsi_gate", "gate.boid"), tmp)
    generate_case(os.path.join(tmp, "gate"))
    cfg, grid = load_case(
        os.path.join(here, "goldens", "gate", "gate.data"),
        os.path.join(tmp, "gate.grid"), scene="dam",
        numerics=NumericsConfig(dtype="float64", backend="pallas_t"))
    sim = Simulation(cfg, grid)
    state, done, ok = sim.run_chunk_guarded(sim.state0, 100)
    if (done, ok) != (100, True):
        fail(f"gate golden: guarded chunk stopped after {done} steps")
    out = to_numpy(state, sim.n)
    with gzip.open(os.path.join(here, "goldens", "gate",
                                "gate100.prof.gz"), "rt") as f:
        f.readline()
        f.readline()
        gold = np.loadtxt(f)
    dp = float(np.abs(out["pos"][:, :2] - gold[:, 1:3]).max())
    if not dp < 2.0e-6:
        fail(f"gate golden: position differs by {dp:.3e} m after 100 steps")
    return sim.n, dp


# ---------------------------------------------------------------------------
# phase 6: the command-line path
# ---------------------------------------------------------------------------


def _vtk_block(data: bytes, header: bytes, n: int, skip_lines: int):
    """The n rows after ``header`` (and ``skip_lines`` more header lines) of
    a legacy-ASCII dump held in memory."""
    at = data.find(header)
    if at < 0:
        fail(f"vtk: no block {header!r}")
    for _ in range(1 + skip_lines):
        at = data.index(b"\n", at) + 1
    return np.loadtxt(io.BytesIO(data[at:at + 64 * n]), max_rows=n, ndmin=2)


def run_cli_path(tmp: str):
    """Write the 1M bench scene as files, run the command line on them on
    the card, and check what it wrote."""
    import torch
    from particlemethod_fsi_tpu_torch import cli
    from particlemethod_fsi_tpu_torch.io import native
    from particlemethod_fsi_tpu_torch.io.data_file import write_data_file
    from particlemethod_fsi_tpu_torch.io.grid_file import (
        GridData, read_grid_file, write_grid_file)
    from particlemethod_fsi_tpu_torch.io.vtk_writer import write_vtk_file
    from particlemethod_fsi_tpu_torch.models import bench_config, bench_grid
    from particlemethod_fsi_tpu_torch.ops import windows_t as pwt
    from particlemethod_fsi_tpu_torch.solver import Simulation, load_case
    from particlemethod_fsi_tpu_torch.state import to_numpy

    j = lambda name: os.path.join(tmp, name)  # noqa: E731
    interval = CLI_STEPS * 1e-4
    want_cfg = bench_config().replace(
        output_interval=interval, vtk_output_interval=interval,
        end_time=interval)
    grid0 = bench_grid(N_SIDE)
    write_data_file(want_cfg, j("bench.data"))
    t0 = time.time()
    write_grid_file(grid0, j("bench.grid"))
    write_s = time.time() - t0
    t0 = time.time()
    cfg, grid = load_case(j("bench.data"), j("bench.grid"), scene="dam",
                          numerics=want_cfg.numerics)
    read_s = time.time() - t0
    if cfg != want_cfg:
        fail("cli path: load_case does not give back the written config")
    if grid.n != grid0.n or not np.array_equal(grid.prop, grid0.prop):
        fail("cli path: the grid's types did not come back")
    for k in ("position", "initial_position", "velocity", "domain_min",
              "domain_max"):
        a, b = getattr(grid, k), getattr(grid0, k)
        # %e keeps seven significant digits
        if not np.allclose(a, b, rtol=5.1e-7, atol=0):
            fail(f"cli path: {k} did not come back to the print format")
    grid_mb = os.path.getsize(j("bench.grid")) / 1e6

    argv = [j("bench.data"), j("bench.grid"), j("bench%03d.prof"),
            j("bench%03d.vtk"), j("bench.log"), "4", "--scene", "dam",
            "--backend", "pallas_t", "--rebuild-margin", "0.5", "--dtype",
            "float32", "--metrics", j("metrics.jsonl")]
    pwt.reset_launch_counts()
    t0 = time.time()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    counts = dict(pwt.launch_counts)
    if rc != 0:
        fail(f"cli path: return code {rc}")

    last = f"{CLI_STEPS:03d}"
    for name in ("bench000.prof", f"bench{last}.prof", "bench000.vtk",
                 f"bench{last}.vtk", "bench.log", "metrics.jsonl"):
        if not os.path.getsize(j(name)) > 0:
            fail(f"cli path: {name} is missing or empty")
    log = open(j("bench.log")).read()
    if "platform: cuda" not in log or "WATCHDOG" in log or "GUARD" in log:
        fail(f"cli path: unexpected log:\n{log}")
    metrics = [json.loads(ln) for ln in open(j("metrics.jsonl"))]
    steps = sum(m.get("chunk", 0) for m in metrics)
    dumps = [m for m in metrics if "neighbor_max" in m]
    if steps < CLI_STEPS or len(dumps) != 2:
        fail(f"cli path: {steps} steps and {len(dumps)} dumps in the metrics")
    want_counts = {"phase1_sweep": steps + 2, "phase2_sweep": steps + 2,
                   "virial_sweep": 2}
    if counts != want_counts:
        fail(f"cli path: launch counts {counts}, expected {want_counts}")
    for m in dumps:
        if not (10 <= m["neighbor_max"] <= 60 and np.isfinite(m["max_speed"])
                and 0 <= m["max_speed"] < 5.0 and m["cell_overflow"] > 0
                and m["window_len"] > 0 and m["ghost_overflow"] == 0):
            fail(f"cli path: metrics out of range: {m}")
    if not dumps[1]["max_speed"] > 0:
        fail("cli path: nothing moved")

    # the final .prof is, to the print format, the state of the guarded
    # chunk over the same steps from the same grid: written again with the
    # same writer, the bytes are equal
    sim = Simulation(cfg, grid)
    state, done, ok = sim.run_chunk_guarded(sim.state0, CLI_STEPS)
    if (done, ok) != (CLI_STEPS, True):
        fail(f"cli path: reference chunk stopped after {done} steps")
    h = to_numpy(state, grid.n)
    snap = GridData(time=CLI_STEPS * cfg.dt, spacing=grid.spacing,
                    domain_min=np.asarray(sim.domain_min),
                    domain_max=np.asarray(sim.domain_max), prop=h["prop"],
                    position=h["pos"], initial_position=h["pos0"],
                    velocity=h["vel"])
    t0 = time.time()
    write_grid_file(snap, j("expect.prof"))
    prof_s = time.time() - t0
    if open(j("expect.prof"), "rb").read() != open(
            j(f"bench{last}.prof"), "rb").read():
        fail("cli path: the final .prof differs from the guarded chunk's state")
    back = read_grid_file(j(f"bench{last}.prof"))
    if back.n != grid.n or not np.isfinite(back.position).all():
        fail("cli path: the final .prof does not parse back")

    # the final .vtk parses back: points, neighbour counts and virial
    # pressure are those of the diagnostics of that state, to the print
    # format
    d = sim.diagnostics(state)
    n = grid.n
    data = open(j(f"bench{last}.vtk"), "rb").read()
    pts = _vtk_block(data, b"POINTS", n, 0)
    nbr = _vtk_block(data, b"SCALARS neighbor ", n, 1)[:, 0]
    vir = _vtk_block(data, b"SCALARS VirialPressureAtParticle", n, 1)[:, 0]
    if not np.allclose(pts, h["pos"], rtol=5.1e-7, atol=0):
        fail("cli path: the .vtk points are not the final positions")
    if not np.array_equal(nbr.astype(np.int32), d["neighbor_count"][:n]):
        fail("cli path: the .vtk neighbour counts are not the diagnostics'")
    if not np.allclose(vir, d["virial_pressure"][:n], rtol=5.1e-7, atol=0):
        fail("cli path: the .vtk virial pressure is not the diagnostics'")
    if not float(np.abs(vir).max()) > 0:
        fail("cli path: the virial pressure is zero")
    vtk_mb = len(data) / 1e6
    del data
    t0 = time.time()
    writer = write_vtk_file(
        j("again.vtk"), prop=h["prop"], position=h["pos"],
        initial_position=h["pos0"], velocity=h["vel"],
        stress=d["stress"][:n], strain=d["strain"][:n],
        acceleration=d["accel"][:n], force=d["force"][:n],
        initial_neighbor_count=d["initial_neighbor_count"][:n],
        neighbor_count=d["neighbor_count"][:n],
        extra_scalars={"VirialPressureAtParticle": d["virial_pressure"][:n]})
    vtk_s = time.time() - t0
    if open(j("again.vtk"), "rb").read() != open(
            j(f"bench{last}.vtk"), "rb").read():
        fail("cli path: the final .vtk differs from the diagnostics written again")
    buckets = {ln.split(":")[0]: float(ln.split(":")[1].split()[0])
               for ln in log.splitlines() if "[sec]" in ln}
    print(f"cli path: {n} particles, {steps} steps, return code 0 in "
          f"{cli_s:.1f} s; launches {json.dumps(counts)}; writer "
          f"{writer} ({native.writer_name()}); .grid {grid_mb:.0f} MB written "
          f"in {write_s:.2f} s and read by load_case in {read_s:.2f} s; "
          f".prof written in {prof_s:.2f} s; .vtk {vtk_mb:.0f} MB written in "
          f"{vtk_s:.2f} s; neighbor_max {dumps[1]['neighbor_max']}, max_speed "
          f"{dumps[1]['max_speed']:.4f} m/s, window_len "
          f"{dumps[1]['window_len']}; the log's buckets [s]: "
          + json.dumps(buckets))
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if card.returncode != 0 or not card.stdout.strip():
        fail(f"nvidia-smi failed: {card.stderr.strip()}")
    card_line = card.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on")

    from particlemethod_fsi_tpu_torch.ops import cuda_loader

    t0 = time.time()
    cuda_loader.load()
    print(f"build: kernels compiled from csrc/ in {time.time() - t0:.1f} s "
          f"(set-up)")
    entry = ""
    for line in cuda_loader.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and "registers" in line:
            print(f"  ptxas: {entry}: {line.split(':', 1)[1].strip()}")
        elif "bytes spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            print(f"  ptxas: {entry}: {line.strip()}")

    device = torch.device("cuda", 0)
    worst = check_small_cases(device)
    print(f"kernels, double instances on {len(SMALL_CASES)} small seeded "
          f"frames (every branch), rtol 1e-12: ok; largest error over row "
          f"scale: " + json.dumps(worst))
    if "--kernels-only" in sys.argv[1:]:
        print(card_line)
        return 0

    pos_err, rebuilds = check_small_scene()
    print(f"small coupled scene (880 particles, float64, 10 steps): card "
          f"against CPU ok, max |pos| difference {pos_err:.3e}, rebuilds "
          f"{rebuilds}")

    tmp = tempfile.mkdtemp(prefix="fsi_smoke_")
    try:
        n_gate, gate_err = check_gate_golden(tmp)
        print(f"gate case ({n_gate} particles, float64, 100 steps on the "
              f"card) against the reference binary's golden: max position "
              f"difference {gate_err:.3e} m (bar 2.0e-6)")

        sim, state, counts = run_main_path()
        rows = check_and_time_main_frame(sim, state)
        state, _ = time_guarded_and_diagnostics(sim, state)
        del sim, state
        torch.cuda.empty_cache()
        cli_counts = run_cli_path(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # launches: of the step path's run for the two step kernels, of the
    # command-line path's run for the virial (one per .vtk dump); the
    # command-line path's counts of all three stand beside them
    for row in rows:
        row["launches"] = counts[row["name"]] or cli_counts[row["name"]]
        row["launches_cli_path"] = cli_counts[row["name"]]

    print(card_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
