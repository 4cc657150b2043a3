#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc`` and fails (exit code != 0) without
them; it never runs on the CPU.  The port has two window-sweep backends,
each with three hand-written kernels: ``pallas_t`` (field-major; kernels 1-3:
phase 1, phase 2, virial) and ``pallas`` (row-major; kernels 4-6, the same
three sums with the ring recomputed from positions); kernel 7 is the
packed-bf16 throughput probe.  The candidate engines ``packed`` and
``gather`` are plain torch ops (no hand kernel): their phases hold them
against the CPU and ``pallas_t`` and time them.  Phases, each failing the
run on its first fault:

1. the card: name and power limit as ``nvidia-smi`` gives them;
2. build: the CUDA kernels under ``particlemethod_fsi_tpu_torch/csrc/`` are
   compiled from source (seconds printed as set-up), and beside them a
   checking build with ``-DFSI_WALK_COUNT``, whose window kernels (1-6)
   count what they walk;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card -- (a) the ``double`` instances of kernels 1-6 on small seeded
   frames for every specialization branch, 2-D and 3-D, rtol 1e-12, and the
   probe's float32 and bf16 instances against its twin at 1, 7, 64, 512 and
   513 trips (bf16 1e-4 of the row sum, and farther than that from the
   chain in float32; one launch a call, bit-equal twice; every element's
   term equal to the twin's), kernels 4-6
   with every pad inside the fluid and in every window, kernels 1-6 on
   a ghost-extended frame of the Turek channel at 20 mm with every unfilled
   ghost slot in every window, and kernels 1-6 on plane-padded 3-D frames
   of the solver's frame path (windows across plane ends, plane pads in
   receivers' ring runs, ghost rows and plane pads in one frame); (b) the
   ``float`` instances on the full-size frames of each backend's main path
   (both 1M scenes, ``cases/gate3d``'s 3-D frame and the 3-D dam break's
   at 2.08M), where the kernel
   must lie as close to a float64 evaluation as the plain
   float32 version does; timed with inputs warm in L2 (back-to-back
   launches) and cold (L2 flushed before every launch), kernel 1 also with
   the neighbour count; each window kernel (1-6) also launched twice and
   held bit-equal, and once through the checking build, bit-equal again,
   whose count of the senders each receiver pre-tests must equal the plain
   ring runs' total (and the senders passing the pre-test, for phase 1 the
   pairs inside the kernel's reach, for the virial phase 2's count on the
   same frame: the same pre-test); printed beside the window senders;
4. a small coupled scene in float64 on both backends, card (kernels)
   against CPU (plain versions), ten steps, and a small 3-D dam break the
   same way (plane-padded frames); the small scene on ``packed`` and
   ``gather`` and the 3-D dam and the 44k channel on ``packed`` the same
   way (no plane padding, no ghost rows: the minimum image); the Turek
   channel at 5 mm (44,000 particles, ghost-extended) the same way, and
   again in chunks of
   1, 1, 3 and 5 steps with the ghost plan rebuilt by force before the
   last, printing the flag's velocity gap after each; and the gate case
   (6,724 particles, float64, 100 steps through ``load_case``) on both
   backends and on ``packed`` (cell capacity 12, as the JAX package's
   goldens run) against the reference binary's golden, the Rolling module
   (rocking walls; 500 steps on ``pallas_t``, 100 on ``pallas``) and the
   bar's tip after its first-mode excitation (100 steps) the same way;
5. the step path of each backend on four full-size scenes, the coupled
   dam break on an elastic bar at ``n_side=1000`` (1,012,666 particles),
   the Turek channel at ``l0=1e-3`` (1,040,000 particles,
   ghost-extended), the 3-D coupled dam-on-gate ``cases/gate3d`` (236,160
   particles, plane-padded) and the 3-D dam break at ``n_side=120``
   (2,077,920 particles; chunks of 10 steps on ``pallas_t``, 5 on
   ``pallas``), float32, a warm-up chunk and three
   timed chunks of 20 steps through ``Simulation.run_chunk`` with
   ``refresh_ghosts`` at each boundary;
   finite positions, launch counts equal to the steps taken, rebuild
   count, ms/step, and where the step's time goes from CUDA events; the
   time of the extremes read each step makes; on the channel a ghost plan
   rebuilt by force, timed, and a chunk after it; then (field-major, the
   bench scene) guarded against unguarded chunks, and on every scene the
   split of one ``diagnostics`` call;
   then the candidate engines at full size (``packed`` on the bench, the
   channel and the 3-D dam, ``gather`` on the bench and the channel; cell
   capacity 16 on the bench, 24 on the channel, 80 on the 3-D dam, so that
   no cell is past it: the run
   fails where a step met one, or where a window kernel launched),
   float32, a warm-up chunk and three timed chunks of 20 steps (the 3-D
   dam's 5): ms/step,
   particle-steps/s, the peak of device memory, the fullest cell; one
   ``diagnostics`` call on ``packed``, and on the bench's state one step's
   force on each engine against ``pallas_t``'s (float64: within 1e-9 of
   the largest force; float32: the gap printed);
   then frames of 2^24 cells or more, which ``pallas_t`` hands to the
   row-major kernels;
6. the command-line path of each backend: the same scene written as
   ``.data`` and ``.grid`` into a temporary directory, ``cli.main`` in
   process on the card for one output interval with the watchdog on, and
   the Turek channel and ``cases/gate3d`` the same way on ``pallas_t``,
   and the bench scene on ``packed`` and ``gather`` (10 steps each);
   ``.prof`` and ``.vtk`` files with virial pressure, log and metrics
   written, read back and checked; launch counts of the backend's kernels;
   seconds of the writers and readers;
7. the probe: float32 and bf16 element throughput of kernel 7 (the slope
   between two trip counts), one launch of 512 trips timed alone, the trip
   loop's machine instructions per element-trip, the SM clock, and the
   bound by instruction issue beside the published float32 bound.

``python3 chip_smoke.py --kernels-only`` stops after phase 3a (build, register
counts, double instances, the probe's check): the short first run of a new
kernel.

Output: one line per phase, then a ``{"kernels": [...]}`` JSON line, then as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
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
N_PARTICLES, N_SLOTS = 1_012_666, 1_012_736  # of the scene at N_SIDE
TUREK_L0 = 1e-3
# particles, slots and elastic substeps a step of each full-size scene
SCENE_SIZES = {"bench": (N_PARTICLES, N_SLOTS, 1),
               "turek": (1_040_000, 1_040_128, 5),
               "gate3d": (236_160, 236_288, 5),
               "dam3d": (2_077_920, 2_077_952, 1)}
SCALE = {"bench": "1M", "turek": "1M", "gate3d": "236k", "dam3d": "2.08M"}
DAM3D_SIDE = 120  # models.dam_break_3d's n_side: 2,077,920 particles
# steps a chunk of each scene's path (a warm-up chunk and TIMED_CHUNKS)
PATH_CHUNK = {("dam3d", "pallas_t"): 10, ("dam3d", "pallas"): 5,
              ("dam3d", "packed"): 5}
CHUNK = 20
TIMED_CHUNKS = 3
CLI_STEPS = 20  # steps of the command-line phase's one output interval
CLI_ROWS_STEPS = 10  # the same on the row-major backend and the engines
# the candidate engines (plain torch ops, no hand kernel) and the cell
# capacity each full-size scene runs them at: enough for its fullest cell,
# so that no timed step drops a pair.  The bench scene's cells hold 16 at
# step 0 and over its 80 steps; the channel's hold 16 at step 0 and 18
# within 80 steps, the 3-D dam's 4 x 4 x 4 lattice sites: room for the flow
# to bunch them.  Not gate3d: its gate overlaps its floor (240 pairs of
# particles at one position), and both packages' candidate engines give
# such a pair the distance 1 m (edge_math.make_geometry), where the window
# sweeps skip it: the step diverges there
ENGINES = ("packed", "gather")
ENGINE_CAPACITY = {"bench": 16, "turek": 24, "dam3d": 80}

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12
# Each window kernel's bound counts: (a planar frame, a 3-D frame), both at
# the main paths' flags (no surface tension, uniform ratios and radii, no
# count).
# Float operations a pair inside the kernel radius, counted from the
# formulas.  Planar: separation and rij2 (5), rsqrt, r, q, 1-q (4); phase 1
# adds the wp sum (2) and the divergence (9); phase 2 adds the unit vector
# (2), the pressure term (5), the viscosity term (14) and the force sums (4);
# the virial adds the unit vector (2), the pressure term with P_i alone (3),
# the half-weighted viscosity term with its finite test folded in (15), the
# force components (2) and the four products and sums of the outer product
# (8).  The row-major kernels do the same pair math, with mu_h = 2 mu_i mu_j
# / (mu_i + mu_j) guarded by a compare (phase 2: +3 over 2 / (1/mu_i +
# 1/mu_j); virial: +1 over its finite test).  3-D adds the z terms: rij2
# (+3), the divergence's or the viscosity's velocity term (+3), the unit
# vector's z (+1), phase 2's fz sum (+2), the virial's fz (+1) and five more
# outer-product terms (+10).
FLOP_PER_PAIR = {
    "phase1_sweep": (20, 26), "phase2_sweep": (34, 43),
    "virial_sweep": (39, 57), "phase1_rows": (20, 26),
    "phase2_rows": (37, 46), "virial_rows": (40, 58),
}
# the row-major ring's cell coordinates, a particle (subtract, divide,
# floor, two clamps: 5 each; two planar, three in 3-D)
ROWS_FLOP_PER_PARTICLE = (10, 15)
# Bytes a particle that the function needs, float32.  Phase 1 reads x, y,
# vx, vy and the key and writes the wp sum and the divergence; the
# density-A, gravity-centre and count rows are zero there, and in a planar
# frame z, vz are never used.  Phase 2 reads x, y, vx, vy, pressure P, 1/mu,
# key and type and writes fx, fy.  The virial reads x, y, vx, vy, pressure
# P, 1/mu and the key and writes the four in-plane components.  The
# row-major functions read the type where the field-major ones read the key
# (their rings come from the positions; the key only speeds the kernels'
# run search), and phase 1 always writes the neighbour count.  3-D adds z
# and vz read, phase 2's fz and the virial's five more components written.
# (The kernels as written move more: pos and vel are staged as [N,3] rows
# and every output row is written.)
BYTES_PER_PARTICLE = {
    "phase1_sweep": (5 * 4 + 2 * 4, 7 * 4 + 2 * 4),
    "phase2_sweep": (8 * 4 + 2 * 4, 10 * 4 + 3 * 4),
    "virial_sweep": (7 * 4 + 4 * 4, 9 * 4 + 9 * 4),
    "phase1_rows": (5 * 4 + 3 * 4, 7 * 4 + 3 * 4),
    "phase2_rows": (7 * 4 + 2 * 4, 9 * 4 + 3 * 4),
    "virial_rows": (7 * 4 + 4 * 4, 9 * 4 + 9 * 4),
}
# larger than the card's L2 (50 MB on an H100): writing it evicts the inputs
L2_FLUSH_BYTES = 256 * 2**20
# clocks of the device spin (torch.cuda._sleep) that leads a timing: ~10 ms
LEAD_CYCLES = 20_000_000


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int, lead: bool = False) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events.
    With ``lead`` a ~10 ms spin on the device precedes the first event, so
    that the host has enqueued the calls before the device reaches them:
    the device's time alone, for a kernel shorter than the host's time a
    call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if lead:
        torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_ms_cold(fn, reps: int, lead: bool = False) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, each after a write
    over a buffer larger than L2, so that the inputs come from device
    memory.  Only ``fn()`` lies between a call's two events.  With ``lead``
    a ~1 ms spin on the device precedes each flush, so that the host has
    enqueued the call before the device reaches it (a kernel shorter than
    the host's time a call)."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pairs = []
    for _ in range(reps):
        if lead:
            torch.cuda._sleep(LEAD_CYCLES // 10)
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

    worst = {k: 0.0 for k in ("phase1_sweep", "phase2_sweep", "virial_sweep",
                              "phase1_rows", "phase2_rows", "virial_rows")}

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
        check_virial_rows("virial_sweep", case, want3, wcfg)

        # the row-major kernels 4-6 on the same frame and fields (mu itself
        # in place of 1/mu); phase 1 always counts
        rows = (frame, *win, cgrid, ks, wcfg, tables)
        got4 = pw.phase1_rows_sweep(*rows)
        want4 = pw.phase1_rows_sweep_plain(*rows)
        torch.cuda.synchronize()
        compare("phase1_rows", case, got4, want4)
        for r in live + [pw.P1_COUNT]:
            if not float(want4[r].abs().max()) > 0:
                fail(f"phase1_rows case {case!r}: row {r} is all zero")
        args_rows = (frame, p2["pp"], p2["pa"], p2["gc"], p2["mu"], *win,
                     cgrid, ks, wcfg, tables)
        got5 = pw.phase2_rows_sweep(*args_rows, **kw)
        want5 = pw.phase2_rows_sweep_plain(*args_rows, **kw)
        torch.cuda.synchronize()
        compare("phase2_rows", case, got5, want5)
        got6 = pw.virial_rows_sweep(*args_rows, **kw)
        want6 = pw.virial_rows_sweep_plain(*args_rows, **kw)
        torch.cuda.synchronize()
        compare("virial_rows", case, got6, want6)
        check_virial_rows("virial_rows", case, want6, wcfg)
    return worst


def check_pads_in_windows(device) -> float:
    """Kernels 4-6 (double) with pad rows inside the fluid: every pad moved
    next to a fluid particle and every window run on to the frame's end, so
    that each pad lies in every receiver's window and in some receivers'
    position rings.  Each kernel keeps it out by its ring runs before its
    validity test: all three take them from the key, and a pad's key
    ``num_cells`` lies in no ring (a 3-D frame's plane pads, keyed with a
    real cell, are ``check_planes_in_windows``' case).  Against the plain
    versions (rtol 1e-12 of the row scale), and the real rows against the
    same kernels on the exact windows."""
    import torch
    from particlemethod_fsi_tpu_torch.ops import windows as pw

    (frame, win, cgrid, ks, wcfg, tables, p2, _,
     cfg) = small_case("main_path_flags", device)
    real = frame.prop >= 0
    pads = (~real).nonzero()[:, 0]
    fluid = (frame.prop == 1).nonzero()[:, 0][: pads.numel()]
    if not 0 < pads.numel() <= fluid.numel():
        fail(f"pads in windows: {pads.numel()} pads, {fluid.numel()} fluid")
    pos = frame.pos.clone()
    pos[pads] = pos[fluid] + 0.3e-3 * torch.tensor(
        [1.0, 0.5, 0.0], dtype=pos.dtype, device=device)
    moved = frame._replace(pos=pos)
    to_end = (frame.pos.shape[0] - win[0]).to(torch.int32)
    kw = dict(volume=1e-6, two_dimensional=True)
    fields = (p2["pp"], p2["pa"], p2["gc"], p2["mu"])
    worst = 0.0
    for name, run in (
            ("phase1_rows", lambda f, w, k: pw.phase1_rows_sweep(
                f, *w, cgrid, ks, wcfg, tables) if k else
             pw.phase1_rows_sweep_plain(f, *w, cgrid, ks, wcfg, tables)),
            ("phase2_rows", lambda f, w, k: (
                pw.phase2_rows_sweep if k else pw.phase2_rows_sweep_plain)(
                f, *fields, *w, cgrid, ks, wcfg, tables, **kw)),
            ("virial_rows", lambda f, w, k: (
                pw.virial_rows_sweep if k else pw.virial_rows_sweep_plain)(
                f, *fields, *w, cgrid, ks, wcfg, tables, **kw))):
        got = run(moved, (win[0], to_end), True)
        want = run(moved, (win[0], to_end), False)
        exact = run(frame, win, True)
        torch.cuda.synchronize()
        for r in range(want.shape[0]):
            scale = float(want[r].abs().max())
            for a, b, what in ((got[r], want[r], "plain version"),
                               (got[r][real], exact[r][real], "exact windows")):
                err = float((a - b).abs().max())
                if not torch.allclose(a, b, rtol=1e-12, atol=1e-12 * scale):
                    fail(f"{name} with pads in its windows, row {r}: {err:.3e} "
                         f"from the {what} (scale {scale:.3e})")
                if scale > 0:
                    worst = max(worst, err / scale)
    return worst


def check_ghosts_in_windows(device) -> dict:
    """Kernels 1-6 (double) on a ghost-extended frame of the Turek channel
    at l0 = 20 mm (4,000 particles, periodic in x and y), with seeded
    phase-2 fields: every window run on to the frame's end, so that the
    unfilled ghost slots (type -1 at position 0, which lies inside the
    channel's corner, key ``num_cells``, sorted last) lie in every
    receiver's window, and the ghost rows with a type (in the ghost cell
    layer at ``domain_min - cell_width`` and past the top) in many rings.
    Against the plain versions (rtol 1e-12 of the row scale), and the slot
    rows against the same kernels on the exact windows.  Every kernel takes
    its runs from the key; kernels 4-6 test the ring on the linear cells of
    the staged positions under the frame (extended) grid."""
    import torch
    from particlemethod_fsi_tpu_torch.models import build_turek
    from particlemethod_fsi_tpu_torch.ops import packed_engine as pk
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.ops import windows_t as pwt

    sim = build_turek(0.02, device=device, dtype="float64", pallas_block=32)
    st = sim.state0
    grid, ks, wcfg, tables = (sim._frame_grid, sim.kernels, sim._pcfg,
                              sim.tables)
    (pos, vel, prop), gsrc, over = sim._frame_inputs(st.pos, st.vel, st.prop)
    frame = pk.sort_frame(pos, vel, prop, grid)
    win = pw.compute_windows(frame, grid, wcfg)
    n = frame.pos.shape[0]
    ghost = frame.orig >= sim.n_pad
    filled = int((ghost & (frame.prop >= 0)).sum())
    unfilled = int((ghost & (frame.prop < 0)).sum())
    if not (filled > 0 and unfilled > 0 and int(over) == 0):
        fail(f"ghosts in windows: {filled} ghost rows, {unfilled} unfilled "
             f"slots, overflow {int(over)}")
    if not bool((frame.key[-unfilled:] == grid.num_cells).all()):
        fail("ghosts in windows: unfilled slots do not sort last")
    slots = ~ghost & (frame.prop >= 0)
    to_end = (n - win[0]).to(torch.int32)
    rng = np.random.default_rng(8)

    def seeded(scale, *shape):
        return torch.as_tensor(rng.normal(scale=scale, size=shape)).to(device)

    mu = tables.shear_viscosity[torch.clamp(frame.prop, 0, 5).long()]
    pp, pa, gc = seeded(1e2, n), seeded(1e1, n), seeded(1e-3, n, 3)
    invmu = pwt.inverse_viscosity(mu)
    offs, _ = pw.row_offsets(grid)
    kw = dict(volume=sim.volume, two_dimensional=True)
    sweeps = {
        "phase1_sweep": lambda w, k: (
            pwt.phase1_sweep if k else pwt.phase1_sweep_plain)(
            frame, *w, offs, ks, wcfg, tables, support=grid.support,
            count=True),
        "phase2_sweep": lambda w, k: (
            pwt.phase2_sweep if k else pwt.phase2_sweep_plain)(
            frame, pp, pa, gc, invmu, *w, offs, ks, wcfg, tables, **kw),
        "virial_sweep": lambda w, k: (
            pwt.virial_sweep if k else pwt.virial_sweep_plain)(
            frame, pp, pa, gc, invmu, *w, offs, ks, wcfg, tables, **kw),
        "phase1_rows": lambda w, k: (
            pw.phase1_rows_sweep if k else pw.phase1_rows_sweep_plain)(
            frame, *w, grid, ks, wcfg, tables),
        "phase2_rows": lambda w, k: (
            pw.phase2_rows_sweep if k else pw.phase2_rows_sweep_plain)(
            frame, pp, pa, gc, mu, *w, grid, ks, wcfg, tables, **kw),
        "virial_rows": lambda w, k: (
            pw.virial_rows_sweep if k else pw.virial_rows_sweep_plain)(
            frame, pp, pa, gc, mu, *w, grid, ks, wcfg, tables, **kw),
    }
    worst = {}
    for name, run in sweeps.items():
        got = run((win[0], to_end), True)
        want = run((win[0], to_end), False)
        exact = run(win, True)
        torch.cuda.synchronize()
        worst[name] = 0.0
        for r in range(want.shape[0]):
            scale = float(want[r].abs().max())
            for x, y, what in ((got[r], want[r], "plain version"),
                               (got[r][slots], exact[r][slots],
                                "exact windows")):
                err = float((x - y).abs().max())
                if not torch.allclose(x, y, rtol=1e-12, atol=1e-12 * scale):
                    fail(f"{name} with ghost rows in its windows, row {r}: "
                         f"{err:.3e} from the {what} (scale {scale:.3e})")
                if scale > 0:
                    worst[name] = max(worst[name], err / scale)
    worst["frame"] = (f"{n} rows: {sim.n_pad} slots, {filled} ghost rows, "
                      f"{unfilled} unfilled ghost slots")
    return worst


def planes_case(name: str, device):
    """A plane-padded 3-D frame built by the solver's own frame path, float64,
    block 32, with its windows and seeded phase-2 fields: ``"dam3d"``, the
    3-D dam break at ``n_side=10`` with its fluid jittered (a window of the
    last block of each plane reaches into the next plane), or ``"periodic"``,
    a fluid block that fills its domain in x and y (ghost rows and plane pads
    in one frame; the last cell of a plane, where the plane pads are keyed,
    is a ghost corner that holds ghost rows, so some receivers' rings take
    it)."""
    import torch
    from particlemethod_fsi_tpu_torch.config import NumericsConfig
    from particlemethod_fsi_tpu_torch.generator import (
        BoidScene, Primitive, generate_grid)
    from particlemethod_fsi_tpu_torch.models import dam_break_3d
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.solver import Simulation

    nm = NumericsConfig(dtype="float64", backend="pallas", pallas_block=32)
    rng = np.random.default_rng(len(name))
    l0 = 1e-3
    cfg, grid = dam_break_3d(10, numerics=nm)
    if name == "periodic":
        cfg = cfg.replace(gravity=(0.0, 0.0, 0.0))
        grid = generate_grid(BoidScene(
            particle_distance=l0, lower_domain=(0.0, 0.0, 0.0),
            upper_domain=(11 * l0, 10 * l0, 10 * l0),
            primitives=[Primitive("Cuboid", spacing=l0, type=0,
                                  lower=(0, 0, 0),
                                  upper=(11 * l0, 10 * l0, 7 * l0))]))
    free = grid.prop < 4
    grid.position[free] += rng.normal(scale=0.05 * l0,
                                      size=(int(free.sum()), 3))
    grid.velocity[:] = rng.normal(scale=0.05, size=(grid.n, 3))
    sim = Simulation(cfg, grid, device=device)
    st = sim.state0
    (pos, vel, prop), _, over = sim._frame_inputs(st.pos, st.vel, st.prop)
    frame = sim._frame(pos, vel, prop)
    fgrid = sim._frame_grid
    win = pw.compute_windows(frame, fgrid, sim._pcfg)
    n = frame.pos.shape[0]

    def seeded(scale, *shape):
        return torch.as_tensor(rng.normal(scale=scale, size=shape)).to(device)

    mu = sim.tables.shear_viscosity[torch.clamp(frame.prop, 0, 5).long()]
    fields = dict(pp=seeded(1e2, n), pa=seeded(1e1, n), gc=seeded(1e-3, n, 3),
                  mu=mu)
    return sim, frame, win, pos.shape[0], int(over), fields


def check_planes_in_windows(device) -> dict:
    """Kernels 1-6 (double) on plane-padded 3-D frames (``planes_case``)
    against their plain versions, rtol 1e-12 of the row scale.  Fails
    unless some window spans a plane end (where the pad rows of one plane
    sit between the rows of two) and, on the periodic block, ghost rows
    and plane pads share the frame and some plane pad's key lies in a
    valid receiver's ring run (the ring test on its position must reject
    it).  Kernels 4 and 6 find their runs from the key: the staged linear
    cells, where a pad reads INT_MIN, are not sorted in a window across a
    plane end (``tests/test_torch_planes.py``)."""
    import torch
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.ops import windows_t as pwt

    worst = {}
    for name in ("dam3d", "periodic"):
        sim, frame, win, n_ext, over, f = planes_case(name, device)
        grid, ks, wcfg, tables = (sim._frame_grid, sim.kernels, sim._pcfg,
                                  sim.tables)
        nx, ny, nz = grid.cell_count
        key = frame.key.long()
        valid = frame.prop >= 0
        plane_pad = (frame.orig >= n_ext) & (key < grid.num_cells)
        ghost_rows = int(((frame.orig >= sim.n_pad) & (frame.orig < n_ext)
                          & valid).sum())
        ws, wl = (w.long() for w in win)
        last = torch.clamp(ws + wl - 1, max=key.shape[0] - 1)
        spans = int(((key[ws] // (nx * ny) != key[last] // (nx * ny))
                     & (wl > 1)).sum())
        lo, hi = pw.ring_runs_rows(frame, *win, grid, wcfg.block)
        cum = torch.cat([torch.zeros(1, dtype=torch.long, device=device),
                         torch.cumsum(plane_pad.long(), 0)])
        in_rings = int(((cum[hi] - cum[lo]) * valid[:, None]).sum())
        periodic = name == "periodic"
        if not (nz > 1 and spans > 0 and int(plane_pad.sum()) > 0
                and (in_rings > 0 or not periodic) and over == 0
                and (ghost_rows > 0) == periodic):
            fail(f"planes in windows ({name}): {nz} planes, {spans} windows "
                 f"across a plane end, {int(plane_pad.sum())} plane pads, "
                 f"{in_rings} in receivers' ring runs, {ghost_rows} ghost "
                 f"rows, overflow {over}")
        offs, _ = pw.row_offsets(grid)
        invmu = pwt.inverse_viscosity(f["mu"])
        kw = dict(volume=sim.volume, two_dimensional=False)
        sweeps = {
            "phase1_sweep": lambda k: (
                pwt.phase1_sweep if k else pwt.phase1_sweep_plain)(
                frame, *win, offs, ks, wcfg, tables, support=grid.support,
                count=True),
            "phase2_sweep": lambda k: (
                pwt.phase2_sweep if k else pwt.phase2_sweep_plain)(
                frame, f["pp"], f["pa"], f["gc"], invmu, *win, offs, ks,
                wcfg, tables, **kw),
            "virial_sweep": lambda k: (
                pwt.virial_sweep if k else pwt.virial_sweep_plain)(
                frame, f["pp"], f["pa"], f["gc"], invmu, *win, offs, ks,
                wcfg, tables, **kw),
            "phase1_rows": lambda k: (
                pw.phase1_rows_sweep if k else pw.phase1_rows_sweep_plain)(
                frame, *win, grid, ks, wcfg, tables),
            "phase2_rows": lambda k: (
                pw.phase2_rows_sweep if k else pw.phase2_rows_sweep_plain)(
                frame, f["pp"], f["pa"], f["gc"], f["mu"], *win, grid, ks,
                wcfg, tables, **kw),
            "virial_rows": lambda k: (
                pw.virial_rows_sweep if k else pw.virial_rows_sweep_plain)(
                frame, f["pp"], f["pa"], f["gc"], f["mu"], *win, grid, ks,
                wcfg, tables, **kw),
        }
        for kname, run in sweeps.items():
            got, want = run(True), run(False)
            torch.cuda.synchronize()
            for r in range(want.shape[0]):
                scale = float(want[r].abs().max())
                err = float((got[r] - want[r]).abs().max())
                if not torch.allclose(got[r], want[r], rtol=1e-12,
                                      atol=1e-12 * scale):
                    fail(f"{kname} on a plane-padded frame ({name}), row "
                         f"{r}: {err:.3e} from the plain version (scale "
                         f"{scale:.3e})")
                if scale > 0:
                    worst[kname] = max(worst.get(kname, 0.0), err / scale)
        worst[name] = (f"{frame.pos.shape[0]} rows, {nz} planes, "
                       f"{int(plane_pad.sum())} plane pads ({in_rings} in "
                       f"receivers' ring runs), {ghost_rows} ghost rows, "
                       f"{spans} windows across a plane end")
    return worst


def check_virial_rows(kname, case, want, wcfg):
    for r in range(9):
        live = r in (0, 1, 3, 4) or not wcfg.planar
        if live != (float(want[r].abs().max()) > 0):
            fail(f"{kname} case {case!r}: row {r} is "
                 f"{'all zero' if live else 'not zero'}")


# ---------------------------------------------------------------------------
# phase 3b: float instances on the main-path frames
# ---------------------------------------------------------------------------


def judge(kname, k32, p32, p64, count_row=None):
    """The float32 kernel must be as close to the float64 evaluation as the
    plain float32 version is (x8, plus 1e-6 of the row's scale): both round
    every term to float32 and sum some tens of them, in another order, with
    rsqrt approximated in float32.  A neighbour-count row is held to the
    plain float32 count instead: equal but for +-1 at no more than 1e-5 of
    the receivers (a pair within one float32 rounding of the support radius
    may fall either side: the kernel's rij2 is a fused multiply-add).
    Returns the largest |kernel - plain| over the other rows."""
    worst = 0.0
    if count_row is not None:
        d = (k32[count_row] - p32[count_row]).abs()
        if not (float(d.max()) <= 1 and int((d > 0).sum()) <= 1e-5 * d.numel()):
            fail(f"{kname} float32 on the main-path frame: neighbour "
                 f"counts differ by up to {float(d.max())} at {int((d > 0).sum())} receivers")
    for r in range(p64.shape[0]):
        if r == count_row:
            continue
        scale = float(p64[r].abs().max())
        err_k = float((k32[r].double() - p64[r]).abs().max())
        err_p = float((p32[r].double() - p64[r]).abs().max())
        worst = max(worst, float((k32[r] - p32[r]).abs().max()))
        if not err_k <= 8 * err_p + 1e-6 * scale:
            fail(f"{kname} float32 on the main-path frame, row {r}: "
                 f"kernel is {err_k:.3e} from the float64 result, the plain version "
                 f"{err_p:.3e} (scale {scale:.3e})")
    return worst


def kernel_row(name, source, replaces, run, plain, plain64, nbytes, flops,
               count_row=None):
    """Check one float32 kernel against its plain version (judged against
    the plain float64 evaluation), time it warm and cold and the plain
    version once warm, and make its entry of the ``kernels`` line."""
    got, want = run(), plain()
    plain_ms = time_ms(plain, 2)
    err = judge(name, got, want, plain64(), count_row)
    ms, cold = time_ms(run, 50), time_ms_cold(run, 10)
    return _row(name, source, replaces, err, ms, cold, plain_ms, nbytes,
                flops)


def main_frame(sim, state):
    """A fresh frame of the state with its windows and a float64 copy, the
    way the step builds it (ghost-extended on a periodic scene,
    plane-padded in 3-D), and the pairs inside the kernel radius (for the
    operations bound)."""
    import torch
    from particlemethod_fsi_tpu_torch.ops.walls import periodic_wrap
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.ops import windows_t as pwt
    from particlemethod_fsi_tpu_torch.ops.packed_engine import SortedFrame

    grid, ks, wcfg = sim._frame_grid, sim.kernels, sim._pcfg
    # as a step builds it: positions wrapped into the domain, extended with
    # the ghost rows of a periodic scene
    pos = periodic_wrap(state.pos, sim._dmin_t, sim._width_t)
    (pos, vel, prop), _, _ = sim._frame_inputs(pos, state.vel, state.prop)
    frame = sim._frame(pos, vel, prop)
    win = pw.compute_windows(frame, grid, wcfg)
    frame64 = SortedFrame(key=frame.key, pos=frame.pos.double(),
                          vel=frame.vel.double(), prop=frame.prop,
                          orig=frame.orig)
    tables64 = type(sim.tables).from_config(sim.cfg, ks, torch.float64,
                                            sim.device)
    offs, _ = pw.row_offsets(grid)
    cnt = pwt.phase1_sweep_plain(frame, *win, offs, ks, wcfg, sim.tables,
                                 support=ks.radius_p, count=True)[pwt.P1_COUNT]
    true_pairs = float(cnt.double().sum())
    table_bytes = (win[0].numel() + win[1].numel()) * 4
    return frame, frame64, win, tables64, true_pairs, table_bytes


def check_and_time_main_frame(sim, state, counting, scene="bench") -> list:
    """Kernels 1-3 in float32 on the field-major main path's own frame
    (``scene``'s), against their plain versions, with times and the
    roofline bound; what kernels 1-3 walk, counted by the checking build
    ``counting``."""
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.ops import windows_t as pwt

    grid, ks, wcfg, tables = (sim._frame_grid, sim.kernels, sim._pcfg,
                              sim.tables)
    frame, frame64, win, tables64, true_pairs, table_bytes = main_frame(
        sim, state)
    offs, _ = pw.row_offsets(grid)
    n = frame.pos.shape[0]
    tested_pairs = float(win[1].double().sum()) * wcfg.block
    runs = pwt.ring_runs(frame, *win, offs, wcfg.block)
    src = "particlemethod_fsi_tpu/ops/pallas_windows_t.py"
    rows = []

    p1 = dict(support=grid.support, count=False)
    run1 = lambda **kw: pwt.phase1_sweep(  # noqa: E731
        frame, *win, offs, ks, wcfg, tables, **{**p1, **kw})
    d3 = int(not sim.cfg.two_dimensional)
    rows.append(kernel_row(
        "phase1_sweep", "phase1_sweep.cu", f"{src}:172", run1,
        lambda: pwt.phase1_sweep_plain(frame, *win, offs, ks, wcfg, tables,
                                       **p1),
        lambda: pwt.phase1_sweep_plain(frame64, *win, offs, ks, wcfg,
                                       tables64, **p1),
        n * BYTES_PER_PARTICLE["phase1_sweep"][d3] + table_bytes,
        true_pairs * FLOP_PER_PAIR["phase1_sweep"][d3]))
    # with the neighbour count (every dump): the reach widens to the support
    rows[0].update(count_ms=time_ms(lambda: run1(count=True), 50),
                   count_cold_l2_ms=time_ms_cold(lambda: run1(count=True), 10))
    # the pre-test's reach is the kernel radius here (uniform radii): the
    # senders passing it are the pairs the kernel's own count finds within
    # that radius (the same rij2), and the plain count's
    own = float(run1(support=ks.radius_p, count=True)[pwt.P1_COUNT]
                .double().sum())
    walk1, _ = ring_walk("phase1_sweep", run1, runs, rows[0], counting,
                         passed=(own, true_pairs))

    # phase 2 and the virial on the fields of phase 1 + EOS: the same
    # float32-valued inputs for all three evaluations
    f1 = pwt.phase1_fields_t(frame, grid, ks, tables, cfg=wcfg, windows=win)
    pp, pa, gc = f1["pressure_p"], f1["pressure_a"], f1["gravity_center"]
    invmu = pwt.inverse_viscosity(f1["mu"])
    kw = dict(volume=sim.volume, two_dimensional=sim.cfg.two_dimensional)
    a32 = (frame, pp, pa, gc, invmu, *win, offs, ks, wcfg, tables)
    a64 = (frame64, pp.double(), pa.double(), gc.double(), invmu.double(),
           *win, offs, ks, wcfg, tables64)
    for name, kernel, plain, line in (
            ("phase2_sweep", pwt.phase2_sweep, pwt.phase2_sweep_plain, 330),
            ("virial_sweep", pwt.virial_sweep, pwt.virial_sweep_plain, 745)):
        rows.append(kernel_row(
            name, f"{name}.cu", f"{src}:{line}",
            lambda k=kernel: k(*a32, **kw), lambda p=plain: p(*a32, **kw),
            lambda p=plain: p(*a64, **kw),
            n * BYTES_PER_PARTICLE[name][d3] + table_bytes,
            true_pairs * FLOP_PER_PAIR[name][d3]))
    walk, passed2 = ring_walk(
        "phase2_sweep", lambda: pwt.phase2_sweep(*a32, **kw), runs, rows[1],
        counting)
    walk3, _ = ring_walk(
        "virial_sweep", lambda: pwt.virial_sweep(*a32, **kw), runs, rows[2],
        counting, passed_as=("kernel 2", passed2))
    print(f"kernels at {SCALE[scene]} ({scene}, pallas_t frame): frame rows {n} "
          f"({_frame_rows(sim, frame)}), window senders "
          f"per receiver {tested_pairs / n:.1f} (kernels 1-3 walk only their "
          f"ring runs); kernel 1: {walk1}; kernel 2: {walk}; kernel 3: "
          f"{walk3}; pairs inside the kernel "
          f"radius per receiver {true_pairs / n:.2f}, longest window "
          f"{int(win[1].max())}; kernel 1 with the neighbour count "
          f"{rows[0]['count_ms']:.4f} ms warm, "
          f"{rows[0]['count_cold_l2_ms']:.4f} cold")
    return rows


def check_and_time_rows_frame(sim, state, counting, scene="bench") -> list:
    """Kernels 4-6 in float32 on the row-major main path's own frame
    (``scene``'s), against their plain versions, with times and the
    roofline bound;
    kernel 4's fields against kernel 1's on the same frame; and what
    kernels 4-6 walk, counted by the checking build ``counting``."""
    import torch
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.ops import windows_t as pwt

    grid, ks, wcfg, tables = (sim._frame_grid, sim.kernels, sim._pcfg,
                              sim.tables)
    frame, frame64, win, tables64, true_pairs, table_bytes = main_frame(
        sim, state)
    n = frame.pos.shape[0]
    src = "particlemethod_fsi_tpu/ops/pallas_pairwise.py"
    rows = []
    p1 = (frame, *win, grid, ks, wcfg, tables)
    runs = pw.ring_runs_rows(frame, *win, grid, wcfg.block)
    d3 = int(not sim.cfg.two_dimensional)
    rows.append(kernel_row(
        "phase1_rows", "phase1_sweep.cu", f"{src}:199",
        lambda: pw.phase1_rows_sweep(*p1),
        lambda: pw.phase1_rows_sweep_plain(*p1),
        lambda: pw.phase1_rows_sweep_plain(frame64, *win, grid, ks, wcfg,
                                           tables64),
        n * BYTES_PER_PARTICLE["phase1_rows"][d3] + table_bytes,
        true_pairs * FLOP_PER_PAIR["phase1_rows"][d3]
        + n * ROWS_FLOP_PER_PARTICLE[d3],
        count_row=pw.P1_COUNT))

    # kernel 4 against kernel 1 on this fresh frame: the same pairs (keys
    # and positions agree on a fresh frame, every family radius lies inside
    # the support) in the same order
    f4 = pw.phase1_fields(frame, grid, ks, tables, cfg=wcfg, windows=win)
    f1 = pwt.phase1_fields_t(frame, grid, ks, tables, cfg=wcfg, windows=win,
                             count=True)
    diff4 = 0.0
    for k in ("density_a", "vol_strain", "divergence", "pressure_p",
              "pressure_a", "neighbor_count"):
        a, b = f4[k].double(), f1[k].double()
        d = float((a - b).abs().max())
        diff4 = max(diff4, d)
        if not d <= 1e-6 * max(float(b.abs().max()), 1e-30):
            fail(f"phase1_rows against phase1_sweep on the main-path "
                 f"frame: {k} differs by {d:.3e}")
    if not torch.equal(f4["neighbor_count"], f1["neighbor_count"]):
        fail("phase1_rows against phase1_sweep on the main-path frame: "
             "neighbour counts differ")
    # the pre-test's reach is the support, the count's radius: the senders
    # passing it are the kernel's own count, and the plain version's
    walk4, _ = ring_walk(
        "phase1_rows", lambda: pw.phase1_rows_sweep(*p1), runs, rows[0],
        counting, passed=(float(f4["neighbor_count"].double().sum()),
                          float(pw.phase1_rows_sweep_plain(*p1)[pw.P1_COUNT]
                                .double().sum())))

    pp, pa, gc, mu = (f4["pressure_p"], f4["pressure_a"],
                      f4["gravity_center"].contiguous(), f4["mu"])
    kw = dict(volume=sim.volume, two_dimensional=sim.cfg.two_dimensional)
    a32 = (frame, pp, pa, gc, mu, *win, grid, ks, wcfg, tables)
    a64 = (frame64, pp.double(), pa.double(), gc.double(), mu.double(),
           *win, grid, ks, wcfg, tables64)
    for name, kernel, plain, source, line in (
            ("phase2_rows", pw.phase2_rows_sweep, pw.phase2_rows_sweep_plain,
             "phase2_sweep.cu", 331),
            ("virial_rows", pw.virial_rows_sweep, pw.virial_rows_sweep_plain,
             "virial_sweep.cu", 676)):
        rows.append(kernel_row(
            name, source, f"{src}:{line}",
            lambda k=kernel: k(*a32, **kw), lambda p=plain: p(*a32, **kw),
            lambda p=plain: p(*a64, **kw),
            n * BYTES_PER_PARTICLE[name][d3] + table_bytes,
            true_pairs * FLOP_PER_PAIR[name][d3]
            + n * ROWS_FLOP_PER_PARTICLE[d3]))
    walk, passed5 = ring_walk(
        "phase2_rows", lambda: pw.phase2_rows_sweep(*a32, **kw), runs,
        rows[1], counting)
    walk6, _ = ring_walk(
        "virial_rows", lambda: pw.virial_rows_sweep(*a32, **kw), runs,
        rows[2], counting, passed_as=("kernel 5", passed5))
    print(f"kernels at {SCALE[scene]} ({scene}, pallas frame, "
          f"{_frame_rows(sim, frame)}):"
          f" kernel 4's fields against kernel "
          f"1's on the same frame: largest difference {diff4:.3e}, neighbour "
          f"counts equal; window senders per receiver "
          f"{float(win[1].double().sum()) * wcfg.block / n:.1f} (kernels 4-6 "
          f"walk only their ring runs); kernel 4: {walk4}; kernel 5: {walk}; "
          f"kernel 6: {walk6}; pairs "
          f"inside the kernel radius per receiver {true_pairs / n:.2f}")
    return rows


def _frame_rows(sim, frame) -> str:
    """What a frame holds: slots, ghost rows with a type, unfilled ghost
    slots, plane pads."""
    n_ext = sim.n_pad + (sim._ghosts.total_capacity
                         if sim._ghosts is not None else 0)
    ghost = (frame.orig >= sim.n_pad) & (frame.orig < n_ext)
    filled = int((ghost & (frame.prop >= 0)).sum())
    return (f"{sim.n_pad} slots, {filled} ghost rows, "
            f"{int(ghost.sum()) - filled} unfilled ghost slots, "
            f"{int((frame.orig >= n_ext).sum())} plane pads")


def ring_walk(name, run, runs, row, counting, passed=None,
              passed_as=None):
    """Two launches of a window kernel must be bit-equal (each
    receiver sums its senders in a fixed order, no atomics), and a third
    through the checking build ``counting`` (``-DFSI_WALK_COUNT``) bit-equal
    to them.  That launch counts in the kernel what it walked: the senders
    its receivers pre-tested, which must be exactly the senders of the ring
    runs that ``runs`` (the plain ``ring_runs`` or ``ring_runs_rows``)
    gives, the warps' pre-test steps, and the senders that passed the
    pre-test.  ``passed`` = (the kernel's own count of the pairs within its
    reach, the plain version's): the senders passing must equal the first
    exactly and the second as the neighbour counts of ``judge`` do (a pair
    within one float32 rounding of the radius may fall either side).
    ``passed_as`` = (another kernel, its count of senders passing): the
    count must equal it exactly (the virial's pre-test is phase 2's).
    Returns the text of those counts on the main-path frame, which also go
    into the kernel's row of the ``kernels`` line, and the count of senders
    passing."""
    import ctypes
    import torch
    from particlemethod_fsi_tpu_torch.ops import cuda_loader

    counts = (ctypes.c_ulonglong * 3)()
    read = getattr(counting, f"fsi_{name.split('_')[0]}_counts")
    a, b = run(), run()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail(f"{name} on the main-path frame: two launches differ by "
             f"{float((a - b).abs().max()):.3e}")
    if read(ctypes.addressof(counts)) != 0:  # clears them
        fail(f"{name}: the checking build's counts could not be read")
    with cuda_loader.using(counting):
        c = run()
    torch.cuda.synchronize()
    if read(ctypes.addressof(counts)) != 0:
        fail(f"{name}: the checking build's counts could not be read")
    if not torch.equal(a, c):
        fail(f"{name} on the main-path frame: the counting build differs by "
             f"{float((a - c).abs().max()):.3e}")
    lo, hi = runs
    length = hi - lo
    n = length.shape[0]
    if counts[0] != int(length.sum()):
        fail(f"{name} on the main-path frame: the kernel pre-tested "
             f"{counts[0]} senders, the receivers' ring runs hold {int(length.sum())}")
    text = ""
    if passed is not None:
        own, plain = passed
        if counts[2] != own or abs(counts[2] - plain) > 1e-5 * n:
            fail(f"{name} on the main-path frame: {counts[2]} senders "
                 f"passed the pre-test; pairs within its reach {own:.0f} by the kernel's count, "
                 f"{plain:.0f} by the plain version's")
        text = (f" (the pairs within its reach: the kernel's count exactly, "
                f"the plain version's {plain / n:.2f})")
    if passed_as is not None:
        other, other_passed = passed_as
        if counts[2] != other_passed:
            fail(f"{name} on the main-path frame: {counts[2]} senders "
                 f"passed the pre-test, {other_passed} in {other} on the same frame")
        text = f" ({other}'s, exactly)"
    warps = n // 32
    tested, steps, npass = counts[0] / n, counts[1] / warps, counts[2] / n
    plain_steps = float(
        length.double().view(warps, 32, -1).max(dim=1).values.sum()) / warps
    row.update(ring_senders_tested_per_receiver=tested,
               pretest_steps_per_warp=steps,
               senders_passed_per_receiver=npass)
    return (f"counted in the checking build (bit-equal): ring senders "
            f"pre-tested per receiver {tested:.2f} (the plain ring runs' "
            f"total, exactly), pre-test steps per warp {steps:.2f} (the "
            f"longest run of 32 lanes, from the plain runs "
            f"{plain_steps:.2f}), senders passing the pre-test per receiver "
            f"{npass:.2f}{text}; two launches bit-equal"), counts[2]


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


def check_small_scene(backend: str, three_d: bool = False):
    """Ten steps of a small scene in float64 on one backend: the card (CUDA
    kernels) against the CPU (plain versions).  The coupled bench scene at
    n_side=24, or with ``three_d`` the 3-D dam break at ``n_side=8``
    (plane-padded frames on the window sweeps; margin 0.5 as the bench, so
    that ``pallas_t`` reuses its frame).  On ``packed`` and ``gather`` the
    card runs the same plain torch ops as the CPU.  Tolerance: the bar the
    repository holds its backends to among themselves (pos rtol 1e-12 /
    atol 1e-15, vel rtol 1e-9 / atol 1e-13): only the order of the pair
    sums differs.  Returns
    the particles, the largest position gap and the rebuilds."""
    from particlemethod_fsi_tpu_torch.config import NumericsConfig
    from particlemethod_fsi_tpu_torch.models import (
        bench_config, bench_grid, dam_break_3d)
    from particlemethod_fsi_tpu_torch.solver import Simulation
    from particlemethod_fsi_tpu_torch.state import to_numpy

    kw = dict(dtype="float64", pallas_block=32, backend=backend)
    if three_d:
        cfg, grid = dam_break_3d(8, numerics=NumericsConfig(
            rebuild_margin=0.5, **kw))
    else:
        cfg, grid = bench_config(**kw), bench_grid(24)
    gpu = Simulation(cfg, grid)
    cpu = Simulation(cfg, grid, device="cpu")
    a = to_numpy(gpu.run_chunk(gpu.state0, 10), gpu.n)
    b = to_numpy(cpu.run_chunk(cpu.state0, 10), cpu.n)
    what = f"small {'3-D ' if three_d else ''}scene ({backend})"
    # the candidate engines pad no planes
    padded = three_d and backend not in ENGINES
    if gpu.rebuilds != cpu.rebuilds or gpu._pad_planes != padded:
        fail(f"{what}: rebuilds card {gpu.rebuilds} cpu {cpu.rebuilds}, "
             f"plane padding {gpu._pad_planes}")
    try:
        np.testing.assert_allclose(a["pos"], b["pos"], rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(a["vel"], b["vel"], rtol=1e-9, atol=1e-13)
    except AssertionError as e:
        fail(f"{what}: card and CPU disagree: {e}")
    if not float(np.abs(a["pos"] - grid.position).max()) > 0:
        fail(f"{what}: nothing moved")
    return gpu.n, float(np.abs(a["pos"] - b["pos"]).max()), gpu.rebuilds


def check_turek_small(backend: str):
    """Ten steps of the Turek channel at l0 = 5 mm (44,000 particles, the
    inlet re-imposed every step, a ghost-extended frame) in float64 on one
    backend: the card against the CPU, at ``check_small_scene``'s bar --
    but for the flag's velocities, held to rtol 1e-9 / atol 2e-12: five
    stiff elastic substeps a step amplify the pair sums' rounding there,
    and two correct float64 engines on the CPU (the JAX package's
    ``packed`` and this port) lie 9.9e-13 m/s apart on those rows after ten
    steps (``tests/test_torch_ghosts.py::test_turek_channel_matches_jax_packed``)."""
    from particlemethod_fsi_tpu_torch.models import build_turek
    from particlemethod_fsi_tpu_torch.state import to_numpy

    kw = dict(dtype="float64", pallas_block=32, backend=backend)
    gpu = build_turek(5e-3, **kw)
    cpu = build_turek(5e-3, device="cpu", **kw)
    # the candidate engines take the minimum image: no ghost plan
    if ((gpu._ghosts is None) != (backend in ENGINES)
            or gpu._ghosts != cpu._ghosts):
        fail(f"turek 44k ({backend}): ghost plans differ")
    a = to_numpy(gpu.run_chunk(gpu.state0, 10), gpu.n)
    b = to_numpy(cpu.run_chunk(cpu.state0, 10), cpu.n)
    if gpu.rebuilds != cpu.rebuilds:
        fail(f"turek 44k ({backend}): rebuilds differ, card {gpu.rebuilds} "
             f"cpu {cpu.rebuilds}")
    flag = (a["prop"] >= 2) & (a["prop"] < 4)
    try:
        np.testing.assert_allclose(a["pos"], b["pos"], rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(a["vel"][~flag], b["vel"][~flag],
                                   rtol=1e-9, atol=1e-13)
        np.testing.assert_allclose(a["vel"][flag], b["vel"][flag], rtol=1e-9,
                                   atol=2e-12)
    except AssertionError as e:
        fail(f"turek 44k ({backend}): card and CPU disagree: {e}")
    return (gpu.n, gpu._ghosts.total_capacity if gpu._ghosts else 0,
            float(np.abs(a["pos"] - b["pos"]).max()),
            float(np.abs(a["vel"][~flag] - b["vel"][~flag]).max()),
            float(np.abs(a["vel"][flag] - b["vel"][flag]).max()), gpu.rebuilds)


def check_turek_growth(backend: str) -> dict:
    """The 44k channel again, card against CPU, float64, in chunks of 1, 1,
    3 and 5 steps, with the ghost plan rebuilt by force on both before the
    last chunk (the path a capacity overflow takes at the command line's
    chunk boundary): the flag's position and velocity gaps after 1, 2, 5
    and 10 steps.
    After one step every row meets ``check_small_scene``'s bar, the flag
    too, so the gap at ten steps is the pair sums' order, grown by the
    flag's stiff substeps; positions and the other rows' velocities meet
    that bar after every chunk, the flag's velocities 2e-12 after ten."""
    from particlemethod_fsi_tpu_torch.models import build_turek
    from particlemethod_fsi_tpu_torch.state import to_numpy

    kw = dict(dtype="float64", pallas_block=32, backend=backend)
    gpu = build_turek(5e-3, **kw)
    cpu = build_turek(5e-3, device="cpu", **kw)
    sg, sc = gpu.state0, cpu.state0
    gaps, done = {}, 0
    for upto in (1, 2, 5, 10):
        if upto == 10:
            if not (gpu.refresh_ghosts(sg, force=True)
                    and cpu.refresh_ghosts(sc, force=True)):
                fail(f"turek 44k ({backend}): a forced refresh did not "
                     "rebuild the plan")
            if gpu._ghosts != cpu._ghosts or gpu.ghost_refreshes != 1:
                fail(f"turek 44k ({backend}): rebuilt plans differ")
        sg = gpu.run_chunk(sg, upto - done)
        sc = cpu.run_chunk(sc, upto - done)
        done = upto
        a, b = to_numpy(sg, gpu.n), to_numpy(sc, cpu.n)
        flag = (a["prop"] >= 2) & (a["prop"] < 4)
        gaps[upto] = (float(np.abs(a["pos"][flag] - b["pos"][flag]).max()),
                      float(np.abs(a["vel"][flag] - b["vel"][flag]).max()))
        try:
            np.testing.assert_allclose(a["pos"], b["pos"], rtol=1e-12,
                                       atol=1e-15)
            rows = ~flag if upto > 1 else slice(None)
            np.testing.assert_allclose(a["vel"][rows], b["vel"][rows],
                                       rtol=1e-9, atol=1e-13)
            np.testing.assert_allclose(a["vel"][flag], b["vel"][flag],
                                       rtol=1e-9, atol=2e-12)
        except AssertionError as e:
            fail(f"turek 44k ({backend}), after {upto} steps in chunks: card "
                 f"and CPU disagree: {e}")
    if gpu.rebuilds != cpu.rebuilds or int(sg.ghost_overflow) != 0:
        fail(f"turek 44k ({backend}), in chunks: rebuilds card "
             f"{gpu.rebuilds} cpu {cpu.rebuilds}, ghost overflow "
             f"{int(sg.ghost_overflow)}")
    return gaps


def _golden(*parts):
    here = os.path.dirname(os.path.abspath(__file__))
    with gzip.open(os.path.join(here, "goldens", *parts), "rt") as f:
        f.readline()
        f.readline()
        return np.loadtxt(f)


def _case_sim(tmp: str, case: str, name: str, gold: str, scene: str,
              backend: str):
    """The ``.boid`` of ``cases/<case>`` through the port's generator (into
    ``tmp``), the golden's own ``.data``, float64 on the card."""
    from particlemethod_fsi_tpu_torch.config import NumericsConfig
    from particlemethod_fsi_tpu_torch.generator import generate_case
    from particlemethod_fsi_tpu_torch.solver import Simulation, load_case

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.exists(os.path.join(tmp, name + ".grid")):
        shutil.copy(os.path.join(here, "cases", case, name + ".boid"), tmp)
        generate_case(os.path.join(tmp, name))
    cfg, grid = load_case(
        os.path.join(here, "goldens", gold, name + ".data"),
        os.path.join(tmp, name + ".grid"), scene=scene,
        numerics=NumericsConfig(dtype="float64", backend=backend))
    return Simulation(cfg, grid), grid


def check_rolling_golden(tmp: str, backend: str, steps: int):
    """The Rolling module (walls rocking about Wall6's centre, the sloshing
    fluid, a clamped post; ``cases/rolling``), float64, ``steps`` steps on
    the card on one backend, against ``goldens/rolling/rolling<steps>``
    written by the reference binary: every row and the wall rows within
    2.0e-5 m (the bars of ``tests/test_golden.py``)."""
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.state import to_numpy

    sim, grid = _case_sim(tmp, "rolling", "rolling", "rolling", "rolling",
                          backend)
    if sim._walls_static:
        fail("rolling golden: the walls are static")
    pw.reset_launch_counts()
    state, done, ok = sim.run_chunk_guarded(sim.state0, steps)
    if (done, ok) != (steps, True):
        fail(f"rolling golden ({backend}): stopped after {done} steps")
    if pw.launch_counts != expect_counts(backend, steps, 0):
        fail(f"rolling golden ({backend}): launch counts {pw.launch_counts}")
    out = to_numpy(state, sim.n)
    gold = _golden("rolling", f"rolling{steps:04d}.prof.gz")
    wall = gold[:, 0].astype(int) == 4
    dp = float(np.abs(out["pos"][:, :2] - gold[:, 1:3]).max())
    dw = float(np.abs(out["pos"][wall, :2] - gold[wall, 1:3]).max())
    if not (dp < 2.0e-5 and dw < 2.0e-5):
        fail(f"rolling golden ({backend}): positions differ by {dp:.3e} m, "
             f"wall rows {dw:.3e} m after {steps} steps")
    return sim.n, dp, dw


def check_bar_golden(tmp: str, backend: str):
    """The bar (``cases/bar``), excited in its first bending mode
    (``apply_initial_velocity_profile``), float64 on the card: its tip
    against the reference binary's trajectory at steps 0, 20, ..., 100,
    within 1 % of the trajectory's peak."""
    from particlemethod_fsi_tpu_torch.state import to_numpy

    sim, grid = _case_sim(tmp, "bar", "bar", "bar", "bar", backend)
    state = sim.apply_initial_velocity_profile(sim.state0)
    x0 = np.asarray(grid.initial_position)
    tip = int(np.argmax(x0[:, 0]))
    here = os.path.dirname(os.path.abspath(__file__))
    gold = np.genfromtxt(os.path.join(here, "goldens", "bar",
                                      "tip_trajectory.csv"),
                         delimiter=",", names=True)
    step, errs = 0, []
    for t_g, uy_g in zip(gold["time"][:6], gold["uy"][:6]):
        target = int(round(t_g / sim.cfg.dt))
        state = sim.run_chunk(state, target - step)
        step = target
        out = to_numpy(state, sim.n)
        errs.append(abs((out["pos"][tip, 1] - x0[tip, 1]) - uy_g))
    peak = float(np.abs(gold["uy"]).max())
    if not (step == 100 and max(errs) < 0.01 * peak):
        fail(f"bar golden ({backend}): tip error {max(errs):.3e} m against "
             f"1 % of the peak {peak:.3e} m through step {step}")
    return sim.n, max(errs), peak


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------


# the kernels of each backend's step, and of its diagnostics
STEP_KERNELS = {"pallas_t": ("phase1_sweep", "phase2_sweep"),
                "pallas": ("phase1_rows", "phase2_rows")}
VIRIAL_KERNEL = {"pallas_t": "virial_sweep", "pallas": "virial_rows"}


def expect_counts(backend: str, steps: int, dumps: int) -> dict:
    """Launch counts of ``steps`` steps and ``dumps`` diagnostics calls on
    one backend: every other kernel at 0 (every kernel, on the candidate
    engines)."""
    from particlemethod_fsi_tpu_torch.ops import windows as pw

    want = dict.fromkeys(pw.launch_counts, 0)
    if backend in ENGINES:
        return want
    for k in STEP_KERNELS[backend]:
        want[k] = steps + dumps
    want[VIRIAL_KERNEL[backend]] = dumps
    return want


def gate3d_case(backend: str, **numerics_kw):
    """``cases/gate3d`` as its ``execute.sh`` runs it: the grid of
    ``gate3d.boid`` through the port's generator (236,160 particles), the
    physics of ``gate3d.data``, scene ``dam``, C8 margin 0.5; float32 on
    ``backend`` (and ``numerics_kw``).  Returns ``(cfg, grid)``."""
    import dataclasses

    from particlemethod_fsi_tpu_torch.config import SCENES, NumericsConfig
    from particlemethod_fsi_tpu_torch.generator import (
        generate_grid, parse_boid_file)
    from particlemethod_fsi_tpu_torch.io.data_file import parse_data_file

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cases",
                        "gate3d")
    grid = generate_grid(parse_boid_file(os.path.join(here, "gate3d.boid")))
    cfg = dataclasses.replace(
        parse_data_file(os.path.join(here, "gate3d.data")),
        scene=SCENES["dam"], two_dimensional=False,
        numerics=NumericsConfig(backend=backend, rebuild_margin=0.5,
                                **numerics_kw))
    return cfg, grid


def build_scene(scene: str, backend: str):
    """A full-size scene on the card, float32, block 64: the bench scene at
    ``n_side=1000``, the Turek channel at ``l0=1e-3``, ``cases/gate3d`` or
    the 3-D dam break at ``n_side=120`` (C8 margin 0.5, as the bench); on a
    candidate engine at the scene's :data:`ENGINE_CAPACITY`."""
    from particlemethod_fsi_tpu_torch.config import NumericsConfig
    from particlemethod_fsi_tpu_torch.models import (
        build_case, build_turek, dam_break_3d)
    from particlemethod_fsi_tpu_torch.solver import Simulation

    kw = dict(backend=backend)
    if backend in ENGINES:
        kw["cell_capacity"] = ENGINE_CAPACITY[scene]
    if scene == "bench":
        return build_case(N_SIDE, **kw)
    if scene == "turek":
        return build_turek(TUREK_L0, **kw)
    if scene == "gate3d":
        return Simulation(*gate3d_case(**kw))
    return Simulation(*dam_break_3d(DAM3D_SIDE, numerics=NumericsConfig(
        rebuild_margin=0.5, **kw)))


def run_path(backend: str, scene: str = "bench"):
    """A full-size scene on one backend: a warm-up chunk and three timed
    chunks through ``run_chunk`` (20 steps each; the 3-D dam's 10 on
    ``pallas_t``, 5 on ``pallas``), with ``refresh_ghosts`` at every chunk
    boundary (timed apart), the launch counts of those steps, ms/step and
    its breakdown by section, and the host time of the extremes read each
    step makes."""
    import torch
    from particlemethod_fsi_tpu_torch.ops import ghosts as gh
    from particlemethod_fsi_tpu_torch.ops import windows as pw

    t0 = time.time()
    sim = build_scene(scene, backend)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    n_want, slots_want, substeps = SCENE_SIZES[scene]
    if sim.n != n_want or sim.n_pad != slots_want:
        fail(f"{scene} path: {sim.n} particles in {sim.n_pad} slots")
    flags = sim._pcfg
    chunk = PATH_CHUNK.get((scene, backend), CHUNK)
    three_d = scene in ("gate3d", "dam3d")
    if (flags.surface_tension or not flags.uniform_ratio
            or flags.planar == three_d or sim._pad_planes != three_d
            or not flags.uniform_radii or flags.block != 64
            or sim.dtype != torch.float32 or sim.cfg.substeps != substeps
            or sim._backend != backend):
        fail(f"{scene} path: unexpected specialization {flags} on "
             f"{sim._backend}")
    ghosts = sim._ghosts.total_capacity if sim._ghosts is not None else 0
    if (scene == "turek") != (ghosts > 0):
        fail(f"{scene} path: {ghosts} ghost rows")

    pw.reset_launch_counts()
    state = sim.run_chunk(sim.state0, chunk)  # warm-up
    torch.cuda.synchronize()
    chunk_ms, refresh_ms = [], []
    for c in range(TIMED_CHUNKS):
        t0 = time.time()
        sim.refresh_ghosts(state)
        refresh_ms.append((time.time() - t0) * 1e3)
        if c == TIMED_CHUNKS - 1:
            sim.profile_events = []
        torch.cuda.synchronize()
        t0 = time.time()
        state = sim.run_chunk(state, chunk)
        torch.cuda.synchronize()
        chunk_ms.append((time.time() - t0) * 1e3 / chunk)
    events, sim.profile_events = sim.profile_events, None
    counts = dict(pw.launch_counts)
    steps = chunk * (TIMED_CHUNKS + 1)
    # the extremes each step reads (with the C8 predicate on pallas_t, on
    # their own on pallas): a reduction and a read of six numbers
    invalid = state.prop < 0
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(chunk):
        sim._read(gh.valid_extremes(state.pos, invalid))
    read_ms = (time.time() - t0) * 1e3 / chunk

    if not bool(torch.isfinite(state.pos).all()):
        fail(f"{scene} path: positions are not all finite")
    if tuple(state.pos.shape) != (sim.n_pad, 3):
        fail(f"{scene} path: positions have shape {tuple(state.pos.shape)}")
    if counts != expect_counts(backend, steps, 0):
        fail(f"{scene} path ({backend}): launch counts {counts} after {steps} "
             f"steps")
    # the field-major backend reuses its frame under the C8 margin; the
    # row-major one rebuilds every step
    if backend == "pallas_t" and not 0 < sim.rebuilds < steps:
        fail(f"{scene} path: {sim.rebuilds} rebuilds in {steps} steps")
    if backend == "pallas" and sim.rebuilds != steps:
        fail(f"{scene} path (pallas): {sim.rebuilds} rebuilds in {steps} "
             f"steps")
    if abs(float(state.time) - steps * sim.cfg.dt) > 1e-3 * steps * sim.cfg.dt:
        fail(f"{scene} path: time {float(state.time)} after {steps} steps")
    if int(state.ghost_overflow) != 0 or sim.ghost_refreshes != 0:
        fail(f"{scene} path: ghost overflow {int(state.ghost_overflow)}, "
             f"{sim.ghost_refreshes} plan rebuilds")
    speed = float(state.vel[: sim.n].norm(dim=1).max())
    if scene != "turek":
        fell = float((sim.state0.pos[: sim.n, 1]
                      - state.pos[: sim.n, 1]).max())
        # free fall over 80 steps of 1e-4 s: g t^2 / 2 = 3.1e-4 m, v = 0.078
        # m/s
        if not (0 < speed < 5.0 and 0 < fell < 5e-3):
            fail(f"{scene} path: max speed {speed}, largest drop {fell}")
    else:
        # the channel flows at 1 m/s on the centre line, 1.5 m/s at the
        # inlet: the fluid's mean x velocity stays near 2/3 of the centre
        fluid = (state.prop == 1) | (state.prop == 0)
        mean_vx = float(state.vel[fluid, 0].mean())
        if not (0 < speed < 5.0 and 0.3 < mean_vx < 1.0):
            fail(f"turek path: max speed {speed}, mean fluid vx {mean_vx}")

    # where the step's time goes: intervals between the marks of each step
    label = {"read": ("inlet, wrap, extremes, rebuild test and the read"
                      if backend == "pallas_t"
                      else "inlet, wrap, extremes and the read"),
             "ghost rows": "ghost rows (extracted on a rebuild, refreshed "
                           "from their sources on a skip)",
             "frame": ("sort and windows (rebuilds) or the cached gather"
                       if backend == "pallas_t"
                       else "sort and windows (every step)"),
             "phase1": "phase 1 + EOS",
             "ghost fields": "ghost rows' fields from their sources",
             "phase2": "phase 2",
             "integrate": "gravity, unsort, kick, convection",
             "solid": "elastic solid"}
    breakdown = {label[k]: v
                 for k, v in section_breakdown(events, chunk).items()}
    ms = float(np.median(chunk_ms))
    print(f"{scene} path ({backend}): {sim.n} particles ({sim.n_pad} slots, "
          f"{ghosts} ghost rows), float32, set-up {setup_s:.1f} s, {steps} "
          f"steps, rebuilds {sim.rebuilds}, ghost plan rebuilds "
          f"{sim.ghost_refreshes}, launches {json.dumps(counts)}, ms/step by "
          f"chunk {[round(m, 3) for m in chunk_ms]}, median {ms:.3f} "
          f"ms/step, {sim.n / ms * 1e3:.4g} particle-steps/s, max speed "
          f"{speed:.4f} m/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; "
          f"refresh_ghosts at the chunk boundaries (host clock) "
          f"{[round(m, 3) for m in refresh_ms]} ms; the extremes read "
          f"{read_ms:.4f} ms/step (host clock)")
    print(f"{scene} path ({backend}), ms/step by section (CUDA events, last "
          "chunk): " + json.dumps({k: round(v, 4) for k, v in breakdown.items()})
          + f"; sum {sum(breakdown.values()):.3f} of {chunk_ms[-1]:.3f}")
    summary = dict(ms_per_step=ms, chunk_ms=chunk_ms, ghost_rows=ghosts,
                   rebuilds=sim.rebuilds, refreshes=sim.ghost_refreshes,
                   refresh_ms=refresh_ms, extremes_read_ms=read_ms,
                   breakdown=breakdown)
    if scene == "turek":
        state, summary["plan_rebuild"] = time_plan_rebuild(sim, state)
    return sim, state, counts, summary


def time_plan_rebuild(sim, state):
    """A ghost plan rebuilt by force on the 1M channel (host clock: the
    test's read, the positions' copy to the host, the plan, the shift rows),
    then one chunk on the new plan (ms/step, the C8 cache rebuilt at its
    first step), held to the channel's sanity bars."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    if not sim.refresh_ghosts(state, force=True) or sim.ghost_refreshes != 1:
        fail("turek path: a forced refresh did not rebuild the plan")
    rebuild_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    state = sim.run_chunk(state, CHUNK)
    torch.cuda.synchronize()
    after_ms = (time.time() - t0) * 1e3 / CHUNK
    fluid = (state.prop == 1) | (state.prop == 0)
    mean_vx = float(state.vel[fluid, 0].mean())
    if (not bool(torch.isfinite(state.pos).all())
            or int(state.ghost_overflow) != 0 or not 0.3 < mean_vx < 1.0):
        fail(f"turek path after a plan rebuild: overflow "
             f"{int(state.ghost_overflow)}, mean fluid vx {mean_vx}")
    print(f"turek path ({sim._backend}): the ghost plan rebuilt by force "
          f"in {rebuild_ms:.3f} ms (host clock; {sim._ghosts.total_capacity} "
          f"ghost rows now), the next chunk {after_ms:.3f} ms/step")
    return state, dict(ms=rebuild_ms, ghost_rows=sim._ghosts.total_capacity,
                       next_chunk_ms_per_step=after_ms)


def time_diagnostics(sim, state, backend: str, scene: str = "bench") -> dict:
    """The split of one ``diagnostics`` call on a full-size scene, after a
    warm-up call; the launch counts of that one call."""
    import torch
    from particlemethod_fsi_tpu_torch.ops import windows as pw

    sim.diagnostics(state)  # warm-up
    pw.reset_launch_counts()
    sim.profile_events = []
    torch.cuda.synchronize()
    t0 = time.time()
    d = sim.diagnostics(state)
    total_ms = (time.time() - t0) * 1e3
    counts = dict(pw.launch_counts)
    events, sim.profile_events = sim.profile_events, None
    if counts != expect_counts(backend, 0, 1):
        fail(f"diagnostics at {SCALE[scene]} ({scene}, {backend}): launch counts "
             f"{counts}")
    spans = {name: a.elapsed_time(b)
             for (_, a), (name, b) in zip(events, events[1:])}
    host = {k: v * 1e3 for k, v in sim.last_diagnostics_seconds.items()}
    device_ms = sum(spans.values())
    if not (np.isfinite(d["virial_pressure"]).all()
            and float(np.abs(d["virial_pressure"]).max()) > 0):
        fail(f"diagnostics at {SCALE[scene]}: virial pressure is zero or not "
             "finite")
    print(f"diagnostics at {SCALE[scene]} ({scene}, {backend}), ms by section of one "
          "call (CUDA "
          "events): " + json.dumps({k: round(v, 3) for k, v in spans.items()})
          + f"; device sum {device_ms:.3f}; host clock: device work and "
          f"copies to the host {host['device_and_copies']:.1f}, numpy "
          f"assembly {host['host_assembly']:.1f}, whole call {total_ms:.1f}; "
          f"launches {json.dumps(counts)}")
    return counts


def run_engine_path(backend: str, scene: str):
    """A full-size scene on a candidate engine (``packed`` or ``gather``,
    plain torch ops), float32, at the scene's :data:`ENGINE_CAPACITY`: a
    warm-up chunk and three timed chunks of 20 steps (the 3-D dam's 5)
    through ``run_chunk``, as :func:`run_path`.  Fails where any step met a cell
    past the capacity (``Simulation.peak_occupancy``: that step dropped
    pairs), where a window kernel was launched, or where the scene's sanity
    bars fail.  Prints ms/step, particle-steps/s, the peak of device memory
    and the fullest cell against the capacity."""
    import torch
    from particlemethod_fsi_tpu_torch.ops import packed_engine as pk
    from particlemethod_fsi_tpu_torch.ops import windows as pw

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sim = build_scene(scene, backend)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    n_want, slots_want, substeps = SCENE_SIZES[scene]
    cap = ENGINE_CAPACITY[scene]
    if (sim.n != n_want or sim.n_pad != slots_want or sim._backend != backend
            or sim.cell_capacity != cap or sim._ghosts is not None
            or sim._pad_planes or sim._margin_cached
            or sim.dtype != torch.float32 or sim.cfg.substeps != substeps):
        fail(f"{scene} path ({backend}): {sim.n} particles in {sim.n_pad} "
             f"slots on {sim._backend}, capacity {sim.cell_capacity}")
    s0 = sim.state0
    f0 = pk.sort_frame(s0.pos, s0.vel, s0.prop, sim.cell_grid,
                       with_cell_start=True)
    occ0 = f0.cell_start[1:] - f0.cell_start[:-1]
    occupancy0 = int(occ0.max())
    full0 = int((occ0 == occupancy0).sum())
    del f0, occ0

    chunk = PATH_CHUNK.get((scene, backend), CHUNK)
    pw.reset_launch_counts()
    state = sim.run_chunk(sim.state0, chunk)  # warm-up
    torch.cuda.synchronize()
    chunk_ms = []
    for c in range(TIMED_CHUNKS):
        if c == TIMED_CHUNKS - 1:
            sim.profile_events = []
        torch.cuda.synchronize()
        t0 = time.time()
        state = sim.run_chunk(state, chunk)
        torch.cuda.synchronize()
        chunk_ms.append((time.time() - t0) * 1e3 / chunk)
    events, sim.profile_events = sim.profile_events, None
    counts = dict(pw.launch_counts)
    steps = chunk * (TIMED_CHUNKS + 1)
    peak = int(sim.peak_occupancy)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    what = f"{scene} path ({backend})"
    if peak > cap:
        fail(f"{what}: a cell held {peak} particles against the capacity "
             f"{cap}: pairs were dropped on a timed path")
    if any(counts.values()):
        fail(f"{what}: window kernels launched: {counts}")
    if sim.rebuilds != steps or sim.ghost_refreshes != 0:
        fail(f"{what}: {sim.rebuilds} rebuilds in {steps} steps, "
             f"{sim.ghost_refreshes} plan rebuilds")
    if not bool(torch.isfinite(state.pos).all()):
        fail(f"{what}: positions are not all finite")
    if abs(float(state.time) - steps * sim.cfg.dt) > 1e-3 * steps * sim.cfg.dt:
        fail(f"{what}: time {float(state.time)} after {steps} steps")
    speed = float(state.vel[: sim.n].norm(dim=1).max())
    if scene != "turek":
        fell = float((sim.state0.pos[: sim.n, 1]
                      - state.pos[: sim.n, 1]).max())
        if not (0 < speed < 5.0 and 0 < fell < 5e-3):
            fail(f"{what}: max speed {speed}, largest drop {fell}")
    else:
        fluid = (state.prop == 1) | (state.prop == 0)
        mean_vx = float(state.vel[fluid, 0].mean())
        if not (0 < speed < 5.0 and 0.3 < mean_vx < 1.0):
            fail(f"{what}: max speed {speed}, mean fluid vx {mean_vx}")

    label = {"read": "inlet, wrap (and the guard's read)",
             "frame": "sort with cell offsets",
             "neighbors": "neighbour list (sort, cell table, candidates, "
                          "compaction to K)",
             "candidates": "candidates tested and compacted",
             "phases 1 and 2": "phases 1 + EOS and 2",
             "phase1": "edge context and phase 1 + EOS",
             "phase2": "phase 2", "integrate": "gravity, unsort, kick, "
                                               "convection",
             "solid": "elastic solid"}
    breakdown = {label[k]: v
                 for k, v in section_breakdown(events, chunk).items()}
    ms = float(np.median(chunk_ms))
    print(f"{what}: {sim.n} particles ({sim.n_pad} slots), float32, cell "
          f"capacity {cap}, set-up {setup_s:.1f} s, {steps} steps, rebuilds "
          f"{sim.rebuilds}, ms/step by chunk {[round(m, 3) for m in chunk_ms]},"
          f" median {ms:.3f} ms/step, {sim.n / ms * 1e3:.4g} "
          f"particle-steps/s, peak device memory {peak_mib:.0f} MiB; fullest "
          f"cell {occupancy0} at step 0 ({full0} cells), {peak} over the "
          f"{steps} steps, capacity {cap}; window kernels launched "
          f"{sum(counts.values())}; max speed {speed:.4f} m/s")
    print(f"{what}, ms/step by section (CUDA events, last chunk): "
          + json.dumps({k: round(v, 4) for k, v in breakdown.items()})
          + f"; sum {sum(breakdown.values()):.3f} of {chunk_ms[-1]:.3f}")
    return sim, state, dict(
        ms_per_step=ms, chunk_ms=chunk_ms, particle_steps_per_s=sim.n / ms
        * 1e3, peak_memory_mib=peak_mib, capacity=cap,
        occupancy_step0=occupancy0, cells_full_step0=full0,
        occupancy_peak=peak, rebuilds=sim.rebuilds, breakdown=breakdown)


def check_force_gap(state) -> dict:
    """One step's force on the 1M bench state ``state`` (wrapped as a step
    wraps it) on ``packed`` and on ``gather`` (cell capacity 16) against
    ``pallas_t``'s, each from a fresh frame (not the C8 cache), in float32
    and in float64, over the particles (the padding rows' forces are never
    used, and the packed engine, as the JAX one, computes some there).

    Float64 is the test: the engines' forces must lie within 1e-9 of the
    largest force of ``pallas_t``'s, where only the order of the sums
    differs; a dropped or doubled pair is a whole pair term off.  Float32
    is printed, against float32 ``pallas_t`` and against the float64
    force: the force is a small difference of large pressure terms, and the
    candidate engines take the minimum image of every separation (one
    rounding of the domain's width), so their float32 gap is rounding, not
    pairs.  Fails also where a cell of the state holds more than 16."""
    import torch
    from particlemethod_fsi_tpu_torch.models import bench_config, bench_grid
    from particlemethod_fsi_tpu_torch.ops import walls as wl
    from particlemethod_fsi_tpu_torch.solver import Simulation

    valid = state.prop >= 0
    grid = bench_grid(N_SIDE)
    forces, occupancy = {}, {}
    for dtype in ("float64", "float32"):
        for backend in ("pallas_t", *ENGINES):
            kw = {"cell_capacity": ENGINE_CAPACITY["bench"]} if (
                backend in ENGINES) else {}
            sim = Simulation(bench_config(backend=backend, dtype=dtype, **kw),
                             grid)
            pos = wl.periodic_wrap(state.pos.to(sim.dtype), sim._dmin_t,
                                   sim._width_t)
            with torch.no_grad():
                forces[backend, dtype] = sim._force(
                    pos, state.vel.to(sim.dtype),
                    state.prop)[0][valid].double()
            occupancy[backend] = int(sim.peak_occupancy)
            del sim
    torch.cuda.empty_cache()
    ref64 = forces["pallas_t", "float64"]
    ref32 = forces["pallas_t", "float32"]
    scale = float(ref64.abs().max())

    def gap(a, b):
        return float((a - b).abs().max()) / scale

    out = {b: dict(float64=gap(forces[b, "float64"], ref64),
                   float32=gap(forces[b, "float32"], ref32),
                   float32_from_float64=gap(forces[b, "float32"], ref64))
           for b in ENGINES}
    out["pallas_t"] = dict(float32_from_float64=gap(ref32, ref64))
    if any(occupancy[b] > ENGINE_CAPACITY["bench"] for b in ENGINES):
        fail(f"force at 1M: cells past the capacity {occupancy}")
    for b in ENGINES:
        if not out[b]["float64"] <= 1e-9:
            fail(f"force at 1M ({b}, float64): {out[b]['float64']:.3e} of the "
                 "largest force from pallas_t's: pairs differ")
    print(f"force at 1M (the bench state after the packed path, "
          f"{int(valid.sum())} particles, a fresh frame each; largest force "
          f"{scale:.4e}): largest gap over it, of each engine from pallas_t "
          f"in float64 (bar 1e-9) and float32, and of each float32 force "
          f"from float64 pallas_t's: "
          + json.dumps({b: {k: f"{v:.3e}" for k, v in d.items()}
                        for b, d in out.items()})
          + f"; fullest cell {occupancy['packed']}")
    return out


def check_huge_frame_route():
    """Frames of 2^24 cells or more: the bench scene at n_side=24 in a
    domain widened until its cell grid has that many cells, float32 on the
    card.  Built on ``pallas_t`` it must resolve to the row-major kernels and
    step bit for bit like an explicit ``backend="pallas"`` run."""
    import dataclasses

    import torch
    from particlemethod_fsi_tpu_torch.models import bench_config, bench_grid
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.solver import Simulation

    grid = bench_grid(24)
    side = 4200 * 3.1e-3  # 4200^2 > 2^24 cells of the frame's width
    grid = dataclasses.replace(grid, domain_max=np.array(
        [grid.domain_min[0] + side, grid.domain_min[1] + side,
         grid.domain_max[2]]))
    states = {}
    pw.reset_launch_counts()
    for backend in ("pallas_t", "pallas"):
        sim = Simulation(bench_config(backend=backend, pallas_block=32), grid)
        if sim._frame_grid.num_cells < 1 << 24 or sim._backend != "pallas":
            fail(f"huge frame: {sim._frame_grid.num_cells} cells resolved to "
                 f"{sim._backend}")
        states[backend] = sim.run_chunk(sim.state0, 3)
    counts = dict(pw.launch_counts)
    if counts != expect_counts("pallas", 6, 0):
        fail(f"huge frame: launch counts {counts}")
    a, b = states["pallas_t"], states["pallas"]
    if not (torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)):
        fail("huge frame: the automatic route and backend='pallas' differ")
    if not bool(torch.isfinite(a.pos).all()):
        fail("huge frame: positions are not all finite")
    return sim._frame_grid.num_cells, counts


def time_guarded(sim, state):
    """At 1M on the card: guarded against unguarded chunks, in turns within
    this one call (unguarded, guarded, guarded, unguarded, twice over)."""
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
    return state


# ---------------------------------------------------------------------------
# phase 4b: the gate case against the reference binary's golden
# ---------------------------------------------------------------------------


def check_gate_golden(tmp: str, backend: str):
    """The coupled gate case (``cases/fsi_gate``), float64, 100 steps on the
    card through ``load_case`` on one backend (``packed`` at cell capacity
    12, as the JAX package's goldens run it), against
    ``goldens/gate/gate100.prof.gz`` written by the reference binary.
    Tolerance: positions within 2.0e-6 m, the bar of the CPU tests (the
    ``%e`` six-digit floor plus drift)."""
    from particlemethod_fsi_tpu_torch.config import NumericsConfig
    from particlemethod_fsi_tpu_torch.generator import generate_case
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.solver import Simulation, load_case
    from particlemethod_fsi_tpu_torch.state import to_numpy

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.exists(os.path.join(tmp, "gate.grid")):
        shutil.copy(os.path.join(here, "cases", "fsi_gate", "gate.boid"), tmp)
        generate_case(os.path.join(tmp, "gate"))
    cfg, grid = load_case(
        os.path.join(here, "goldens", "gate", "gate.data"),
        os.path.join(tmp, "gate.grid"), scene="dam",
        numerics=NumericsConfig(
            dtype="float64", backend=backend,
            cell_capacity=12 if backend in ENGINES else None))
    sim = Simulation(cfg, grid)
    pw.reset_launch_counts()
    state, done, ok = sim.run_chunk_guarded(sim.state0, 100)
    if (done, ok) != (100, True):
        fail(f"gate golden ({backend}): guarded chunk stopped after {done} "
             f"steps")
    if pw.launch_counts != expect_counts(backend, 100, 0):
        fail(f"gate golden ({backend}): launch counts {pw.launch_counts}")
    out = to_numpy(state, sim.n)
    with gzip.open(os.path.join(here, "goldens", "gate",
                                "gate100.prof.gz"), "rt") as f:
        f.readline()
        f.readline()
        gold = np.loadtxt(f)
    dp = float(np.abs(out["pos"][:, :2] - gold[:, 1:3]).max())
    if not dp < 2.0e-6:
        fail(f"gate golden ({backend}): position differs by {dp:.3e} m after "
             f"100 steps")
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


def run_cli_path(tmp: str, backend: str, cli_steps: int, scene="bench"):
    """Write a full-size scene (the bench scene, the Turek channel or
    ``cases/gate3d``) as files, run the command line on them on the card
    with ``--backend`` for one output interval of ``cli_steps`` steps, and
    check what it wrote."""
    import torch
    from particlemethod_fsi_tpu_torch import cli
    from particlemethod_fsi_tpu_torch.io import native
    from particlemethod_fsi_tpu_torch.io.data_file import write_data_file
    from particlemethod_fsi_tpu_torch.io.grid_file import (
        GridData, read_grid_file, write_grid_file)
    from particlemethod_fsi_tpu_torch.io.vtk_writer import write_vtk_file
    from particlemethod_fsi_tpu_torch.models import (
        bench_config, bench_grid, turek_config, turek_grid)
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.solver import Simulation, load_case
    from particlemethod_fsi_tpu_torch.state import to_numpy

    tmp = os.path.join(tmp, f"{scene}-{backend}")
    os.makedirs(tmp)
    j = lambda name: os.path.join(tmp, name.replace("bench", scene))  # noqa: E731
    if scene == "bench":
        # a candidate engine at the capacity the command line gives it in
        # 2-D (16: the scene's fullest cells), not bench.py's 12
        kw = {"cell_capacity": 16} if backend in ENGINES else {}
        cfg0, grid0, module, margin = (bench_config(backend=backend, **kw),
                                       bench_grid(N_SIDE), "dam", "0.5")
    elif scene == "gate3d":
        cfg0, grid0 = gate3d_case(backend)
        module, margin = "dam", "0.5"
    else:
        cfg0, grid0, module, margin = (turek_config(TUREK_L0, backend=backend),
                                       turek_grid(TUREK_L0), "turek_hron",
                                       "1.0")
    interval = cli_steps * cfg0.dt
    want_cfg = cfg0.replace(output_interval=interval,
                            vtk_output_interval=interval, end_time=interval)
    write_data_file(want_cfg, j("bench.data"))
    t0 = time.time()
    write_grid_file(grid0, j("bench.grid"))
    write_s = time.time() - t0
    t0 = time.time()
    cfg, grid = load_case(j("bench.data"), j("bench.grid"), scene=module,
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
            j("bench%03d.vtk"), j("bench.log"), "4", "--scene", module,
            "--backend", backend, "--rebuild-margin", margin, "--dtype",
            "float32", "--metrics", j("metrics.jsonl")]
    pw.reset_launch_counts()
    t0 = time.time()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    counts = dict(pw.launch_counts)
    if rc != 0:
        fail(f"cli path: return code {rc}")

    last = f"{cli_steps:03d}"
    for name in ("bench000.prof", f"bench{last}.prof", "bench000.vtk",
                 f"bench{last}.vtk", "bench.log", "metrics.jsonl"):
        if not os.path.getsize(j(name)) > 0:
            fail(f"cli path: {name} is missing or empty")
    log = open(j("bench.log")).read()
    if ("platform: cuda" not in log or "WATCHDOG" in log or "GUARD" in log
            or "ghost spec" in log):
        fail(f"cli path: unexpected log:\n{log}")
    metrics = [json.loads(ln) for ln in open(j("metrics.jsonl"))]
    steps = sum(m.get("chunk", 0) for m in metrics)
    dumps = [m for m in metrics if "neighbor_max" in m]
    if steps < cli_steps or len(dumps) != 2:
        fail(f"cli path: {steps} steps and {len(dumps)} dumps in the metrics")
    want_counts = expect_counts(backend, steps, 2)
    if counts != want_counts:
        fail(f"cli path: launch counts {counts}, expected {want_counts}")
    # neighbours within the support (+ margin): some 20-30 in 2-D, 100 in
    # 3-D
    nbr_lo, nbr_hi = (10, 60) if cfg.two_dimensional else (40, 200)
    for m in dumps:
        # no window on the candidate engines; no cell past their capacity
        windows_ok = (m["cell_overflow"] <= 16 and m["window_len"] == 0
                      if backend in ENGINES else m["window_len"] > 0)
        if not (nbr_lo <= m["neighbor_max"] <= nbr_hi
                and np.isfinite(m["max_speed"])
                and 0 <= m["max_speed"] < 5.0 and m["cell_overflow"] > 0
                and windows_ok and m["ghost_overflow"] == 0):
            fail(f"cli path: metrics out of range: {m}")
    if not dumps[1]["max_speed"] > 0:
        fail("cli path: nothing moved")

    # the final .prof is, to the print format, the state of the guarded
    # chunk over the same steps from the same grid: written again with the
    # same writer, the bytes are equal
    sim = Simulation(cfg, grid)
    state, done, ok = sim.run_chunk_guarded(sim.state0, cli_steps)
    if (done, ok) != (cli_steps, True):
        fail(f"cli path: reference chunk stopped after {done} steps")
    h = to_numpy(state, grid.n)
    snap = GridData(time=cli_steps * cfg.dt, spacing=grid.spacing,
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
    ghosts = sim._ghosts.total_capacity if sim._ghosts is not None else 0
    print(f"cli path ({scene}, {backend}): {n} particles, {ghosts} ghost "
          f"rows, {steps} steps, return code 0 in "
          f"{cli_s:.1f} s; launches {json.dumps(counts)}; writer "
          f"{writer} ({native.writer_name()}); .grid {grid_mb:.0f} MB written "
          f"in {write_s:.2f} s and read by load_case in {read_s:.2f} s; "
          f".prof written in {prof_s:.2f} s; .vtk {vtk_mb:.0f} MB written in "
          f"{vtk_s:.2f} s; neighbor_max {dumps[1]['neighbor_max']}, max_speed "
          f"{dumps[1]['max_speed']:.4f} m/s, window_len "
          f"{dumps[1]['window_len']}; the log's buckets [s]: "
          + json.dumps(buckets))
    return counts


# ---------------------------------------------------------------------------
# phase 6b: multi-device over torch.distributed (parallel/), launched as the
# command line launches: one process a rank
# ---------------------------------------------------------------------------

HALO_CHUNK = 20  # steps a chunk of the 1M halo path (a warm-up and three)
ALLGATHER_CHUNK = 10  # the 1M all-gather path (a warm-up of 5 and two)
WAVE_SCALE = 0.46  # models.wave: 1,110,766 particles
WAVE_STEPS = 20
SHARED_SCALE = 0.2  # models.wave: 130,734 particles, two ranks on one card
SHARED_STEPS = 10
MULTI_CLI_STEPS = 20  # the gate case's one output interval


def wave_case(scale: float, dtype: str = "float32"):
    """``cases/wave`` as ``execute.sh`` runs it: the port's lattice
    (``models/wave.py``) at ``scale``, the physics of ``wave.data`` with
    the time steps scaled to the spacing, scene ``dam``, C8 margin 0.5.
    Returns ``(cfg, grid)``."""
    import dataclasses

    from particlemethod_fsi_tpu_torch.config import SCENES, NumericsConfig
    from particlemethod_fsi_tpu_torch.io.data_file import parse_data_file
    from particlemethod_fsi_tpu_torch.models import wave

    dt, edt = wave.steps(scale)
    cfg = dataclasses.replace(
        parse_data_file(wave.DATA_FILE), scene=SCENES["dam"],
        two_dimensional=False, dt=dt, elastic_dt=edt,
        numerics=NumericsConfig(rebuild_margin=0.5, dtype=dtype))
    return cfg, wave.wave_grid(scale)


def hold_at_halo_bars(name: str, got, want, n: int):
    """Two slot-ordered states at the CPU halo tests' bars: types equal,
    positions within rtol 1e-10 and atol 1e-14, velocities within rtol
    1e-8 and atol 1e-13.  Returns the largest position and velocity gaps."""
    import torch

    if not torch.equal(got.prop[:n], want.prop[:n]):
        fail(f"{name}: the types differ")
    gaps = []
    for k, rtol, atol in (("pos", 1e-10, 1e-14), ("vel", 1e-8, 1e-13)):
        a, b = getattr(got, k)[:n].double(), getattr(want, k)[:n].double()
        d = (a - b).abs()
        if not bool((d <= atol + rtol * b.abs()).all()):
            fail(f"{name}: {k} differs by up to {float(d.max()):.3e}")
        gaps.append(float(d.max()))
    return gaps


def section_breakdown(events, steps: int) -> dict:
    """ms/step of each section between a step's CUDA event marks."""
    spans: dict = {}
    for (_, a), (name, b) in zip(events, events[1:]):
        if name != "begin":
            spans[name] = spans.get(name, 0.0) + a.elapsed_time(b)
    return {k: v / steps for k, v in spans.items()}


def halo_frame_rows(sim, runner, state) -> tuple:
    """Kernels 1 and 2 in float32 on one halo frame of ``runner`` (the
    frame a rebuilding step builds from ``state``: own rows, the two x
    ghost strips in the grid's ghost layer, the structure rows), against
    their plain versions at the main path's bars, timed warm and cold, with
    the roofline bound of that frame; and the frame's window lengths."""
    import torch
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.ops import windows_t as pwt
    from particlemethod_fsi_tpu_torch.ops.packed_engine import SortedFrame

    grid, ks, wcfg, tables = (runner.frame_grid, sim.kernels, sim._pcfg,
                              sim.tables)
    frame, win = runner.frame(state)
    frame64 = SortedFrame(key=frame.key, pos=frame.pos.double(),
                          vel=frame.vel.double(), prop=frame.prop,
                          orig=frame.orig)
    tables64 = type(tables).from_config(sim.cfg, ks, torch.float64,
                                        sim.device)
    offs, _ = pw.row_offsets(grid)
    n = frame.pos.shape[0]
    true_pairs = float(pwt.phase1_sweep_plain(
        frame, *win, offs, ks, wcfg, tables, support=ks.radius_p,
        count=True)[pwt.P1_COUNT].double().sum())
    table_bytes = (win[0].numel() + win[1].numel()) * 4
    d3 = int(not sim.cfg.two_dimensional)
    src = "particlemethod_fsi_tpu/ops/pallas_windows_t.py"
    p1 = dict(support=grid.support)
    rows = [kernel_row(
        "phase1_sweep", "phase1_sweep.cu", f"{src}:172",
        lambda: pwt.phase1_sweep(frame, *win, offs, ks, wcfg, tables, **p1),
        lambda: pwt.phase1_sweep_plain(frame, *win, offs, ks, wcfg, tables,
                                       **p1),
        lambda: pwt.phase1_sweep_plain(frame64, *win, offs, ks, wcfg,
                                       tables64, **p1),
        n * BYTES_PER_PARTICLE["phase1_sweep"][d3] + table_bytes,
        true_pairs * FLOP_PER_PAIR["phase1_sweep"][d3])]
    f1 = pwt.phase1_fields_t(frame, grid, ks, tables, cfg=wcfg, windows=win)
    pp, pa, gc = f1["pressure_p"], f1["pressure_a"], f1["gravity_center"]
    invmu = pwt.inverse_viscosity(f1["mu"])
    kw = dict(volume=sim.volume, two_dimensional=sim.cfg.two_dimensional)
    a32 = (frame, pp, pa, gc, invmu, *win, offs, ks, wcfg, tables)
    a64 = (frame64, pp.double(), pa.double(), gc.double(), invmu.double(),
           *win, offs, ks, wcfg, tables64)
    rows.append(kernel_row(
        "phase2_sweep", "phase2_sweep.cu", f"{src}:330",
        lambda: pwt.phase2_sweep(*a32, **kw),
        lambda: pwt.phase2_sweep_plain(*a32, **kw),
        lambda: pwt.phase2_sweep_plain(*a64, **kw),
        n * BYTES_PER_PARTICLE["phase2_sweep"][d3] + table_bytes,
        true_pairs * FLOP_PER_PAIR["phase2_sweep"][d3]))
    keep = ("name", "ms", "cold_l2_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "roofline_share", "bound_bytes")
    windows = dict(rows=n, longest=int(win[1].max()),
                   mean=float(win[1].double().mean()),
                   pairs_per_receiver=true_pairs / n)
    return [{k: r[k] for k in keep} for r in rows], windows


def frame_kernel_ms(sim, grid, frame, win) -> dict:
    """Warm ms of kernels 1 and 2 on a frame (its windows ``win``), timed
    alone: phase 2 on the fields of phase 1 + EOS."""
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.ops import windows_t as pwt

    ks, wcfg, tables = sim.kernels, sim._pcfg, sim.tables
    offs, _ = pw.row_offsets(grid)
    f1 = pwt.phase1_fields_t(frame, grid, ks, tables, cfg=wcfg, windows=win)
    fields = pwt._phase2_inputs_t(f1, wcfg)
    kw = dict(volume=sim.volume, two_dimensional=sim.cfg.two_dimensional)
    return dict(
        phase1_sweep=time_ms(lambda: pwt.phase1_sweep(
            frame, *win, offs, ks, wcfg, tables, support=grid.support), 20),
        phase2_sweep=time_ms(lambda: pwt.phase2_sweep(
            frame, *fields, *win, offs, ks, wcfg, tables, **kw), 20))


def halo_path_1m(comm) -> dict:
    """(a) The halo at 1M (the bench scene), one rank: float64 for 5 steps
    against the one-device pallas_t on the card at the CPU halo bars; then
    float32, a warm-up chunk and three timed chunks, sections by CUDA
    events, launches, rebuilds, overflow (0); kernels 1 and 2 on one halo
    frame; the launches of one diagnostics call on the gathered state."""
    import torch
    from particlemethod_fsi_tpu_torch.models import build_case
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.parallel import halo

    out = {}
    t0 = time.time()
    sim = build_case(N_SIDE, device=comm.device, dtype="float64")
    runner = halo.make_halo_step(sim, comm)
    state = halo.partition_state(sim, comm, runner.hcfg)
    ref = sim.run_chunk(sim.state0, 5)
    state, over = runner.run_chunk(state, 5)
    if over:
        fail(f"halo at 1M (float64): overflow {over}")
    got = halo.to_slot_state(sim, comm, state)
    pos_gap, vel_gap = hold_at_halo_bars("halo at 1M (float64)", got, ref,
                                         sim.n)
    out["float64"] = dict(pos_gap=pos_gap, vel_gap=vel_gap,
                          rebuilds=runner.last_chunk_rebuilds,
                          one_device_rebuilds=sim.last_chunk_rebuilds,
                          seconds=time.time() - t0)
    del sim, runner, state, ref, got
    torch.cuda.empty_cache()

    t0 = time.time()
    sim = build_case(N_SIDE, device=comm.device)
    runner = halo.make_halo_step(sim, comm)
    if runner.engine != "pallas_t" or not runner.use_c8:
        fail(f"halo at 1M: local engine {runner.engine}, C8 {runner.use_c8}")
    state = halo.partition_state(sim, comm, runner.hcfg)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    pw.reset_launch_counts()
    state, over = runner.run_chunk(state, HALO_CHUNK)  # warm-up
    rebuilds = runner.last_chunk_rebuilds
    chunk_ms = []
    for c in range(TIMED_CHUNKS):
        if c == TIMED_CHUNKS - 1:
            sim.profile_events = []
        torch.cuda.synchronize()
        t0 = time.time()
        state, o = runner.run_chunk(state, HALO_CHUNK)
        torch.cuda.synchronize()
        chunk_ms.append((time.time() - t0) * 1e3 / HALO_CHUNK)
        over, rebuilds = max(over, o), rebuilds + runner.last_chunk_rebuilds
    events, sim.profile_events = sim.profile_events, None
    counts = dict(pw.launch_counts)
    steps = HALO_CHUNK * (TIMED_CHUNKS + 1)
    want = dict.fromkeys(counts, 0)
    want.update(phase1_sweep=steps, phase2_sweep=steps)
    if counts != want:
        fail(f"halo at 1M: launch counts {counts} after {steps} steps")
    if over:
        fail(f"halo at 1M: overflow {over}")
    if not 0 < rebuilds < steps:
        fail(f"halo at 1M: {rebuilds} rebuilds in {steps} steps")
    if not bool(torch.isfinite(state.pos).all()):
        fail("halo at 1M: positions are not all finite")
    rows, windows = halo_frame_rows(sim, runner, state)
    for r in rows:
        r["launches"] = steps
        r["frame_rows"] = windows["rows"]
    pw.reset_launch_counts()
    d = sim.diagnostics(halo.to_slot_state(sim, comm, state))
    diag_counts = dict(pw.launch_counts)
    if not np.isfinite(d["virial_pressure"]).all():
        fail("halo at 1M: diagnostics of the gathered state not finite")
    out["float32"] = dict(
        hcfg=tuple(runner.hcfg), frame_rows=runner.n_rows, setup_s=setup_s,
        chunk_ms=chunk_ms, ms_per_step=float(np.median(chunk_ms)),
        rebuilds=rebuilds, steps=steps, overflow=over, launches=counts,
        diagnostics_launches=diag_counts,
        breakdown=section_breakdown(events, HALO_CHUNK), windows=windows,
        peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    return out, rows


def allgather_path_1m(comm) -> dict:
    """(b) The all-gather mode at 1M (the bench scene, one rank, the packed
    engine at cell capacity 16): two steps against the one-device packed
    step, then a warm-up and two timed chunks; no window kernel."""
    import torch
    from particlemethod_fsi_tpu_torch.models import build_case
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.parallel import sharding

    sim = build_case(N_SIDE, device=comm.device, backend="packed",
                     cell_capacity=16)
    run = sharding.make_sharded_runner(sim, comm)
    state = sharding.shard_state(sim, comm, sim.state0)
    pw.reset_launch_counts()
    ref = sim.run_chunk(sim.state0, 2)
    state = run(state, 2)
    gap = float((sharding.gather_state(comm, state).pos - ref.pos)
                .abs().max())
    del ref
    state = run(state, 5)
    chunk_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        state = run(state, ALLGATHER_CHUNK)
        torch.cuda.synchronize()
        chunk_ms.append((time.time() - t0) * 1e3 / ALLGATHER_CHUNK)
    if any(pw.launch_counts.values()):
        fail(f"all-gather at 1M: window kernels launched {pw.launch_counts}")
    if not bool(torch.isfinite(state.pos).all()):
        fail("all-gather at 1M: positions are not all finite")
    if not gap <= 1e-6:
        fail(f"all-gather at 1M: {gap:.3e} m from the one-device step")
    return dict(gap_from_one_device=gap, chunk_ms=chunk_ms,
                ms_per_step=float(np.median(chunk_ms)),
                peak_mib=torch.cuda.max_memory_allocated() / 2**20)


def wave_paths(comm) -> dict:
    """(c) The wave at scale ``WAVE_SCALE`` (3-D, ~1.1M particles), float32:
    one device on pallas_t (plane-padded frame) and the halo at one rank
    (its frame is not plane-padded, as in the JAX package), a warm-up of 2
    steps and ``WAVE_STEPS`` timed each; the window lengths of both frames
    at the start state."""
    import torch
    from particlemethod_fsi_tpu_torch.ops import windows as pw
    from particlemethod_fsi_tpu_torch.parallel import halo
    from particlemethod_fsi_tpu_torch.solver import Simulation

    cfg, grid = wave_case(WAVE_SCALE)
    sim = Simulation(cfg, grid, device=comm.device)
    if sim._ghosts is not None or not sim._pad_planes:
        fail("wave: a periodic axis, or no plane padding, on one device")
    frame = sim._frame(sim.state0.pos, sim.state0.vel, sim.state0.prop)
    win1 = pw.compute_windows(frame, sim._frame_grid, sim._pcfg)
    out = dict(n=sim.n, one_device_windows=dict(
        rows=frame.pos.shape[0], longest=int(win1[1].max()),
        mean=float(win1[1].double().mean())),
        one_device_kernel_ms=frame_kernel_ms(sim, sim._frame_grid, frame,
                                             win1))
    del frame, win1
    state = sim.run_chunk(sim.state0, 2)
    torch.cuda.synchronize()
    t0 = time.time()
    state = sim.run_chunk(state, WAVE_STEPS)
    torch.cuda.synchronize()
    out["one_device_ms"] = (time.time() - t0) * 1e3 / WAVE_STEPS
    one = state
    runner = halo.make_halo_step(sim, comm)
    if runner.engine != "pallas_t":
        fail(f"wave halo: local engine {runner.engine}")
    hstate = halo.partition_state(sim, comm, runner.hcfg)
    _, (_, wl) = runner.frame(hstate)
    out["halo_windows"] = dict(rows=runner.n_rows, longest=int(wl.max()),
                               mean=float(wl.double().mean()))
    hstate, over = runner.run_chunk(hstate, 2)
    torch.cuda.synchronize()
    t0 = time.time()
    hstate, o = runner.run_chunk(hstate, WAVE_STEPS)
    torch.cuda.synchronize()
    out["halo_ms"] = (time.time() - t0) * 1e3 / WAVE_STEPS
    out.update(overflow=max(over, o), rebuilds=runner.last_chunk_rebuilds,
               hcfg=tuple(runner.hcfg))
    if out["overflow"]:
        fail(f"wave halo: overflow {out['overflow']}")
    got = halo.to_slot_state(sim, comm, hstate)
    if not bool(torch.isfinite(got.pos).all()):
        fail("wave halo: positions are not all finite")
    # kernels 1 and 2 on the 3-D halo frame (no plane pads: windows across
    # plane ends), held against their plain versions
    out["halo_kernels"], _ = halo_frame_rows(sim, runner, hstate)
    out["float32_gap_from_one_device"] = float(
        (got.pos[:sim.n] - one.pos[:sim.n]).abs().max())
    return out


def multi_device_rank(comm) -> dict:
    """The one-rank process of phases (a)-(c) (NCCL, the card of rank 0)."""
    a, rows = halo_path_1m(comm)
    return dict(transport=comm.transport, halo=a, rows=rows,
                allgather=allgather_path_1m(comm), wave=wave_paths(comm))


def shared_card_phase() -> dict:
    """(d) Two ranks sharing the card (``gloo-host``): the wave at scale
    ``SHARED_SCALE`` in float64 for ``SHARED_STEPS`` steps through the halo
    at equal-count planes, against one device on the card at the CPU halo
    bars; the structure bit-equal on both ranks, overflow 0; the host time
    of the exchange a step."""
    import torch
    import types

    from particlemethod_fsi_tpu_torch.parallel import halo, launch
    from particlemethod_fsi_tpu_torch.solver import Simulation

    cfg, grid = wave_case(SHARED_SCALE, dtype="float64")
    sim = Simulation(cfg, grid)
    splits = halo.compute_splits(sim, 2, sim.state0.pos, sim.state0.prop >= 0)
    hcfg = halo.default_halo_config(sim, 2, splits=splits)
    ref = sim.run_chunk(sim.state0, SHARED_STEPS)
    job = dict(mode="halo", cfg=cfg, grid=grid, hcfg=tuple(hcfg),
               splits=splits, script=[("run", SHARED_STEPS), ("gather",)])
    t0 = time.time()
    ranks = launch.spawn(launch.run_jobs, 2, [job], transport="gloo-host",
                         timeout=300)
    wall_s = time.time() - t0
    (setup, run, gathered), other = ranks[0]["jobs"][0], ranks[1]["jobs"][0]
    if setup["engine"] != "pallas_t" or run["overflow"]:
        fail(f"shared card: engine {setup['engine']}, overflow "
             f"{run['overflow']}")
    if not np.array_equal(gathered["s_pos"], other[2]["s_pos"]):
        fail("shared card: the structure differs between the two ranks")
    g = gathered["state"]
    slot = dict(prop=np.full(sim.n_pad, -1, np.int32),
                pos=np.zeros((sim.n_pad, 3)), vel=np.zeros((sim.n_pad, 3)))
    for k in slot:
        slot[k][g["oid"]] = g[k]
    got = types.SimpleNamespace(**{k: torch.as_tensor(v).to(sim.device)
                                   for k, v in slot.items()})
    pos_gap, vel_gap = hold_at_halo_bars("shared card (float64)", got, ref,
                                         sim.n)
    return dict(n=sim.n, hcfg=tuple(hcfg), pos_gap=pos_gap, vel_gap=vel_gap,
                step_ms=run["seconds"] * 1e3 / SHARED_STEPS,
                exchange_ms=run["comm_seconds"] * 1e3 / SHARED_STEPS,
                exchanges=run["comm_calls"] / SHARED_STEPS,
                rebuilds=run["rebuilds"], spawn_s=wall_s)


def multichip_cli_phase(tmp: str) -> dict:
    """(e) The command line on the gate case (``cases/fsi_gate``, the grid
    of ``gate.boid`` through the port's generator, 6,724 particles),
    float64, one output interval of 20 steps: ``--mesh 1`` in the halo and
    the all-gather mode against one device (pallas_t for the halo, packed
    for the all-gather, whose engine it is), within 1e-9 and 1e-12 m on
    the ``.prof``; ``--mesh 2`` on the one card returns 1 with the JAX
    command's message and writes no ``.prof``."""
    import re

    from particlemethod_fsi_tpu_torch import cli
    from particlemethod_fsi_tpu_torch.generator import generate_case
    from particlemethod_fsi_tpu_torch.io.grid_file import read_grid_file

    here = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(tmp, "mesh-cli")
    os.makedirs(d)
    shutil.copy(os.path.join(here, "cases", "fsi_gate", "gate.boid"), d)
    generate_case(os.path.join(d, "gate"))
    text = open(os.path.join(here, "cases", "fsi_gate", "gate.data")).read()
    interval = MULTI_CLI_STEPS * 1e-4
    for key in ("OutputInterval", "VtkOutputInterval"):
        text = re.sub(rf"(?m)^{key}\s+\S+", f"{key}\t{interval}", text)
    with open(os.path.join(d, "gate.data"), "w") as f:
        f.write(text)

    def run(tag, *flags):
        out = os.path.join(d, tag)
        os.makedirs(out)
        t0 = time.time()
        rc = cli.main([os.path.join(d, "gate.data"),
                       os.path.join(d, "gate.grid"),
                       os.path.join(out, "g%03d.prof"),
                       os.path.join(out, "g%03d.vtk"),
                       os.path.join(out, "g.log"), "4", "--scene", "dam",
                       "--dtype", "float64", "--end-time", str(interval),
                       *flags])
        return rc, out, time.time() - t0

    res = {}
    profs = {}
    for tag, flags in (("one-pallas_t", ()), ("one-packed", ("--backend",
                                                            "packed")),
                       ("halo", ("--mesh", "1", "--mode", "halo")),
                       ("allgather", ("--mesh", "1", "--mode",
                                      "allgather"))):
        rc, out, secs = run(tag, *flags)
        if rc != 0:
            fail(f"mesh cli ({tag}): exit code {rc}")
        profs[tag] = read_grid_file(os.path.join(
            out, f"g{MULTI_CLI_STEPS:03d}.prof"))
        res[tag] = dict(seconds=secs)
        log = open(os.path.join(out, "g.log")).read()
        if tag in ("halo", "allgather") and (
                f"multi-chip: mode={tag} mesh=1x1 devices platform=cuda"
                not in log or "ranks: 1 processes, transport nccl" not in log):
            fail(f"mesh cli ({tag}): log lines missing:\n{log[-1500:]}")
        if tag == "halo" and "engine=pallas_t" not in log:
            fail("mesh cli (halo): the local engine is not pallas_t")
    for tag, ref, bar in (("halo", "one-pallas_t", 1e-9),
                          ("allgather", "one-packed", 1e-12)):
        gap = float(np.abs(profs[tag].position - profs[ref].position).max())
        if profs[tag].n != 6724 or not gap <= bar:
            fail(f"mesh cli ({tag}): {profs[tag].n} particles, {gap:.3e} m "
                 f"from one device")
        res[tag]["gap"] = gap
    rc, out, _ = run("mesh2", "--mesh", "2")
    log = open(os.path.join(out, "g.log")).read()
    if (rc != 1 or "ERROR: mesh of 2 devices but only 1 visible" not in log
            or any(f.endswith(".prof") for f in os.listdir(out))):
        fail(f"mesh cli (--mesh 2 on one card): exit code {rc}, log "
             f"{log[-500:]!r}")
    res["mesh2_exit_code"] = rc
    return res


def run_multi_device(tmp: str, paths: dict) -> dict:
    """Phases (a)-(e); prints a line each and returns the numbers."""
    import torch
    from particlemethod_fsi_tpu_torch.parallel import launch

    t0 = time.time()
    torch.cuda.empty_cache()
    (res,) = launch.spawn(multi_device_rank, 1, transport="nccl",
                          timeout=900)
    a, b, c = res["halo"], res["allgather"], res["wave"]
    a32 = a["float32"]
    one = paths.get("bench/pallas_t", {}).get("ms_per_step")
    packed = paths.get("bench/packed", {}).get("ms_per_step")
    print(f"halo at 1M (bench, 1 rank, {res['transport']}): float64 5 steps "
          f"against one device on the card: max |pos| {a['float64']['pos_gap']:.3e} m, "
          f"|vel| {a['float64']['vel_gap']:.3e} m/s (bars rtol 1e-10 / 1e-8), "
          f"rebuilds {a['float64']['rebuilds']} ({a['float64']['one_device_rebuilds']} "
          f"on one device); float32: caps {a32['hcfg']}, frame rows "
          f"{a32['frame_rows']}, ms/step by chunk "
          f"{[round(m, 3) for m in a32['chunk_ms']]}, median "
          f"{a32['ms_per_step']:.3f} (one device {one}), rebuilds "
          f"{a32['rebuilds']} in {a32['steps']} steps, overflow "
          f"{a32['overflow']}, launches {json.dumps(a32['launches'])}, a "
          f"diagnostics call's {json.dumps(a32['diagnostics_launches'])}, "
          f"peak {a32['peak_mib']:.0f} MiB")
    print("halo at 1M, ms/step by section (CUDA events, last chunk): "
          + json.dumps({k: round(v, 4) for k, v in a32["breakdown"].items()})
          + f"; the halo frame's windows {json.dumps(a32['windows'])}")
    print(f"all-gather at 1M (bench, 1 rank, packed, capacity 16): "
          f"{b['gap_from_one_device']:.3e} m from one device after 2 steps, "
          f"ms/step by chunk {[round(m, 3) for m in b['chunk_ms']]}, median "
          f"{b['ms_per_step']:.3f} (one-device packed {packed}), peak "
          f"{b['peak_mib']:.0f} MiB")
    print(f"wave at scale {WAVE_SCALE} ({c['n']} particles, 3-D, float32, "
          f"{WAVE_STEPS} steps): one device (plane-padded) "
          f"{c['one_device_ms']:.3f} ms/step, windows "
          f"{json.dumps(c['one_device_windows'])}; halo at 1 rank (not "
          f"padded) {c['halo_ms']:.3f} ms/step, caps {c['hcfg']}, windows "
          f"{json.dumps(c['halo_windows'])} (window_overflow: the longest), "
          f"rebuilds {c['rebuilds']}, overflow {c['overflow']}, float32 gap "
          f"{c['float32_gap_from_one_device']:.3e} m; kernels 1 and 2 warm "
          f"on the padded frame "
          + json.dumps({k: round(v, 4) for k, v in
                        c["one_device_kernel_ms"].items()})
          + ", on the halo frame (held against their plain versions) "
          + json.dumps([{k: r[k] for k in ("ms", "cold_l2_ms", "plain_ms",
                                           "max_abs_err")}
                        for r in c["halo_kernels"]]))
    d = shared_card_phase()
    print(f"two ranks sharing the card (gloo-host; wave at {SHARED_SCALE}, "
          f"{d['n']} particles, float64, {SHARED_STEPS} steps): max |pos| "
          f"{d['pos_gap']:.3e} m, |vel| {d['vel_gap']:.3e} from one device "
          f"(bars rtol 1e-10 / 1e-8), structure bit-equal on both ranks, "
          f"overflow 0, caps {d['hcfg']}; {d['step_ms']:.2f} ms a step on "
          f"rank 0 (host clock), of which the exchange {d['exchange_ms']:.2f} "
          f"({d['exchanges']:.1f} collectives a step); spawn to results "
          f"{d['spawn_s']:.1f} s")
    e = multichip_cli_phase(tmp)
    print(f"mesh cli (gate, float64, {MULTI_CLI_STEPS} steps): --mesh 1 "
          f"--mode halo {e['halo']['gap']:.3e} m from one device (bar 1e-9), "
          f"--mode allgather {e['allgather']['gap']:.3e} (bar 1e-12); seconds "
          + json.dumps({k: round(v['seconds'], 1) for k, v in e.items()
                        if isinstance(v, dict)})
          + f"; --mesh 2 on one card: exit code {e['mesh2_exit_code']}, no "
          f".prof")
    print(f"multi-device phases: {time.time() - t0:.1f} s")
    return dict(halo_1m=a, allgather_1m=b, wave=c, shared_card=d, cli=e,
                rows=res["rows"])


# ---------------------------------------------------------------------------
# phase 7: the packed-bf16 throughput probe (kernel 7)
# ---------------------------------------------------------------------------


PROBE_TRIPS = (1, 7, 64, 512, 513)  # trip counts the probe is checked at
PROBE_TERM_TRIPS = (*range(17), 511, 4095)  # trips its terms are checked at
PROBE_TIMED = 50  # back-to-back launches of a warm timing
PROBE_CURVE = (0, 1, 64, 256, 512, 4096)  # trips the kernel is timed at
# instructions an SM issues a clock: four warp schedulers, one warp each
LANES_ISSUED_PER_SM_CLOCK = 128


def check_microbench() -> dict:
    """Kernel 7 against its plain twin on the card, over the probe's tile at
    each of ``PROBE_TRIPS`` trips (a trip lost or counted twice at the edge
    of a block's range shows), both rounding each operation in the same
    place: float32 rtol 1e-5 and bf16 1e-4 of the largest row sum (the rows
    summed in another order; in bf16 also an rsqrt that rounds to the other
    bf16 neighbour).  Each call is one launch, and two launches give
    bit-equal rows.  Each element's term (the kernel's chain, element by
    element) equals the twin's at the trips ``PROBE_TERM_TRIPS``, on the
    probe's tile and on a tile whose separations reach every branch of the
    chain (r2 <= 0.1, <= 0.25, 1 - q <= 0).  The bf16 instance must also
    stand farther than its bar from the chain in float32 on the float32 tile
    and on the tile rounded to bf16 (a chain rounded once at its end, or not
    at all, lies 4e-3 to 8e-3 of the row sum from the twin): a kernel that
    does not round each operation in bf16 fails here."""
    import torch
    from particlemethod_fsi_tpu_torch.tools import bf16_microbench as mb

    g = torch.Generator().manual_seed(1)
    branchy = (torch.rand((mb.B, mb.W), generator=g) * 4,
               torch.rand((mb.B, mb.W), generator=g) * -4)
    errs = {}
    for dtype, bar in ((torch.float32, 1e-5), (torch.bfloat16, 1e-4)):
        name = str(dtype).split(".")[1]
        x, y = mb.inputs(dtype=dtype)
        worst = 0.0
        for reps in PROBE_TRIPS:
            before = mb.launch_counts["bf16_microbench"]
            got = mb.run(x, y, dtype, reps)
            if mb.launch_counts["bf16_microbench"] != before + 1:
                fail(f"bf16_microbench {name}: a call counted "
                     f"{mb.launch_counts['bf16_microbench'] - before} "
                     "launches, not 1")
            again = mb.run(x, y, dtype, reps)
            want = mb.run_plain(x, y, dtype, reps)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"bf16_microbench {name}: two launches of {reps} trips "
                     "differ")
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            if not (scale > 0 and torch.allclose(got, want, rtol=bar,
                                                 atol=bar * scale)):
                fail(f"bf16_microbench {name}, {reps} trips: max abs err "
                     f"{err:.3e} against scale {scale:.3e}")
            worst = max(worst, err / scale)
            if reps == 64 and dtype == torch.bfloat16:
                got64, scale64 = got, scale
        errs[name] = worst
        checked = 0
        for tile in ((x, y), tuple(t.to(x.device, dtype) for t in branchy)):
            for trip in PROBE_TERM_TRIPS:
                kt, pt = mb.terms(*tile, trip), mb.terms_plain(*tile, trip)
                differ = int((kt != pt).sum())
                if differ:
                    fail(f"bf16_microbench {name}: {differ} terms of trip "
                         f"{trip} differ from the twin's (max "
                         f"{float((kt - pt).abs().max()):.3e})")
                checked += kt.numel()
        errs[f"{name}_terms_equal"] = checked
    x, y = mb.inputs()
    for form, (xf, yf) in (("float32", (x, y)),
                           ("rounded_once", (x.bfloat16().float(),
                                             y.bfloat16().float()))):
        other = mb.run_plain(xf, yf, torch.float32, 64)
        dist = float((got64 - other).abs().max()) / scale64
        if not dist > 1e-4:
            fail(f"bf16_microbench bfloat16: within {dist:.3e} of the chain "
                 f"in float32 ({form}), inside its bar: it does not round "
                 f"in bf16")
        errs[f"bfloat16_from_{form}"] = dist
    return errs


def sm_clock_mhz(fn, seconds: float = 2.0) -> list:
    """The SM clock (MHz) as ``nvidia-smi --query-gpu=clocks.sm`` reads it
    every 100 ms while ``fn()`` runs back to back for ``seconds``."""
    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        end = time.time() + seconds
        while time.time() < end:
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    samples = [float(v) for v in out.split() if v.replace(".", "").isdigit()]
    if not samples:
        fail("nvidia-smi gave no SM clock")
    return samples


def time_microbench() -> dict:
    """The probe's own run (the element throughput of float32 and of packed
    bf16, from the slope between ``LO`` and ``HI`` trips of single launches,
    each timed alone) with its launch count, then kernel 7's entry of the
    ``kernels`` line: the float32 instance at the probe's 512 trips, the
    kernel alone (events around ``PROBE_TIMED`` back-to-back launches
    enqueued while a spin holds the device, so that the host's time a call
    does not set it; without the spin and the host's time a call beside
    it; cold: L2 flushed before each launch), also at each of
    ``PROBE_CURVE`` trips (the fixed cost and the back-to-back slope),
    bound by operations at the published float32 peak and, beside it, by
    instruction issue: the trip loop's machine instructions per
    element-trip over 128 lanes an SM at the SM clock read while launches
    of ``HI`` trips run back to back."""
    import torch
    from particlemethod_fsi_tpu_torch.tools import bf16_microbench as mb

    types = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
    tiles = {name: mb.inputs(dtype=dtype) for name, dtype in types}
    mb.launch_counts["bf16_microbench"] = 0
    thr = {name: mb.throughput(*tiles[name], dtype) for name, dtype in types}
    launches = mb.launch_counts["bf16_microbench"]

    def call(name, dtype):
        return lambda: mb.run(*tiles[name], dtype, mb.REPS)

    x, y = tiles["float32"]
    plain_ms = time_ms(lambda: mb.run_plain(x, y, torch.float32, mb.REPS), 1)
    err = float((call("float32", torch.float32)() - mb.run_plain(
        x, y, torch.float32, mb.REPS)).abs().max())
    ms, host_ms, from_host_ms, per_call, by_trips = {}, {}, {}, {}, {}
    for name, dtype in types:
        fn = call(name, dtype)
        before = mb.launch_counts["bf16_microbench"]
        ms[name] = time_ms(fn, PROBE_TIMED, lead=True)
        from_host_ms[name] = time_ms(fn, PROBE_TIMED)
        per_call[name] = ((mb.launch_counts["bf16_microbench"] - before)
                          / (2 * (PROBE_TIMED + 1)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROBE_TIMED):
            fn()
        host_ms[name] = (time.perf_counter() - t0) / PROBE_TIMED * 1e3
        torch.cuda.synchronize()
        by_trips[name] = {
            reps: time_ms(lambda reps=reps: mb.run(*tiles[name], dtype, reps),
                          PROBE_TIMED, lead=True) for reps in PROBE_CURVE}
    if set(per_call.values()) != {1.0}:
        fail(f"bf16_microbench: launches per call {per_call}, not 1")
    # element throughput of back-to-back launches, the kernel alone
    alone = {name: mb.B * mb.W * (mb.HI - mb.LO)
             / ((t[mb.HI] - t[mb.LO]) * 1e-3) for name, t in by_trips.items()}
    cold = time_ms_cold(call("float32", torch.float32), 5, lead=True)
    clock = sm_clock_mhz(lambda: mb.run(x, y, torch.float32, mb.HI))
    mhz = float(np.median(clock))
    sass = mb.kernel_sass()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    elem_trips = mb.B * mb.W * mb.REPS
    issue_ms = {name: sass[name]["per_element_trip"] * elem_trips
                / (sms * LANES_ISSUED_PER_SM_CLOCK * mhz * 1e6) * 1e3
                for name, _ in types}
    row = _row("bf16_microbench", "bf16_microbench.cu",
               "tools/bf16_microbench.py:55", err, ms["float32"], cold,
               plain_ms, 2 * mb.B * mb.W * 4 + mb.B * 4,
               mb.OPS_PER_ELEMENT * elem_trips)
    row["launches"] = launches
    row.update(bound_issue_ms=issue_ms["float32"],
               issue_share=issue_ms["float32"] / ms["float32"],
               bf16_ms=ms["bfloat16"],
               bf16_bound_issue_ms=issue_ms["bfloat16"],
               bf16_issue_share=issue_ms["bfloat16"] / ms["bfloat16"],
               host_ms_per_call=host_ms["float32"],
               bf16_host_ms_per_call=host_ms["bfloat16"],
               ms_from_host=from_host_ms["float32"],
               bf16_ms_from_host=from_host_ms["bfloat16"],
               ms_by_trips=by_trips,
               elements_per_s_alone_float32=alone["float32"],
               elements_per_s_alone_bfloat16=alone["bfloat16"],
               launches_per_call=per_call["float32"],
               sm_clock_mhz=mhz, sm_clock_samples=len(clock),
               sass_per_element_trip={k: v["per_element_trip"]
                                      for k, v in sass.items()},
               sass_loop={k: v["opcodes"] for k, v in sass.items()},
               elements_per_s_float32=thr["float32"]["elements_per_s"],
               elements_per_s_bfloat16=thr["bfloat16"]["elements_per_s"],
               bf16_over_float32=(thr["bfloat16"]["elements_per_s"]
                                  / thr["float32"]["elements_per_s"]))
    print(f"probe (kernel 7), [{mb.B}, {mb.W}] tile, slope between {mb.LO} "
          f"and {mb.HI} trips: float32 {thr['float32']['elements_per_s'] / 1e9:.1f} "
          f"Gelem/s ({thr['float32']['ns_per_trip']:.3f} ns a trip), packed "
          f"bf16 {thr['bfloat16']['elements_per_s'] / 1e9:.1f} Gelem/s "
          f"({thr['bfloat16']['ns_per_trip']:.3f} ns a trip): bf16 / float32 "
          f"= {row['bf16_over_float32']:.3f}; launches {launches}")
    print(f"probe (kernel 7), one launch of {mb.REPS} trips, the kernel alone "
          f"(mean of {PROBE_TIMED} back-to-back, enqueued behind a device "
          f"spin): float32 {ms['float32']:.4f} ms, cold L2 {cold:.4f} ms; bf16 "
          f"{ms['bfloat16']:.4f} ms; from the host without the spin float32 "
          f"{from_host_ms['float32']:.4f} ms, bf16 "
          f"{from_host_ms['bfloat16']:.4f} ms, the host's time a call "
          f"{host_ms['float32']:.4f} / {host_ms['bfloat16']:.4f} ms; "
          f"launches per call {per_call['float32']:.0f}")
    print(f"probe (kernel 7), the kernel alone by trips (ms): "
          + json.dumps(by_trips) + f"; back-to-back slope between {mb.LO} "
          f"and {mb.HI} trips: float32 {alone['float32'] / 1e9:.1f} Gelem/s, "
          f"bf16 {alone['bfloat16'] / 1e9:.1f} Gelem/s (bf16 / float32 "
          f"{alone['bfloat16'] / alone['float32']:.3f})")
    print(f"probe (kernel 7), trip loop: SASS instructions per element-trip "
          f"float32 {sass['float32']['per_element_trip']:.3f}, bf16 "
          f"{sass['bfloat16']['per_element_trip']:.3f}; SM clock {mhz:.0f} "
          f"MHz (median of {len(clock)} reads, {min(clock):.0f}-"
          f"{max(clock):.0f}); issue-rate bound float32 "
          f"{issue_ms['float32']:.6f} ms ({row['issue_share']:.1%} of it "
          f"reached), bf16 {issue_ms['bfloat16']:.6f} ms "
          f"({row['bf16_issue_share']:.1%}); published float32 bound "
          f"{row['bound_ms']:.6f} ms ({row['roofline_share']:.1%}); loop "
          f"opcodes " + json.dumps(row["sass_loop"]))
    return row


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
    # the library the solver loads and, beside it, the checking build that
    # counts what the window kernels walk: all nvcc processes at once
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        checking = pool.submit(cuda_loader.build, cuda_loader.CSRC_DIR,
                               ("FSI_WALK_COUNT",))
        cuda_loader.load()
        counting = checking.result()
    print(f"build: kernels compiled from csrc/ in {time.time() - t0:.1f} s, "
          f"with the checking build of the ring-run walks (set-up)")
    entry = ""
    for line in cuda_loader.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and "registers" in line:
            print(f"  ptxas: {entry}: {line.split(':', 1)[1].strip()}")
        elif "bytes spill" in line and (
                "phase1" in entry or "phase2" in entry or "virial" in entry
                or "0 bytes spill stores, 0 bytes spill loads" not in line):
            print(f"  ptxas: {entry}: {line.strip()}")
    lib = cuda_loader.load()
    for phase, kernels in (("phase1", "kernels 1 and 4"),
                           ("phase2", "kernels 2 and 5"),
                           ("virial", "kernels 3 and 6")):
        query = getattr(lib, f"fsi_{phase}_occupancy")
        occupancy = {
            f"{'double' if dbl else 'float'},{'rows' if rule else 'key'},"
            f"{'planar' if planar else '3d'}{',st' if st else ''}":
                query(dbl, rule, planar, st, 64)
            for dbl in (0, 1) for rule in (0, 1) for planar in (1, 0)
            for st in (0, 1)}
        print(f"{phase} ({kernels}), resident blocks of 64 threads per "
              "SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
              + json.dumps(occupancy))

    device = torch.device("cuda", 0)
    worst = check_small_cases(device)
    print(f"kernels, double instances on {len(SMALL_CASES)} small seeded "
          f"frames (every branch, 2-D and 3-D), rtol 1e-12: ok; largest "
          f"error over row scale: " + json.dumps(worst))
    pads_err = check_pads_in_windows(device)
    print(f"kernels 4-6 with every pad inside the fluid and in every window "
          f"(double): ok; largest error over row scale {pads_err:.3e}")
    ghost_err = check_ghosts_in_windows(device)
    print("kernels 1-6 on a ghost-extended frame with every unfilled ghost "
          "slot in every window (double, Turek channel at 20 mm): ok; "
          "largest error over row scale: " + json.dumps(ghost_err))
    planes_err = check_planes_in_windows(device)
    print("kernels 1-6 on plane-padded 3-D frames of the solver's frame path "
          "(double; windows across plane ends, plane pads in receivers' ring "
          "runs, ghost rows and plane pads in one frame): ok; largest error "
          "over row scale: " + json.dumps(planes_err))
    probe_err = check_microbench()
    print(f"probe (kernel 7) against its twin at {PROBE_TRIPS} trips: ok, one "
          "launch a call, two launches bit-equal, every term equal to the "
          "twin's (counts below); largest error over the largest row sum: "
          + json.dumps(probe_err))
    if "--kernels-only" in sys.argv[1:]:
        print(card_line)
        return 0

    for backend in ("pallas_t", "pallas"):
        _, pos_err, rebuilds = check_small_scene(backend)
        print(f"small coupled scene ({backend}; 880 particles, float64, 10 "
              f"steps): card against CPU ok, max |pos| difference "
              f"{pos_err:.3e}, rebuilds {rebuilds}")
    for backend in ("pallas_t", "pallas"):
        n_tk, g_tk, pos_err, vel_err, flag_err, rebuilds = check_turek_small(
            backend)
        print(f"turek channel ({backend}; {n_tk} particles, {g_tk} ghost "
              f"rows, float64, 10 steps): card against CPU ok, max |pos| "
              f"difference {pos_err:.3e}, |vel| {vel_err:.3e} (the flag's "
              f"{flag_err:.3e}), rebuilds {rebuilds}")
        gaps = check_turek_growth(backend)
        print(f"turek channel ({backend}; float64, chunks of 1, 1, 3, 5 "
              f"steps, the ghost plan rebuilt by force before the last): "
              f"card against CPU ok; the flag's max |pos| and |vel| "
              f"differences after steps 1, 2, 5, 10: "
              + ", ".join(f"{p:.3e} m and {v:.3e} m/s"
                          for p, v in gaps.values()))

    for backend in ("pallas_t", "pallas"):
        n3, err3, rebuilds3 = check_small_scene(backend, three_d=True)
        print(f"3-D dam break ({backend}; n_side 8, {n3} particles, "
              f"plane-padded frames, float64, 10 steps): card against CPU ok, "
              f"max |pos| difference {err3:.3e}, rebuilds {rebuilds3}")

    # the candidate engines (plain torch ops) on small scenes, card against
    # CPU
    t0 = time.time()
    for backend in ENGINES:
        n_s, pos_err, rebuilds = check_small_scene(backend)
        print(f"small coupled scene ({backend}; {n_s} particles, float64, 10 "
              f"steps): card against CPU ok, max |pos| difference "
              f"{pos_err:.3e}, rebuilds {rebuilds}")
    n_tk, _, pos_err, vel_err, flag_err, rebuilds = check_turek_small("packed")
    print(f"turek channel (packed; {n_tk} particles, the minimum image and no "
          f"ghost rows, float64, 10 steps): card against CPU ok, max |pos| "
          f"difference {pos_err:.3e}, |vel| {vel_err:.3e} (the flag's "
          f"{flag_err:.3e}), rebuilds {rebuilds}")
    n3, err3, rebuilds3 = check_small_scene("packed", three_d=True)
    print(f"3-D dam break (packed; n_side 8, {n3} particles, float64, 10 "
          f"steps): card against CPU ok, max |pos| difference {err3:.3e}, "
          f"rebuilds {rebuilds3}")
    print(f"candidate engines, small scenes: {time.time() - t0:.1f} s")

    tmp = tempfile.mkdtemp(prefix="fsi_smoke_")
    paths, launches = {}, {}
    try:
        for backend in ("pallas_t", "pallas"):
            n_gate, gate_err = check_gate_golden(tmp, backend)
            print(f"gate case ({backend}; {n_gate} particles, float64, 100 "
                  f"steps on the card) against the reference binary's "
                  f"golden: max position difference {gate_err:.3e} m (bar "
                  f"2.0e-6)")
        t0 = time.time()
        n_gate, gate_err = check_gate_golden(tmp, "packed")
        print(f"gate case (packed, cell capacity 12 as the JAX goldens run; "
              f"{n_gate} particles, float64, 100 steps on the card) against "
              f"the reference binary's golden: max position difference "
              f"{gate_err:.3e} m (bar 2.0e-6); {time.time() - t0:.1f} s")
        for backend, steps in (("pallas_t", 500), ("pallas", 100)):
            n_roll, dp, dw = check_rolling_golden(tmp, backend, steps)
            print(f"rolling case ({backend}; {n_roll} particles, rocking "
                  f"walls, float64, {steps} steps on the card) against the "
                  f"reference binary's golden: max position difference "
                  f"{dp:.3e} m, wall rows {dw:.3e} m (bars 2.0e-5)")
        n_bar, tip_err, peak = check_bar_golden(tmp, "pallas_t")
        print(f"bar case (pallas_t; {n_bar} particles, first-mode profile, "
              f"float64, 100 steps on the card): tip within {tip_err:.3e} m "
              f"of the reference binary's trajectory ({tip_err / peak:.3%} "
              f"of its peak {peak:.4e} m; bar 1 %)")

        # each full-size scene on each backend: the field-major backend runs
        # kernels 1-3, the row-major one kernels 4-6; each path is driven
        # with the counts at 0 and read just after, and so is each
        # diagnostics call
        rows = {"bench": [], "turek": [], "gate3d": [], "dam3d": []}
        for scene in rows:
            for backend in ("pallas_t", "pallas"):
                sim, state, counts, paths[f"{scene}/{backend}"] = run_path(
                    backend, scene)
                if backend == "pallas_t":
                    rows[scene] += check_and_time_main_frame(
                        sim, state, counting, scene)
                    if scene == "bench":
                        state = time_guarded(sim, state)
                else:
                    rows[scene] += check_and_time_rows_frame(
                        sim, state, counting, scene)
                diag = time_diagnostics(sim, state, backend, scene)
                for k in counts:
                    if counts[k] or diag[k]:
                        launches[(scene, k)] = counts[k] or diag[k]
                del sim, state
                torch.cuda.empty_cache()
        # the candidate engines at full size, each path driven with the
        # window kernels' counts at 0 and read just after (none may launch)
        t0 = time.time()
        for backend, scene in (("packed", "bench"), ("packed", "turek"),
                               ("packed", "dam3d"), ("gather", "bench"),
                               ("gather", "turek")):
            t1 = time.time()
            sim, state, paths[f"{scene}/{backend}"] = run_engine_path(
                backend, scene)
            if (backend, scene) == ("packed", "bench"):
                time_diagnostics(sim, state, backend, scene)
                bench_state = state
            del sim, state
            torch.cuda.empty_cache()
            print(f"{scene} path ({backend}) phase: {time.time() - t1:.1f} s")
        paths["force_gap_1m"] = check_force_gap(bench_state)
        del bench_state
        torch.cuda.empty_cache()
        print(f"candidate engines at full size: {time.time() - t0:.1f} s")

        cells, _ = check_huge_frame_route()
        print(f"frames of 2^24 cells or more: {cells} cells, pallas_t "
              f"resolved to the row-major kernels, 3 steps bit-equal to "
              f"backend='pallas'")

        cli_counts = run_cli_path(tmp, "pallas_t", CLI_STEPS)
        torch.cuda.empty_cache()
        cli_counts.update({k: v for k, v in run_cli_path(
            tmp, "pallas", CLI_ROWS_STEPS).items() if k.endswith("_rows")})
        torch.cuda.empty_cache()
        turek_cli_counts = run_cli_path(tmp, "pallas_t", CLI_STEPS, "turek")
        torch.cuda.empty_cache()
        gate3d_cli_counts = run_cli_path(tmp, "pallas_t", CLI_STEPS, "gate3d")
        torch.cuda.empty_cache()
        for backend in ENGINES:
            torch.cuda.empty_cache()
            t0 = time.time()
            run_cli_path(tmp, backend, CLI_ROWS_STEPS)
            print(f"cli path (bench, {backend}): {time.time() - t0:.1f} s")
        torch.cuda.empty_cache()
        multi = run_multi_device(tmp, paths)
        paths["multi_device"] = {k: v for k, v in multi.items()
                                 if k != "rows"}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    probe_row = time_microbench()
    # launches: of each backend's step path for the step kernels, of its
    # diagnostics call for the virial; the Turek channel's numbers beside
    # the bench scene's; the command-line paths' counts beside them
    other = {scene: {row["name"]: row for row in rows[scene]}
             for scene in ("turek", "gate3d", "dam3d")}
    scene_cli = {"turek": turek_cli_counts, "gate3d": gate3d_cli_counts}
    for row in rows["bench"]:
        name = row["name"]
        row["launches"] = launches[("bench", name)]
        row["launches_cli_path"] = cli_counts[name]
        for scene in other:
            tk = other[scene][name]
            row[scene] = {k: tk[k] for k in (
                "ms", "cold_l2_ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "roofline_share", "bound_bytes",
                "ring_senders_tested_per_receiver",
                "senders_passed_per_receiver") if k in tk}
            row[scene]["launches"] = launches[(scene, name)]
            if name.endswith("_sweep") and scene in scene_cli:
                row[scene]["launches_cli_path"] = scene_cli[scene][name]
    # kernels 1 and 2 on a halo frame (the 1M bench at one rank): the
    # halo path's launches beside them
    for halo_row in multi["rows"]:
        row = next(r for r in rows["bench"] if r["name"] == halo_row["name"])
        row["halo"] = {k: v for k, v in halo_row.items() if k != "name"}
    rows = rows["bench"] + [probe_row]

    print(json.dumps({"paths": paths}))
    print(card_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
