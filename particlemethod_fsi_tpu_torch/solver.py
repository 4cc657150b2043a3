"""The simulation: setup, the time step, and the chunked run loop.

Counterpart of ``particlemethod_fsi_tpu/solver.py`` on one device, for all
four pairwise backends: the window sweeps ``pallas_t`` (field-major kernels,
``ops/windows_t``; what ``auto`` selects) and ``pallas`` (row-major kernels,
``ops/windows``), which also takes every ``auto``/``pallas_t`` frame of 2^24
cells or more, as in the JAX package; and the candidate engines ``packed``
(``ops/packed_engine``) and ``gather`` (``ops/neighbors.build_neighbor_list``
+ ``ops/edge_math``), plain torch ops.  Ported: ``adjust_domain``,
``Simulation.__init__``, ``_rebuild_ghosts`` (with the 3-D plane padding),
``refresh_ghosts``, ``_is_planar``, ``_initial_structure_neighbors``,
``apply_initial_velocity_profile``, ``_fluid_phase`` (with
``_neighbors``), ``_frame_inputs``, ``_pallas_frame`` (here ``_frame``),
``_propagate_ghost_fields``, ``_force``, ``_margin_cached``,
``_init_cache``, ``_force_cached``, ``_step_core``, ``step``,
``run_chunk``, ``_chunk_guarded`` / ``run_chunk_guarded``,
``_diagnostics`` / ``diagnostics`` and the module function ``load_case``.
Sequence of one step (matching src/main.cpp:592-663):

  inlet profile -> prescribed wall motion (skipped for static walls) ->
  periodic wrap -> ghost rows (periodic scenes on the window sweeps) ->
  frame rebuild or reuse (C8 predicate; ``pallas_t`` only, every other
  backend rebuilds every step; in 3-D the window sweeps' frame is
  plane-padded) -> phase 1 (densities, divergence) + EOS -> ghost fields
  from their sources -> phase 2 (pairwise forces) -> gravity -> velocity
  kick (fluid + structure) -> fluid convection -> elastic substeps.

The candidate engines take the minimum image of every pair and wrap cell
offsets around each axis, so periodic scenes need no ghost rows there; they
keep no frame between steps, pad no planes and have no 2^24-cell route, as
in the JAX package.  A cell holds at most ``cell_capacity`` candidates on
them (rows past it are dropped; ``cell_overflow`` in the diagnostics counts
the fullest cell).

Where the JAX package refreshes its ghost plan only at a chunk boundary
(``refresh_ghosts``), the port also tests the state every step starts from
and rebuilds the plan before that step's forces where pairs span an axis
the plan does not cover, so no step drops such pairs.

Unlike the JAX package, where ``auto`` means ``packed`` off the TPU, the
port's ``auto`` is ``pallas_t`` on any device (its kernels are the card's).

PyTorch runs eagerly, so where the JAX package traces ``lax.cond`` and
``lax.scan`` this module has a Python ``if`` on a few device scalars a step
(one host read) and a Python loop; the guarded chunk's ``lax.while_loop``
is a Python loop whose health scalar rides in the same host read.  Every op
returns new tensors: ``step`` and ``run_chunk`` leave their input state
intact.
"""

from __future__ import annotations

from typing import Optional

import dataclasses
import itertools
import logging
import time as _time

import numpy as np
import torch

from particlemethod_fsi_tpu_torch import state as state_lib
from particlemethod_fsi_tpu_torch.config import SCENES, CaseConfig
from particlemethod_fsi_tpu_torch.io.grid_file import GridData
from particlemethod_fsi_tpu_torch.ops import edge_math as em
from particlemethod_fsi_tpu_torch.ops import fluid as fl
from particlemethod_fsi_tpu_torch.ops import ghosts as gh
from particlemethod_fsi_tpu_torch.ops import packed_engine as pk
from particlemethod_fsi_tpu_torch.ops import solid as sl
from particlemethod_fsi_tpu_torch.ops import walls as wl
from particlemethod_fsi_tpu_torch.ops import windows as pw
from particlemethod_fsi_tpu_torch.ops import windows_t as pwt
from particlemethod_fsi_tpu_torch.ops.neighbors import (
    CellGrid, build_cell_grid, build_neighbor_list)
from particlemethod_fsi_tpu_torch.ops.smoothing import KernelSet, build_kernels
from particlemethod_fsi_tpu_torch.state import ParticleState, Segments
from particlemethod_fsi_tpu_torch.utils.trace import Spans
from particlemethod_fsi_tpu_torch.utils.watchdog import sound_speed_bound


# the backends that sweep windows of a sorted frame with the CUDA kernels
# (ghost rows on periodic axes, plane padding in 3-D); the others are the
# candidate engines
WINDOW_BACKENDS = ("pallas_t", "pallas")
BACKENDS = ("auto", *WINDOW_BACKENDS, "packed", "gather")


def resolve_device(device) -> torch.device:
    """``None`` means the card and raises without one; only an explicit
    ``"cpu"`` selects the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless "
                "device='cpu' is asked for")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def adjust_domain(domain_min, domain_max, spacing: float, two_dimensional: bool):
    """Force the domain to an integer multiple of the particle spacing,
    adjusting DomainMax like the reference (initializeDomain,
    src/main.cpp:1418-1437)."""
    dmin = np.asarray(domain_min, dtype=np.float64).copy()
    dmax = np.asarray(domain_max, dtype=np.float64).copy()
    for d in range(3):
        if two_dimensional and d == 2:
            continue
        width = dmax[d] - dmin[d]
        n = max(1, int(round(width / spacing)))
        if n * spacing != width:
            dmax[d] = dmin[d] + n * spacing
    return dmin, dmax


def _inverse_permutation(orig: torch.Tensor) -> torch.Tensor:
    """``argsort(orig)`` of a permutation, by one scatter."""
    inv = torch.empty_like(orig)
    inv[orig] = torch.arange(orig.shape[0], dtype=orig.dtype,
                             device=orig.device)
    return inv


# rows a block of the structure pair search: a row has a few hundred
# candidates in 3-D, so a block's temporaries stay near a hundred MB
PAIR_SEARCH_BLOCK = 1 << 13


def structure_pairs(p0: np.ndarray, domain_min, domain_width, support: float,
                    device="cpu") -> "tuple[np.ndarray, np.ndarray]":
    """Every ordered pair ``(a, b)``, ``a != b``, of the rows of ``p0``
    (``[n, 3]``, float64) within ``support`` of each other by the periodic
    minimum image, ``b`` taken from the 3x3(x3) cells around ``a``'s on a
    grid of cells at least ``support`` wide that tiles the domain
    (calculateInitialNeighbor, src/main.cpp:1497-1658): two int64 arrays,
    sorted by ``a`` and then ``b``.

    Vectorised over blocks of rows on ``device``.  Each candidate's
    separation is ``d - w * floor(d / w + 0.5)`` and its squared length
    ``(q_x + q_y) + q_z``, one correctly rounded float64 operation at a
    time, as the host's ``np.sum(d * d, axis=1)`` forms it, so the pairs
    are the host's on either device."""
    f64 = dict(dtype=torch.float64, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    n = p0.shape[0]
    p = torch.as_tensor(np.asarray(p0, dtype=np.float64), **f64)
    width = torch.as_tensor(np.asarray(domain_width, dtype=np.float64), **f64)
    dmin = torch.as_tensor(np.asarray(domain_min, dtype=np.float64), **f64)
    nc_h = np.maximum(1, np.floor(np.asarray(domain_width, dtype=np.float64)
                                  / support).astype(np.int64))
    nc = torch.as_tensor(nc_h, **i64)
    rel = (p - dmin) - width * torch.floor((p - dmin) / width)
    cells = torch.minimum(torch.floor(rel / (width / nc)).long(), nc - 1)

    def cell_key(c):
        return (c[..., 0] * nc_h[1] + c[..., 1]) * nc_h[2] + c[..., 2]

    sorted_keys, order = torch.sort(cell_key(cells), stable=True)
    # per axis {-1, 0, 1}, or each cell once on an axis of fewer than three
    offsets = torch.as_tensor(list(itertools.product(
        *[(-1, 0, 1) if c >= 3 else range(c) for c in nc_h])), **i64)
    r2max = support * support
    found = []
    for lo in range(0, n, PAIR_SEARCH_BLOCK):
        rows = torch.arange(lo, min(n, lo + PAIR_SEARCH_BLOCK), **i64)
        near = cell_key((cells[rows, None, :] + offsets) % nc).reshape(-1)
        start = torch.searchsorted(sorted_keys, near)
        count = torch.searchsorted(sorted_keys, near, right=True) - start
        a = torch.repeat_interleave(
            rows.repeat_interleave(offsets.shape[0]), count)
        b = order[torch.repeat_interleave(start - (torch.cumsum(count, 0)
                                                   - count), count)
                  + torch.arange(a.numel(), **i64)]
        d = p[b] - p[a]
        d = d - width * torch.floor(d / width + 0.5)  # min-image
        q = d * d
        hit = ((q[:, 0] + q[:, 1]) + q[:, 2] <= r2max) & (a != b)
        found.append(a[hit] * n + b[hit])
    keys = (torch.sort(torch.cat(found)).values.cpu().numpy() if found
            else np.zeros(0, np.int64))
    return keys // max(n, 1), keys % max(n, 1)


def make_window_config(cfg: CaseConfig, kernels: KernelSet, *,
                       planar: bool) -> pw.WindowConfig:
    """The window sweep's specialization for a case: block and (carried)
    wmax from the numerics knobs, the physics flags from the tables."""
    nu = cfg.numerics
    return pw.WindowConfig(
        block=nu.pallas_block if nu.pallas_block is not None else 64,
        wmax=nu.pallas_wmax if nu.pallas_wmax is not None
        else (256 if cfg.two_dimensional else 128),
        subblocks=nu.pallas_subblocks,
        merged=nu.pallas_merged if nu.pallas_merged is not None else True,
        surface_tension=any(v != 0.0 for v in kernels.cof_a),
        uniform_ratio=all(
            r == 1.0 for row in cfg.interaction_ratio for r in row
        ),
        planar=planar,
        uniform_radii=(kernels.radius_a == kernels.radius_p
                       == kernels.radius_v == kernels.radius_g),
    )


class Simulation:
    """One configured case: static setup + the step functions, on one device."""

    def __init__(self, cfg: CaseConfig, grid: GridData, *, device=None,
                 n_pad: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = (torch.float64 if cfg.numerics.dtype == "float64"
                      else torch.float32)
        self.n = grid.n
        self.has_structure = bool(np.any((grid.prop >= 2) & (grid.prop < 4)))
        self.spacing = float(grid.spacing)
        self.volume = grid.particle_volume(cfg.two_dimensional)

        if cfg.numerics.backend not in BACKENDS:
            raise ValueError(f"backend {cfg.numerics.backend!r}: not one of "
                             f"{BACKENDS}")

        self.kernels: KernelSet = build_kernels(
            spacing=self.spacing,
            radius_ratio_a=cfg.radius_ratio_a,
            radius_ratio_p=cfg.radius_ratio_p,
            radius_ratio_v=cfg.radius_ratio_v,
            surface_tension=cfg.surface_tension,
            two_dimensional=cfg.two_dimensional,
        )

        dmin, dmax = adjust_domain(
            grid.domain_min, grid.domain_max, self.spacing, cfg.two_dimensional
        )
        self.domain_min = tuple(dmin)
        self.domain_max = tuple(dmax)
        self.domain_width = tuple(dmax - dmin)
        self._dmin_t = self._host_vec(self.domain_min)
        self._width_t = self._host_vec(self.domain_width)

        # C8 margin (NumericsConfig.rebuild_margin): widen the candidate
        # support so the sorted frame + windows stay valid while no two
        # particles have moved apart by more than the margin since the last
        # rebuild
        margin_len = cfg.numerics.rebuild_margin * self.spacing
        self._rebuild_thresh2 = (0.5 * margin_len) ** 2
        self.cell_grid: CellGrid = build_cell_grid(
            dmin, dmax, self.kernels.support_radius + margin_len,
            two_dimensional=cfg.two_dimensional,
        )
        nc_cap = cfg.numerics.cell_capacity
        self.cell_capacity: int = (nc_cap if nc_cap is not None
                                   else (16 if cfg.two_dimensional else 40))

        self.tables = fl.TypeTables.from_config(
            cfg, self.kernels, self.dtype, self.device)
        (self.wall_center0, self.wall_velocity, self.wall_omega,
         self.wall_rotation) = wl.wall_tables(cfg, self.dtype, self.device)
        # static walls (no Rolling, Wall rows all zero, wall particles at
        # rest): the prescribed-motion pass is the identity and the step
        # skips it
        wall0 = (grid.prop >= 4) & (grid.prop < 6)
        self._walls_static = bool(
            cfg.scene.rolling is None
            and not any(any(w.velocity) or any(w.omega) for w in cfg.walls)
            and not np.any(grid.velocity[wall0])
        )

        n_pad = n_pad if n_pad is not None else cfg.numerics.n_pad
        self.state0: ParticleState = state_lib.make_state(
            grid.prop, grid.position, grid.initial_position, grid.velocity,
            time=grid.time, wall_center=[w.center for w in cfg.walls],
            n_pad=n_pad, dtype=self.dtype, device=self.device,
        )
        self.n_pad = self.state0.n_pad

        # static solid precomputation from the reference configuration
        # (calculateInitialNeighbor + calculateNormalizer, run once at init,
        # src/main.cpp:564, :570), over the structure subset only
        nbr0_idx, nbr0_mask = self._initial_structure_neighbors(grid)
        pos0_host = np.zeros((self.n_pad, 3))
        pos0_host[: self.n] = grid.initial_position
        prop_host = np.full(self.n_pad, -1, dtype=np.int32)
        prop_host[: self.n] = grid.prop
        self.solid = sl.build_solid_static(
            pos0_host, prop_host, nbr0_idx, nbr0_mask, self.kernels, cfg,
            cfg.scene, self.domain_width, spatial_dim=cfg.spatial_dim,
            dtype=self.dtype, device=self.device,
        )

        # 'auto' is the field-major sweep on any device (the JAX package's
        # is 'packed' off the TPU); a frame of 2^24 cells or more goes to
        # the row-major one, exactly as in the JAX package (there the
        # field-major kernels carry keys as float32 lanes).  Windows are
        # clipped at the domain edge, not wrapped: pairs across a periodic
        # boundary need ghost rows, and the frame grid they extend is the
        # one judged, as in the JAX package
        self._backend = ("pallas_t" if cfg.numerics.backend == "auto"
                         else cfg.numerics.backend)
        self._ghosts: Optional[gh.GhostSpec] = None
        self._rebuild_ghosts(grid.position, grid.prop >= 0)
        self.ghost_refreshes = 0  # plan rebuilds after set-up
        if (self._backend == "pallas_t"
                and self._frame_grid.num_cells >= (1 << 24)):
            self._backend = "pallas"

        self._pcfg = make_window_config(cfg, self.kernels,
                                        planar=self._is_planar(grid))
        if self.n_pad % self._pcfg.block != 0:
            raise ValueError(
                f"n_pad={self.n_pad} is not a multiple of the receiver block "
                f"{self._pcfg.block}")
        self._grav_t = self._host_vec(cfg.gravity)

        # the guarded chunk's divergence bound (the CLI watchdog's, squared)
        self._speed_limit2 = (2.0 * max(sound_speed_bound(cfg), 1.0)) ** 2

        # the fullest cell a step of a candidate engine has met since
        # set-up (a device scalar, read where wanted): past cell_capacity,
        # that step dropped pairs
        self.peak_occupancy = torch.zeros((), dtype=torch.int32,
                                          device=self.device)
        self.rebuilds = 0  # frame rebuilds over every run_chunk so far
        self.last_chunk_rebuilds = 0
        # the section spans of every chunk, step and diagnostics call
        # (utils/trace.py); profile_events switches their marks
        self.spans = Spans(self.device)
        # host seconds of the last diagnostics() call: device work with its
        # copies to the host, and the numpy tensor assembly
        self.last_diagnostics_seconds: dict = {}

    # ------------------------------------------------------------------
    def _host_vec(self, values) -> torch.Tensor:
        return torch.tensor([float(v) for v in values],
                            dtype=torch.float64).to(self.device, self.dtype)

    @property
    def profile_events(self) -> Optional[list]:
        """None, or the list that takes a ``("name", event)`` mark at each
        section end of every step and diagnostics call (``utils/trace.py``;
        chip_smoke.py's breakdowns, the benchmark's spans).  Setting a list
        where there was None starts a new recording of the marked steps
        (``utils.trace.last_recording``)."""
        return self.spans.events

    @profile_events.setter
    def profile_events(self, value: Optional[list]) -> None:
        self.spans.events = value

    @property
    def _frame_support(self) -> float:
        """Reach the frame and the ghost plan must cover: support + the C8
        margin.  Under frame reuse a strip particle can be up to margin/2
        past the depth it was selected at; selecting strips (and deciding
        wrap) one margin deeper keeps every cross-boundary pair covered by a
        stale frame, as the margin-widened cell grid does inside."""
        return (self.kernels.support_radius
                + self.cfg.numerics.rebuild_margin * self.spacing)

    @property
    def _windowed(self) -> bool:
        """The backend sweeps windows (ghost rows, plane pads, the wrap
        test); the candidate engines take the minimum image instead."""
        return self._backend in WINDOW_BACKENDS

    def _rebuild_ghosts(self, positions, valid) -> None:
        """(Re)build the periodic ghost plan and the frame grid from numpy
        positions and validity (``_rebuild_ghosts`` of the JAX package).  An
        axis already covered is never dropped: a boundary strip can empty
        for a while.  The candidate engines have no plan: the cell grid
        itself, unpadded."""
        if not self._windowed:
            self._frame_grid = self.cell_grid
            self._pad_planes = False
            return
        axes = gh.wrapped_axes(self.cell_grid, positions, valid,
                               self._frame_support, self.cfg.two_dimensional)
        axes = tuple(a or c for a, c in zip(axes, gh.spec_axes(self._ghosts)))
        self._ghosts = None
        self._ghost_shift_rows = None
        self._ghost_axes = torch.tensor(axes, device=self.device)
        if any(axes):
            self._ghosts = gh.build_ghost_spec(
                self.cell_grid, axes, positions, valid, self._frame_support)
            # per ghost row, its image's shift (the rows of an image are a
            # fixed range of the extension): the C8 skip refreshes each ghost
            # row as pos[src] + shift without extracting again
            shifts = np.concatenate([
                np.repeat(np.asarray(s, np.float64)[None, :]
                          * np.asarray(self.domain_width), cap, axis=0)
                for s, cap in zip(self._ghosts.shifts, self._ghosts.caps)])
            self._ghost_shift_rows = torch.as_tensor(shifts).to(
                self.device, self.dtype)
            logging.getLogger(__name__).info(
                "periodic wrap on axes %s via %d ghost rows", axes,
                self._ghosts.total_capacity)
        self._frame_grid = (self._ghosts.grid if self._ghosts is not None
                            else self.cell_grid)
        # 3-D: plane-align the sorted frame so that no receiver block spans
        # a z-plane end (packed_engine.pad_frame_planes)
        self._pad_planes = (not self.cfg.two_dimensional
                            and self._frame_grid.cell_count[2] > 1)

    def refresh_ghosts(self, state: ParticleState, *,
                       force: bool = False) -> bool:
        """Chunk-boundary check that the ghost plan still covers the
        CURRENT distribution (``ghosts.spec_is_stale``): an axis can start
        wrapping, or a strip can outgrow its fixed capacity.  Rebuilds the
        plan when stale and returns True; the next step just uses it.

        The test reads the positions' six extremes and each strip's
        occupancy, computed on the device, in one transfer; the positions
        come to the host only for a rebuild.  ``force=True`` rebuilds even
        when the plan looks fresh now: for a capacity overflow reported by
        ``state.ghost_overflow`` from inside the chunk (the strip may have
        shrunk back since, but pairs were dropped).  The candidate engines
        have no plan: False.  The span ``"ghost upkeep"`` covers it all."""
        sp = self.spans
        sp.begin("ghost upkeep")
        try:
            if not self._windowed:
                return False
            valid = state.prop >= 0
            parts = [gh.valid_extremes(state.pos, ~valid).flatten()]
            if self._ghosts is not None:
                parts.append(gh.strip_counts(
                    self._ghosts, self.cell_grid, state.pos,
                    valid).to(parts[0].dtype))
            host = torch.cat(parts).tolist()
            axes_now = gh.wrap_test(self.cell_grid, host[0:3], host[3:6],
                                    self._frame_support,
                                    self.cfg.two_dimensional)
            if not force and not gh.stale_from_counts(self._ghosts, axes_now,
                                                      host[6:]):
                return False
            self._rebuild_ghosts(state.pos.cpu().numpy(), valid.cpu().numpy())
            self.ghost_refreshes += 1
            return True
        finally:
            sp.mark("ghost upkeep")

    def _cover(self, extremes, pos, prop) -> bool:
        """Rebuild the ghost plan where the extremes (six numbers on the
        host) of a state's valid positions ``pos`` show pairs across an axis
        the plan does not cover; True if it did.  The positions come to the
        host only then."""
        axes = gh.wrap_test(self.cell_grid, extremes[0:3], extremes[3:6],
                            self._frame_support, self.cfg.two_dimensional)
        if not any(a and not c
                   for a, c in zip(axes, gh.spec_axes(self._ghosts))):
            return False
        self._rebuild_ghosts(pos.cpu().numpy(), (prop >= 0).cpu().numpy())
        self.ghost_refreshes += 1
        return True

    def _read(self, extremes: torch.Tensor, *scalars):
        """One host read of the ``[2, 3]`` extremes and the scalars (None
        skipped): ``(six numbers, the scalars' values)``."""
        vals = torch.cat([extremes.flatten()] + [
            v.reshape(1).to(extremes.dtype) for v in scalars
            if v is not None]).tolist()
        return vals[:6], vals[6:]

    def _is_planar(self, grid: GridData) -> bool:
        """Host-side check that the case is exactly planar: all z coordinates
        identical, all z velocities zero, no z gravity, and all wall motion
        in-plane.  Then every z pair term is exactly zero and the kernels
        skip the z math with identical results."""
        cfg = self.cfg
        if not cfg.two_dimensional:
            return False
        z = grid.position[:, 2]
        if z.size and (np.any(z != z[0]) or np.any(grid.velocity[:, 2] != 0.0)
                       or np.any(grid.initial_position[:, 2] != z[0])):
            return False
        if cfg.gravity[2] != 0.0:
            return False
        for w in cfg.walls:
            if w.velocity[2] != 0.0 or w.omega[0] != 0.0 or w.omega[1] != 0.0:
                return False
        return True

    def _initial_structure_neighbors(self, grid: GridData):
        """Structure-structure neighbor search over InitialPosition
        (calculateInitialNeighbor, src/main.cpp:1497-1658): support radius
        MaxRadius+MARGIN, periodic min-image, self excluded
        (:func:`structure_pairs`, on the simulation's device).  Returns
        ``(idx, mask)``, both ``[n_pad, K0]`` host arrays over padded slot
        indices, with each row's neighbors in ascending slot order."""
        k0 = self.cfg.numerics.max_initial_neighbors
        prop = grid.prop
        s_idx = np.nonzero((prop >= 2) & (prop < 4))[0]
        a, b = structure_pairs(grid.initial_position[s_idx],
                               self.domain_min, self.domain_width,
                               self.kernels.support_radius, self.device)
        counts = np.bincount(a, minlength=s_idx.size)
        # K0 is an array-sizing knob, not a physical limit: grow it to the
        # measured max (rounded to 8)
        kmax = int(counts.max(initial=0))
        if kmax > k0:
            k0 = int(np.ceil(kmax / 8.0)) * 8
        idx = np.zeros((self.n_pad, k0), dtype=np.int32)
        mask = np.zeros((self.n_pad, k0), dtype=bool)
        # each pair's column: its place among its row's pairs
        col = np.arange(a.size) - np.repeat(np.cumsum(counts) - counts, counts)
        idx[s_idx[a], col] = s_idx[b]
        mask[s_idx[a], col] = True
        return idx, mask

    # ------------------------------------------------------------------
    @property
    def _sweeps(self):
        """(phase 1 + EOS, phase 2, virial) of the backend in use: the
        row-major functions of ``ops/windows`` or the field-major ones of
        ``ops/windows_t``; all take the same arguments."""
        if self._backend == "pallas":
            return pw.phase1_fields, pw.phase2_forces, pw.virial
        return pwt.phase1_fields_t, pwt.phase2_forces_t, pwt.virial_t

    def _frame_inputs(self, pos, vel, prop):
        """The frame's source rows: ``((pos, vel, prop), ghost_src,
        overflow)``, the identity + None + 0, or the ghost-extended copies
        of a periodic scene (``ops/ghosts.py``).  ``overflow`` counts strip
        members beyond the fixed ghost capacity (carried out of the chunk in
        ``state.ghost_overflow``; never silent)."""
        if self._ghosts is None:
            return ((pos, vel, prop), None,
                    torch.zeros((), dtype=torch.int32, device=self.device))
        pos_e, vel_e, prop_e, src, overflow = gh.extend_with_ghosts(
            self._ghosts, self.cell_grid, pos, vel, prop)
        return (pos_e, vel_e, prop_e), src, overflow

    def _frame(self, pos, vel, prop) -> pk.SortedFrame:
        """The sorted frame of the frame's source rows, plane-padded in 3-D
        (``_pallas_frame`` of the JAX package)."""
        frame = pk.sort_frame(pos, vel, prop, self._frame_grid)
        if self._pad_planes:
            frame = pk.pad_frame_planes(frame, self._frame_grid)
        return frame

    def _propagate_ghost_fields(self, inv, f1: dict, src) -> dict:
        """Overwrite the ghost rows' phase-1 sender fields with their SOURCE
        particles' values (a ghost's own sums are incomplete: its
        neighbourhood is clipped at the extended domain's edge).  mu needs
        no fix (per row from prop); without surface tension pressure A and
        the gravity centre are zero everywhere, so only pressure P rides
        along.  Phase 2 reads these dict entries themselves (the sweeps
        make no copy of them), so replacing them is enough.

        ``inv`` is the frame's inverse permutation (cached with the frame
        on the C8 skip path); ``inv[src]`` is each ghost's source row, so a
        field costs one gather and one scatter of the ghost rows."""
        names = ["pressure_p"]
        if self._pcfg.surface_tension:
            names += ["pressure_a", "gravity_center"]
        ghost_rows = inv[self.n_pad: self.n_pad + src.shape[0]]
        src_rows = inv[src]
        f1 = dict(f1)
        for k in names:
            v = f1[k]
            f1[k] = v.index_put((ghost_rows,), v[src_rows])
        return f1

    def _pair_forces(self, frame: pk.SortedFrame, windows, gsrc=None,
                     inv=None):
        """Phase 1 + EOS, the ghost rows' fields from their sources (a
        ghost-extended frame: ``gsrc``, with the frame's inverse
        permutation ``inv`` where the caller has it), phase 2, gravity, and
        the return to slot order (ghost rows and plane pads dropped), for a
        frame that is already sorted."""
        fgrid, sp = self._frame_grid, self.spans
        phase1, phase2, _ = self._sweeps
        sp.begin("phase1")
        f1 = phase1(frame, fgrid, self.kernels, self.tables, cfg=self._pcfg,
                    windows=windows)
        sp.mark("phase1")
        if gsrc is not None:
            sp.begin("ghost fields")
            if inv is None:
                inv = _inverse_permutation(frame.orig)
            f1 = self._propagate_ghost_fields(inv, f1, gsrc)
            sp.mark("ghost fields")
        sp.begin("phase2")
        force_s = phase2(
            frame, f1, fgrid, self.kernels, self.tables, volume=self.volume,
            two_dimensional=self.cfg.two_dimensional, cfg=self._pcfg,
            windows=windows)
        sp.mark("phase2")
        sp.begin("integrate")  # ends in the step, after the kick and drift
        return self._gravity_unsort(frame, force_s)

    def _gravity_unsort(self, frame: pk.SortedFrame, force_s):
        """Gravity on fluid + structure added in sorted order, then the
        return to slot order (ghost rows and plane pads dropped)."""
        sprop = frame.prop
        seg = Segments(sprop)
        mass_s = self.tables.density[torch.clamp(sprop, 0, 5).long()] * self.volume
        fs = seg.fluid | seg.structure
        force_s = force_s + torch.where(
            fs[:, None], mass_s[:, None] * self._grav_t,
            torch.zeros((), dtype=self.dtype, device=self.device))
        (force,) = pk.unsort(frame, force_s, n=self.n_pad)
        return force

    def _fluid_phase(self, pos, vel, prop):
        """The gather engine: the neighbour list, both fluid phases over its
        ``[N, K]`` edges (operands gathered by index, the formulas of
        ``ops/edge_math``) and gravity, in slot order.  Returns the total
        force and the neighbour list."""
        cfg, ks, tables, sp = self.cfg, self.kernels, self.tables, self.spans
        sp.begin("neighbors")
        nbr = build_neighbor_list(
            pos, prop >= 0, self.cell_grid,
            max_neighbors=cfg.numerics.max_neighbors,
            cell_capacity=self.cell_capacity)
        sp.mark("neighbors", rebuilt=True)
        sp.begin("phase1")
        ctx = fl.make_pair_context(pos, prop, nbr, self.domain_width, tables)
        j = ctx.j

        def to_c(a):  # [.., E, 3] -> [3, .., E]
            return torch.movedim(a, -1, 0)

        geom = em.EdgeGeometry(xij=to_c(ctx.xij), rij2=ctx.rij2, rij=ctx.rij,
                               eij=to_c(ctx.eij), valid=ctx.mask)
        s_i = fl.is_structure(prop)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        vel_j = to_c(vel[j])
        da, gc_c, wp_sum, dvg = em.phase1_sums(
            geom, ks, vel_i=vel.T, vel_j=vel_j, ratio_ij=ctx.ratio_ij)
        # structure receivers are skipped by the A/G ops (src/main.cpp:2149,2183)
        da = torch.where(s_i, zero, da)
        gc = torch.where(s_i[:, None], zero, gc_c.T)
        vs = wp_sum - ks.n0p
        kappa, lam, mu = fl.physical_coefficients(prop, vs, tables)
        pp = fl.pressure_p(vs, dvg, kappa, lam)
        pa = fl.pressure_a(da, ks, prop, tables)
        sp.mark("phase1")

        sp.begin("phase2")
        force = em.phase2_force(
            geom, ks, volume=self.volume, two_dimensional=cfg.two_dimensional,
            receiver_is_structure=s_i,
            sender_is_structure=fl.is_structure(ctx.prop_j),
            pp_i=pp, pp_j=pp[j], pa_i=pa, pa_j=pa[j],
            gc_i=gc.T, gc_j=to_c(gc[j]), mu_i=mu, mu_j=mu[j],
            vel_i=vel.T, vel_j=vel_j,
            ratio_ij=ctx.ratio_ij, ratio_ji=ctx.ratio_ji,
            cof_a_i=tables.cof_a[ctx.prop_i],
        ).T
        sp.mark("phase2")

        sp.begin("integrate")
        # gravity on fluid + structure (calculateGravity, src/main.cpp:2917-2935)
        seg = Segments(prop)
        mass = self.tables.density[torch.clamp(prop, 0, 5).long()] * self.volume
        force = force + torch.where((seg.fluid | seg.structure)[:, None],
                                    mass[:, None] * self._grav_t, zero)
        return force, nbr

    def _packed_frame(self, pos, vel, prop) -> pk.SortedFrame:
        """The packed engine's frame: the cell grid's, with the per-cell
        offsets and the rows' cell coordinates."""
        return pk.sort_frame(pos, vel, prop, self.cell_grid,
                             with_cell_start=True)

    def _force(self, pos, vel, prop):
        """Total pairwise + body force with a fresh frame (no reuse).  One
        window table serves both phases of a window sweep (the JAX
        row-major functions each compute the same table again).  Returns
        ``(force, ghost_overflow)``."""
        sp = self.spans
        if not self._windowed:
            if self._backend == "gather":
                force, nbr = self._fluid_phase(pos, vel, prop)
                occupancy = nbr.cell_overflow
            else:
                sp.begin("frame")
                frame = self._packed_frame(pos, vel, prop)
                sp.mark("frame", rebuilt=True)
                sp.begin("candidates")
                views = pk.frame_views(frame, self.cell_grid,
                                       self.cell_capacity)
                sp.mark("candidates")
                sp.begin("phases 1 and 2")
                force_s, fields = pk.packed_fluid_forces(
                    frame, self.cell_grid, self.kernels, self.tables,
                    volume=self.volume,
                    two_dimensional=self.cfg.two_dimensional,
                    cap=self.cell_capacity, views=views)
                sp.mark("phases 1 and 2")
                sp.begin("integrate")
                force = self._gravity_unsort(frame, force_s)
                occupancy = fields["cell_overflow"]
            self.peak_occupancy = torch.maximum(self.peak_occupancy,
                                                occupancy)
            return force, torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        if self._ghosts is not None:
            sp.begin("ghost rows")
        finputs, gsrc, overflow = self._frame_inputs(pos, vel, prop)
        if gsrc is not None:
            sp.mark("ghost rows")
        sp.begin("frame")
        frame = self._frame(*finputs)
        windows = pw.compute_windows(frame, self._frame_grid, self._pcfg)
        sp.mark("frame", rebuilt=True)
        return self._pair_forces(frame, windows, gsrc), overflow

    @property
    def _margin_cached(self) -> bool:
        """C8 skip active: a margin is configured and the backend is the one
        that carries a reusable frame and window tables (``pallas_t``; the
        row-major ``pallas`` rebuilds every step, as in the JAX package).
        Ghost (periodic) scenes too: ghost rows are shifted copies of source
        rows, so the cached permutation, windows and plan stay valid under
        the same predicate, with the ghost payloads refreshed from the
        cached source map every step."""
        return (self.cfg.numerics.rebuild_margin > 0.0
                and self._backend == "pallas_t")

    def _init_cache(self, state: ParticleState) -> dict:
        """Empty frame cache whose infinite ``ref_pos`` forces a rebuild on
        first use (``pos - inf`` is not finite, so the cache is stale).
        ``spec`` is the ghost plan the frame was built under, ``gsrc`` and
        ``inv`` its ghost sources and inverse permutation; ``gather`` (3-D)
        the frame's source row of each frame row, 0 on a plane pad, and
        ``pads`` the plane pads' mask."""
        return dict(
            orig=None, key=None, prop_s=None, ws=None, wl=None,
            ref_pos=torch.full_like(state.pos, float("inf")),
            spec=None, gsrc=None, inv=None, gather=None, pads=None,
            rebuilds=0,
        )

    def _force_cached(self, pos, vel, prop, cache: dict, extremes,
                      probe=None):
        """Force evaluation under the C8 margin predicate
        (neighborCalculation, src/main.cpp:1472-1494): reuse the cached sort
        permutation + window tables until the displacement set's diameter
        exceeds the margin.  The candidate support is widened by the margin
        (cell_grid build), so the stale frame still covers every pair within
        the true support; family-radius masks test CURRENT positions, so
        forces are exact either way -- only the summation order differs.
        Returns ``(force, ghost_overflow, new_cache)``.

        The predicate is the DIAMETER of the displacement set, not the max
        displacement: pair validity depends on relative motion only.

        Ghost scenes: strips are selected one margin deeper
        (``_frame_support``), so every particle within the true support of
        a wrapped boundary during the skip window already has its image rows
        in the frame; skip steps refresh each image's payload as
        ``pos_eff[src] + shift``.  A boundary CROSSING is not an event: the
        predicate min-images the motion on the wrapped axes and the skip
        path presents ``pos_eff = pos - k*L`` (the current position
        unwrapped into the cached frame's coordinate patch), so the crosser
        keeps pairing exactly.  Near the half-period alias the min-imaged
        displacements straddle +-L/2 and the diameter blows up to ~L,
        forcing the rebuild first.  Overflow is counted on rebuild steps
        only (membership is frozen in between).

        One host read a step: the predicate, the state's six ``extremes``
        (a rebuild of the ghost plan where pairs span an axis it does not
        cover, and then a rebuild of the frame) and ``probe`` (the guarded
        chunk's squared top speed of the state this step starts from).
        Where the probe is not finite or not below the speed bound, nothing
        is evaluated and ``(None, None, cache)`` is returned."""
        spec = cache["spec"]
        d = pos - cache["ref_pos"]
        if spec is not None and spec is self._ghosts:
            # min-image on the frame's wrapped axes: fold the displacement
            # (and the particle) to the period nearest its cached position
            k = torch.where(torch.isfinite(d) & self._ghost_axes,
                            torch.round(d / self._width_t),
                            torch.zeros((), dtype=d.dtype, device=d.device))
            d = d - k * self._width_t
            pos_eff = pos - k * self._width_t
        else:
            pos_eff = pos
        valid_c = (prop >= 0)[:, None]
        big = torch.tensor(1e30, dtype=d.dtype, device=d.device)
        zero = torch.zeros((), dtype=d.dtype, device=d.device)
        finite = torch.isfinite(d)
        stale = ~torch.all(finite | ~valid_c)
        dfin = torch.where(finite, d, zero)
        hi = torch.where(valid_c, dfin, -big).amax(dim=0)
        lo = torch.where(valid_c, dfin, big).amin(dim=0)
        half = 0.5 * torch.clamp_min(hi - lo, 0.0)
        disp2 = torch.where(stale, big, torch.sum(half * half))

        ext, (disp2_host, *v2) = self._read(extremes, disp2, probe)
        if v2 and not self._healthy(v2[0]):
            return None, None, cache
        # a plan rebuilt now (or between chunks) invalidates the frame
        self._cover(ext, pos, prop)
        sp = self.spans
        sp.mark("read")
        if disp2_host > self._rebuild_thresh2 or spec is not self._ghosts:
            if self._ghosts is not None:
                sp.begin("ghost rows")
            finputs, gsrc, gover = self._frame_inputs(pos, vel, prop)
            if gsrc is not None:
                sp.mark("ghost rows")
            sp.begin("frame")
            frame = self._frame(*finputs)
            ws, wl_ = pw.compute_windows(frame, self._frame_grid, self._pcfg)
            inv = (_inverse_permutation(frame.orig) if gsrc is not None
                   else None)
            gather = pads = None
            if self._pad_planes:
                # plane pads have orig past every source row: gather row 0
                # for them and poison them again on every skip
                pads = frame.orig >= finputs[0].shape[0]
                gather = frame.orig.masked_fill(pads, 0)
            new_cache = dict(orig=frame.orig, key=frame.key,
                             prop_s=frame.prop, ws=ws, wl=wl_, ref_pos=pos,
                             spec=self._ghosts, gsrc=gsrc, inv=inv,
                             gather=gather, pads=pads,
                             rebuilds=cache["rebuilds"] + 1)
        else:
            orig, gsrc = cache["orig"], cache["gsrc"]
            pos_x, vel_x = pos_eff, vel
            if gsrc is not None:
                # image payloads from their sources (frozen map); pos_eff
                # keeps a crosser glued to the cached frame's patch
                sp.begin("ghost rows")
                pos_x = torch.cat([pos_eff,
                                   pos_eff[gsrc] + self._ghost_shift_rows])
                vel_x = torch.cat([vel, vel[gsrc]])
                sp.mark("ghost rows")
            sp.begin("frame")
            if cache["pads"] is None:
                pos_s, vel_s = pos_x[orig], vel_x[orig]
            else:
                # a plane pad's cached key is a real cell: un-poisoned, it
                # would pass the ring test as a phantom sender
                # (pad_frame_planes' convention: position 1e9, velocity 0)
                pads = cache["pads"][:, None]
                pos_s = pos_x[cache["gather"]].masked_fill(pads, 1.0e9)
                vel_s = vel_x[cache["gather"]].masked_fill(pads, 0.0)
            frame = pk.SortedFrame(key=cache["key"], pos=pos_s, vel=vel_s,
                                   prop=cache["prop_s"], orig=orig)
            ws, wl_ = cache["ws"], cache["wl"]
            gover = torch.zeros((), dtype=torch.int32, device=self.device)
            new_cache = cache
        sp.mark("frame", rebuilt=new_cache is not cache)
        force = self._pair_forces(frame, (ws, wl_), new_cache["gsrc"],
                                  new_cache["inv"])
        return force, gover, new_cache

    def _step_core(self, state: ParticleState, cache, probe=None):
        """One full time step (the loop body of main(), src/main.cpp:592-686).
        ``cache`` is the C8 frame cache (None = rebuild every step).
        ``probe`` (the guarded chunk's squared top speed of ``state``) is
        read with the step's one host read; where it shows the state
        diverged, the step is not taken and ``(None, cache)`` is returned.

        On the window sweeps that read also brings the extremes of the
        state's wrapped positions: where pairs span an axis the ghost plan
        does not cover, the plan is rebuilt before this step's forces (and
        the frame with it), so no step drops a pair across the periodic
        boundary.  The candidate engines read nothing unless guarded."""
        cfg = self.cfg
        dt = cfg.dt
        prop = state.prop
        pos, vel, time = state.pos, state.vel, state.time
        sp = self.spans
        sp.step()
        # "read" ends with the read, in _force_cached on its path; where the
        # walls move, it begins after them, and "walls" holds the inlet and
        # the wall motion
        sp.begin("read" if self._walls_static else "walls")

        if cfg.scene.velocity_profile == "turek_inlet":
            vel = wl.turek_inlet_velocity(pos, vel, prop, time, cfg.scene)
        if self._walls_static:
            wall_center = state.wall_center
        else:
            pos, vel, wall_center = wl.apply_wall_motion(
                pos, vel, prop, state.wall_center, time,
                wall_velocity=self.wall_velocity, wall_omega=self.wall_omega,
                wall_rotation=self.wall_rotation, dt=dt, scene=cfg.scene,
                freeze=cfg.compat.freeze_wall_motion)
            sp.mark("walls")
            sp.begin("read")
        pos = wl.periodic_wrap(pos, self._dmin_t, self._width_t)

        if cache is not None:
            force, ghost_over, cache = self._force_cached(
                pos, vel, prop, cache, gh.valid_extremes(pos, prop < 0),
                probe)
            if force is None:
                return None, cache
        else:
            if self._windowed:
                ext, v2 = self._read(gh.valid_extremes(pos, prop < 0), probe)
            else:  # the minimum image needs no cover: only the probe is read
                ext, v2 = None, [] if probe is None else [probe.item()]
            if v2 and not self._healthy(v2[0]):
                return None, cache
            if ext is not None:
                self._cover(ext, pos, prop)
            sp.mark("read")
            force, ghost_over = self._force(pos, vel, prop)

        # velocity kick for fluid + structure (calculateAcceleration,
        # src/main.cpp:2938-2955)
        seg = Segments(prop)
        fs = seg.fluid | seg.structure
        mass = self.tables.density[torch.clamp(prop, 0, 5).long()] * self.volume
        accel = force / torch.where(mass > 0, mass, torch.ones_like(mass))[:, None]
        vel = torch.where(fs[:, None], vel + accel * dt, vel)

        # fluid drift (calculateConvection, src/main.cpp:1892-1906)
        pos = torch.where(seg.fluid[:, None], pos + vel * dt, pos)
        sp.mark("integrate")

        # elastic substeps (src/main.cpp:653-663); skipped when the scene
        # has no structure particles
        if self.has_structure and cfg.substeps > 0:
            sp.begin("solid")
            pos, vel = sl.run_substeps(
                pos, vel, self.solid, self._width_t, cfg.elastic_dt,
                cfg.substeps,
                double_position_update=cfg.compat.double_substep_position_update,
                spans=sp,
            )
            sp.mark("solid")

        return state.replace(
            pos=pos, vel=vel, wall_center=wall_center, time=time + dt,
            # max-accumulated over the chunk: an overflow of one step
            # survives to the chunk boundary
            ghost_overflow=torch.maximum(state.ghost_overflow, ghost_over),
        ), cache

    def apply_initial_velocity_profile(self, state: ParticleState):
        """Opt-in Bar-module excitation (the reference's init-time call is
        commented out, src/main.cpp:571): the ``bar_first_mode`` profile on
        the structure rows; any other scene returns ``state`` itself."""
        if self.cfg.scene.velocity_profile != "bar_first_mode":
            return state
        with torch.no_grad():
            return state.replace(vel=wl.bar_initial_velocity(
                state.pos0, state.vel, state.prop, self.cfg.scene,
                self.tables.density))

    # ------------------------------------------------------------------
    def step(self, state: ParticleState) -> ParticleState:
        """One step with a fresh frame, a chunk of its own; the input state
        is left intact."""
        self.spans.chunk()
        with torch.no_grad():
            state = self._step_core(state, None)[0]
        self.spans.end()
        return state

    def run_chunk(self, state: ParticleState, n_steps: int) -> ParticleState:
        """``n_steps`` steps.  With a rebuild margin the frame cache lives
        for the chunk (it starts empty, so the first step rebuilds), as in
        the JAX package; ``last_chunk_rebuilds`` and ``rebuilds`` count the
        frame rebuilds.  The input state is left intact."""
        cache = self._init_cache(state) if self._margin_cached else None
        self.spans.chunk()
        with torch.no_grad():
            for _ in range(n_steps):
                state, cache = self._step_core(state, cache)
        self.spans.end()
        done = cache["rebuilds"] if cache is not None else n_steps
        self.last_chunk_rebuilds = done
        self.rebuilds += done
        return state

    # ------------------------------------------------------------------
    def _healthy(self, v2: float) -> bool:
        return bool(np.isfinite(v2)) and v2 < self._speed_limit2

    @staticmethod
    def _top_speed2(state: ParticleState, invalid=None) -> torch.Tensor:
        """Largest squared speed over the valid particles (NaN if any is).
        ``invalid`` is ``state.prop < 0`` where the caller has it already."""
        if invalid is None:
            invalid = state.prop < 0
        v2 = torch.sum(state.vel * state.vel, dim=1)
        return v2.masked_fill(invalid, 0.0).max()

    def run_chunk_guarded(self, state: ParticleState, n_steps: int):
        """Chunk with an in-loop divergence guard: stop stepping the moment
        any valid particle's speed goes non-finite or past the watchdog
        sound-speed bound (``_chunk_guarded`` of the JAX package, a
        ``lax.while_loop`` there).  Returns ``(state, steps_done, healthy)``;
        on divergence the state is the FIRST bad state, it is never stepped
        again, and ``steps_done`` counts the bad step.

        Every step already reads a few device scalars (the extremes, and
        with a rebuild margin the C8 predicate); the health scalar of the
        state a step starts from is read in that same transfer, so the guard
        adds one small reduction a step and one host read a chunk (for the
        last state).

        Spans: ``"probe"`` (the reduction) ends each step; ``"guard read"``
        (the last health read: the chunk's last read, or the read of the
        step found unhealthy) ends a chunk that took a step."""
        cache = self._init_cache(state) if self._margin_cached else None
        done, healthy = 0, True
        sp = self.spans
        sp.chunk()
        with torch.no_grad():
            invalid = state.prop < 0  # types do not change inside a chunk
            probe = None  # the entry state is not judged, as in the JAX loop
            while done < n_steps:
                nxt, cache = self._step_core(state, cache, probe)
                if nxt is None:  # `state`, the result of step `done`, is bad
                    healthy = False
                    break
                state, done = nxt, done + 1
                sp.begin("probe")
                probe = self._top_speed2(state, invalid)
                sp.mark("probe")
            sp.end_step()
            if done:
                sp.begin("guard read")
                if healthy:
                    healthy = self._healthy(probe.item())
                sp.mark("guard read")
        sp.end()
        rebuilds = cache["rebuilds"] if cache is not None else done
        self.last_chunk_rebuilds = rebuilds
        self.rebuilds += rebuilds
        return state, done, healthy

    # ------------------------------------------------------------------
    def _diagnostics(self, state: ParticleState) -> dict:
        """Output-time field recomputation (VTK fields + virial stress,
        src/main.cpp:984-1189, 3077-3318) on the device: a fresh frame
        (never the C8 cache, so every field is in one frame's order), the
        window sweeps' phases (:meth:`_window_phases`) or, on both candidate
        engines, the packed engine's phases and virial, then one gather back
        to slot order that drops the ghost rows and plane pads.

        Tensor outputs come in memory-friendly layouts -- solid tensors in
        compact subset space [S, sd, sd], virial components [9, N] -- and
        are assembled on the host by :meth:`diagnostics`."""
        cfg = self.cfg
        prop, pos, vel = state.prop, state.pos, state.vel
        sp = self.spans
        sp.step("diagnostics")
        if self._windowed:
            (frame, inv, force_s, f1, virial_s, vp_s, cell_overflow,
             ghost_over, window_len) = self._window_phases(pos, vel, prop)
        else:
            # both candidate engines: the packed engine's phases, as in
            # the JAX package (its gather engine has no virial of its own)
            sp.begin("frame")
            frame = self._packed_frame(pos, vel, prop)
            inv = _inverse_permutation(frame.orig)
            sp.mark("frame")
            sp.begin("candidates")
            views = pk.frame_views(frame, self.cell_grid, self.cell_capacity)
            sp.mark("candidates")
            kw = dict(volume=self.volume, two_dimensional=cfg.two_dimensional,
                      cap=self.cell_capacity, views=views)
            sp.begin("phases 1 and 2")
            force_s, f1 = pk.packed_fluid_forces(
                frame, self.cell_grid, self.kernels, self.tables, **kw)
            sp.mark("phases 1 and 2")
            sp.begin("virial")
            virial_s, vp_s = pk.packed_virial(
                frame, f1, self.cell_grid, self.kernels, self.tables, **kw)
            sp.mark("virial")
            # the fullest cell of phase 1; no window, no ghost row
            cell_overflow = f1["cell_overflow"]
            ghost_over = window_len = torch.zeros(
                (), dtype=torch.int32, device=self.device)

        # back to slot order: all rows in one gather by the inverse
        # permutation, which keeps the slots and drops the ghost rows
        sp.begin("unsort")
        rows = torch.cat([
            force_s.T, f1["pressure_p"][None], f1["pressure_a"][None],
            f1["vol_strain"][None], f1["density_a"][None],
            f1["divergence"][None], f1["gravity_center"].T,
            f1["neighbor_count"].to(self.dtype)[None], vp_s[None], virial_s,
        ])
        slot = rows[:, inv[: self.n_pad]]
        force = slot[0:3].T
        pp, pa, vs, da = slot[3], slot[4], slot[5], slot[6]
        gc, nbr_count, vp, virial_rows = slot[8:11].T, slot[11], slot[12], slot[13:22]
        sp.mark("unsort")

        sp.begin("solid and tail")

        f = sl.deformation_gradient_subset(
            pos[self.solid.gather_idx], self.solid, self._width_t)
        strain, stress = sl.stvk_stress(f, self.solid.lam, self.solid.mu)
        seg = Segments(prop)
        mass = self.tables.density[torch.clamp(prop, 0, 5).long()] * self.volume
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        fs = seg.fluid | seg.structure
        force = force + torch.where(
            fs[:, None], mass[:, None] * self._grav_t, zero)
        accel = torch.where(
            seg.fluid[:, None],
            force / torch.where(mass > 0, mass, torch.ones_like(mass))[:, None],
            zero)
        out = dict(
            force=force,
            accel=accel,
            strain_subset=strain,
            stress_subset=stress,
            deform_subset=f,
            pressure_p=pp,
            pressure_a=pa,
            vol_strain=vs,
            density_a=da,
            gravity_center=gc,
            neighbor_count=nbr_count.to(torch.int32),
            initial_neighbor_count=self.solid.count0_full,
            cell_overflow=cell_overflow,
            ghost_overflow=ghost_over,
            window_overflow=window_len,
            virial_rows=virial_rows,
            virial_pressure=vp,
            max_speed=torch.where(seg.valid, torch.linalg.norm(vel, dim=1),
                                  zero).max(),
        )
        sp.mark("solid and tail")
        sp.end()
        return out

    def _window_phases(self, pos, vel, prop):
        """The window sweeps' part of :meth:`_diagnostics`: a fresh frame and
        windows, phase 1 with the neighbour count, the ghost rows' fields,
        phase 2 and the virial sweep; the fullest cell, the ghost overflow
        and the longest window (the sweeps walk windows of any length
        exactly, so nothing overflows: a load signal only, which the
        command line logs as ``window_len``)."""
        fgrid, pcfg, cfg, sp = self._frame_grid, self._pcfg, self.cfg, self.spans
        phase1, phase2, virial = self._sweeps
        sp.begin("frame")
        finputs, gsrc, ghost_over = self._frame_inputs(pos, vel, prop)
        frame = self._frame(*finputs)
        windows = pw.compute_windows(frame, fgrid, pcfg)
        inv = _inverse_permutation(frame.orig)
        sp.mark("frame")
        sp.begin("phase1")
        f1 = phase1(frame, fgrid, self.kernels, self.tables, cfg=pcfg,
                    windows=windows, count=True)
        if gsrc is not None:
            f1 = self._propagate_ghost_fields(inv, f1, gsrc)
        sp.mark("phase1")
        sp.begin("phase2")
        force_s = phase2(
            frame, f1, fgrid, self.kernels, self.tables, volume=self.volume,
            two_dimensional=cfg.two_dimensional, cfg=pcfg, windows=windows)
        sp.mark("phase2")
        sp.begin("virial")
        virial_s, vp_s = virial(
            frame, f1, fgrid, self.kernels, self.tables, volume=self.volume,
            two_dimensional=cfg.two_dimensional, cfg=pcfg, windows=windows)
        sp.mark("virial")
        # true max cell occupancy over the frame grid's cells (the window
        # sweep consults no cell capacity; the metric stays commensurate
        # with the other engines')
        edges = torch.searchsorted(
            frame.key, torch.arange(fgrid.num_cells + 1, dtype=torch.int32,
                                    device=self.device))
        cell_overflow = (edges[1:] - edges[:-1]).max().to(torch.int32)
        return (frame, inv, force_s, f1, virial_s, vp_s, cell_overflow,
                ghost_over, windows[1].max().to(torch.int32))

    def diagnostics(self, state: ParticleState) -> dict:
        """Device diagnostics + host-side tensor assembly (the full [N,3,3]
        arrays are built in numpy).  Keys, shapes and dtypes are those of the
        JAX package's ``Simulation.diagnostics``.  As a step does, it first
        rebuilds the ghost plan where pairs of ``state``'s positions,
        wrapped into the domain, span an axis the plan does not cover (six
        numbers read)."""
        t0 = _time.perf_counter()
        with torch.no_grad():
            if self._windowed:
                pos = wl.periodic_wrap(state.pos, self._dmin_t, self._width_t)
                ext, _ = self._read(gh.valid_extremes(pos, state.prop < 0))
                self._cover(ext, pos, state.prop)
            dev = self._diagnostics(state)
            out = {k: v.cpu().numpy() for k, v in dev.items()}
        t1 = _time.perf_counter()
        n_s = self.solid.n_struct
        s_rows = self.solid.s_idx[:n_s].cpu().numpy()

        def full_tensor(sub):
            t = np.zeros((self.n_pad, 3, 3), dtype=sub.dtype)
            sd = sub.shape[-1]
            t[s_rows, :sd, :sd] = sub[:n_s]
            return t

        out["strain"] = full_tensor(out.pop("strain_subset"))
        out["stress"] = full_tensor(out.pop("stress_subset"))
        out["deform_gradient"] = full_tensor(out.pop("deform_subset"))
        vir = out.pop("virial_rows")  # [9, N]
        out["virial_stress"] = np.ascontiguousarray(vir.T).reshape(
            self.n_pad, 3, 3
        )
        self.last_diagnostics_seconds = dict(
            device_and_copies=t1 - t0,
            host_assembly=_time.perf_counter() - t1)
        return out


def load_case(data_path, grid_path, *, scene="none", compat=None,
              numerics=None) -> "tuple[CaseConfig, GridData]":
    """Convenience loader matching the reference CLI contract
    (argv[1]=.data, argv[2]=.grid, src/main.cpp:502-507); counterpart of the
    JAX package's ``solver.load_case``."""
    from particlemethod_fsi_tpu_torch.io.data_file import parse_data_file
    from particlemethod_fsi_tpu_torch.io.grid_file import read_grid_file

    cfg = parse_data_file(data_path)
    scene_cfg = SCENES[scene] if isinstance(scene, str) else scene
    updates = {"scene": scene_cfg}
    grid = read_grid_file(grid_path)
    # dimensionality was a compile-time #define in the reference
    # (TWO_DIMENSIONAL, src/main.cpp:50); infer it from the scene geometry:
    # 2-D grids carry a z-extent of exactly one particle spacing
    z_width = float(grid.domain_max[2] - grid.domain_min[2])
    updates["two_dimensional"] = z_width <= 1.5 * float(grid.spacing)
    if compat is not None:
        updates["compat"] = compat
    if numerics is not None:
        updates["numerics"] = numerics
    cfg = dataclasses.replace(cfg, **updates)
    return cfg, grid
