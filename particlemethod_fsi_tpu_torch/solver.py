"""The simulation: setup, the time step, and the chunked run loop.

Counterpart of ``particlemethod_fsi_tpu/solver.py``, for the two window-sweep
backends on one device: ``pallas_t`` (field-major kernels, ``ops/windows_t``;
what ``auto`` selects) and ``pallas`` (row-major kernels, ``ops/windows``),
which also takes every ``auto``/``pallas_t`` frame of 2^24 cells or more, as
in the JAX package.  Ported: ``adjust_domain``,
``Simulation.__init__`` (without ghosts, 3-D plane padding and diagnostics),
``_is_planar``, ``_initial_structure_neighbors``, ``_force``,
``_margin_cached``, ``_init_cache``, ``_force_cached`` (without the ghost
branches), ``_step_core``, ``step``, ``run_chunk``, ``_chunk_guarded`` /
``run_chunk_guarded``, ``_diagnostics`` / ``diagnostics`` (the window-sweep
branch without ghosts) and the module function ``load_case``.  Sequence of
one step
(matching src/main.cpp:592-663):

  periodic wrap -> frame rebuild or reuse (C8 predicate; ``pallas_t``
  only, the row-major backend rebuilds every step) -> phase 1 (densities,
  divergence) + EOS -> phase 2 (pairwise forces) -> gravity -> velocity
  kick (fluid + structure) -> fluid convection -> elastic substeps.

Not ported yet, and raised for by name rather than run some other way:
prescribed wall motion and ``Rolling``, the Turek inlet and the Bar initial
velocity profile, periodic ghosts, 3-D plane padding, and the ``packed`` /
``gather`` backends.

PyTorch runs eagerly, so where the JAX package traces ``lax.cond`` and
``lax.scan`` this module has a Python ``if`` on one device scalar a step (a
host synchronisation) and a Python loop; the guarded chunk's
``lax.while_loop`` is a Python loop whose health scalar rides in the same
host read.  Every op returns new tensors:
``step`` and ``run_chunk`` leave their input state intact.
"""

from __future__ import annotations

from typing import Optional

import dataclasses
import time as _time

import numpy as np
import torch

from particlemethod_fsi_tpu_torch import state as state_lib
from particlemethod_fsi_tpu_torch.config import SCENES, CaseConfig
from particlemethod_fsi_tpu_torch.io.grid_file import GridData
from particlemethod_fsi_tpu_torch.ops import fluid as fl
from particlemethod_fsi_tpu_torch.ops import packed_engine as pk
from particlemethod_fsi_tpu_torch.ops import solid as sl
from particlemethod_fsi_tpu_torch.ops import walls as wl
from particlemethod_fsi_tpu_torch.ops import windows as pw
from particlemethod_fsi_tpu_torch.ops import windows_t as pwt
from particlemethod_fsi_tpu_torch.ops.neighbors import CellGrid, build_cell_grid
from particlemethod_fsi_tpu_torch.ops.smoothing import KernelSet, build_kernels
from particlemethod_fsi_tpu_torch.state import ParticleState, Segments
from particlemethod_fsi_tpu_torch.utils.watchdog import sound_speed_bound


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


def _wrap_test(grid: CellGrid, pos_min, pos_max, support: float,
               two_dimensional: bool):
    """Axes with at least 3 cells (never z in 2-D) where the gaps between
    the extreme valid positions and the domain's two ends, summed, are
    narrower than the support: pairs span the periodic boundary there."""
    return tuple(
        grid.cell_count[d] >= 3 and not (two_dimensional and d == 2)
        and (float(pos_min[d]) - grid.domain_min[d])
        + (grid.domain_min[d] + grid.domain_width[d] - float(pos_max[d]))
        < support
        for d in range(3))


def wrapped_axes(grid: CellGrid, positions, valid, support: float,
                 two_dimensional: bool):
    """Axes where interacting pairs span the periodic boundary (the test of
    ``ops/ghosts.py::wrapped_axes`` in the JAX package; such a scene needs
    ghost rows, which are not ported yet)."""
    pos = np.asarray(positions)[np.asarray(valid)]
    if pos.size == 0:
        return (False, False, False)
    return _wrap_test(grid, pos.min(axis=0), pos.max(axis=0), support,
                      two_dimensional)


def valid_extremes(pos: torch.Tensor, invalid: torch.Tensor) -> torch.Tensor:
    """[2, 3] on the device: the per-axis minimum and maximum of the rows
    of ``pos`` that are not ``invalid``, by a masked ``amin``/``amax``
    (infinite where no row is valid).  No host transfer."""
    pad = invalid[:, None]
    return torch.stack([pos.masked_fill(pad, float("inf")).amin(dim=0),
                        pos.masked_fill(pad, float("-inf")).amax(dim=0)])


def wrapped_axes_device(grid: CellGrid, pos: torch.Tensor,
                        valid: torch.Tensor, support: float,
                        two_dimensional: bool):
    """:func:`wrapped_axes` of positions and validity that lie on the
    device: the extremes of :func:`valid_extremes`, read back in one
    transfer of six numbers, then the same test.  Minimum and maximum are
    exact, so both forms give the same answer (no valid row: the extremes
    are infinite and nothing wraps)."""
    pos_min, pos_max = valid_extremes(pos, ~valid).tolist()
    return _wrap_test(grid, pos_min, pos_max, support, two_dimensional)


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

        if cfg.numerics.backend not in ("auto", "pallas_t", "pallas"):
            raise NotImplementedError(
                f"backend {cfg.numerics.backend!r}: only the window sweeps "
                "('pallas_t', 'pallas', or 'auto') are ported; the packed "
                "and gather engines come with a later slice")
        if cfg.scene.rolling is not None:
            raise NotImplementedError(
                "Rolling wall motion is not ported yet (scene-modules slice)")
        if cfg.scene.velocity_profile in ("turek_inlet", "bar_first_mode"):
            raise NotImplementedError(
                f"velocity profile {cfg.scene.velocity_profile!r} is not "
                "ported yet (scene-modules slice)")

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

        self.tables = fl.TypeTables.from_config(
            cfg, self.kernels, self.dtype, self.device)
        (self.wall_center0, self.wall_velocity, self.wall_omega,
         self.wall_rotation) = wl.wall_tables(cfg, self.dtype, self.device)
        # static walls (Wall rows all zero, wall particles at rest): the
        # prescribed-motion pass is the identity and the step skips it
        wall0 = (grid.prop >= 4) & (grid.prop < 6)
        self._walls_static = bool(
            not any(any(w.velocity) or any(w.omega) for w in cfg.walls)
            and not np.any(grid.velocity[wall0])
        )
        if not self._walls_static:
            raise NotImplementedError(
                "prescribed wall motion is not ported yet (scene-modules "
                "slice)")

        n_pad = n_pad if n_pad is not None else cfg.numerics.n_pad
        self.state0: ParticleState = state_lib.make_state(
            grid.prop, grid.position, grid.initial_position, grid.velocity,
            time=grid.time, wall_center=[w.center for w in cfg.walls],
            n_pad=n_pad, dtype=self.dtype, device=self.device,
        )
        self.n_pad = self.state0.n_pad

        # static solid precomputation from the reference configuration
        # (calculateInitialNeighbor + calculateNormalizer, run once at init,
        # src/main.cpp:564, :570), host-side over the structure subset only
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

        # windows are clipped at the domain edge, not wrapped: a scene whose
        # pairs span the periodic boundary needs ghost rows
        self._frame_grid = self.cell_grid
        axes = wrapped_axes(self.cell_grid, grid.position, grid.prop >= 0,
                            self._frame_support, cfg.two_dimensional)
        if any(axes):
            raise NotImplementedError(
                f"pairs span the periodic boundary on axes {axes}: periodic "
                "ghosts are not ported yet (periodic-ghosts slice)")
        if not cfg.two_dimensional and self._frame_grid.cell_count[2] > 1:
            raise NotImplementedError(
                "3-D frames need plane padding, which is not ported yet "
                "(3-D slice)")
        # 'auto' is the field-major sweep; a frame of 2^24 cells or more
        # goes to the row-major one, exactly as in the JAX package (there
        # the field-major kernels carry keys as float32 lanes)
        self._backend = ("pallas_t" if cfg.numerics.backend == "auto"
                         else cfg.numerics.backend)
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

        self.rebuilds = 0  # frame rebuilds over every run_chunk so far
        self.last_chunk_rebuilds = 0
        # set to a list to record ("name", torch.cuda.Event) marks at the
        # section ends of every step and of every diagnostics call
        # (chip_smoke.py's breakdowns)
        self.profile_events: Optional[list] = None
        # host seconds of the last diagnostics() call: device work with its
        # copies to the host, and the numpy tensor assembly
        self.last_diagnostics_seconds: dict = {}

    # ------------------------------------------------------------------
    def _host_vec(self, values) -> torch.Tensor:
        return torch.tensor([float(v) for v in values],
                            dtype=torch.float64).to(self.device, self.dtype)

    def _mark(self, name: str) -> None:
        if self.profile_events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.profile_events.append((name, ev))

    @property
    def _frame_support(self) -> float:
        """Reach of the frame: support + the C8 margin."""
        return (self.kernels.support_radius
                + self.cfg.numerics.rebuild_margin * self.spacing)

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
        """Host-side structure-structure neighbor search over InitialPosition
        (calculateInitialNeighbor, src/main.cpp:1497-1658): support radius
        MaxRadius+MARGIN, periodic min-image, self excluded.  Returns
        ``(idx, mask)``, both ``[n_pad, K0]`` over padded slot indices, with
        each row's neighbors in ascending slot order."""
        k0 = self.cfg.numerics.max_initial_neighbors
        n_pad = self.n_pad
        prop = grid.prop
        s_idx = np.nonzero((prop >= 2) & (prop < 4))[0]
        hits_per: dict = {}
        if s_idx.size:
            p0 = grid.initial_position[s_idx]
            width = np.asarray(self.domain_width)
            dmin = np.asarray(self.domain_min)
            support = self.kernels.support_radius
            # periodic cell binning over the structure subset (float64)
            nc = np.maximum(1, np.floor(width / support).astype(np.int64))
            cw = width / nc
            rel = (p0 - dmin) - width * np.floor((p0 - dmin) / width)
            cells = np.minimum(np.floor(rel / cw).astype(np.int64), nc - 1)
            keys = {}
            for a, c in enumerate(map(tuple, cells)):
                keys.setdefault(c, []).append(a)
            offsets = [
                (dx, dy, dz)
                for dx in ((-1, 0, 1) if nc[0] >= 3 else range(nc[0]))
                for dy in ((-1, 0, 1) if nc[1] >= 3 else range(nc[1]))
                for dz in ((-1, 0, 1) if nc[2] >= 3 else range(nc[2]))
            ]
            r2max = support * support
            for a in range(s_idx.size):
                c = cells[a]
                cand = []
                for dx, dy, dz in offsets:
                    cc = ((c[0] + dx) % nc[0], (c[1] + dy) % nc[1], (c[2] + dz) % nc[2])
                    cand.extend(keys.get(cc, ()))
                cand = np.asarray(sorted(set(b for b in cand if b != a)), dtype=np.int64)
                if cand.size == 0:
                    continue
                d = p0[cand] - p0[a]
                d -= width * np.floor(d / width + 0.5)
                r2 = np.sum(d * d, axis=1)
                hits_per[s_idx[a]] = cand[r2 <= r2max]
        # K0 is an array-sizing knob, not a physical limit: grow it to the
        # measured max (rounded to 8)
        kmax = max((h.size for h in hits_per.values()), default=0)
        if kmax > k0:
            k0 = int(np.ceil(kmax / 8.0)) * 8
        idx = np.zeros((n_pad, k0), dtype=np.int32)
        mask = np.zeros((n_pad, k0), dtype=bool)
        for i, hits in hits_per.items():
            idx[i, : hits.size] = s_idx[hits]
            mask[i, : hits.size] = True
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

    def _pair_forces(self, frame: pk.SortedFrame, windows):
        """Phase 1 + EOS, phase 2, gravity, and the return to slot order,
        for a frame that is already sorted."""
        fgrid = self._frame_grid
        phase1, phase2, _ = self._sweeps
        f1 = phase1(frame, fgrid, self.kernels, self.tables, cfg=self._pcfg,
                    windows=windows)
        self._mark("phase1")
        force_s = phase2(
            frame, f1, fgrid, self.kernels, self.tables, volume=self.volume,
            two_dimensional=self.cfg.two_dimensional, cfg=self._pcfg,
            windows=windows)
        self._mark("phase2")
        # gravity on fluid + structure, in sorted order
        sprop = frame.prop
        seg = Segments(sprop)
        mass_s = self.tables.density[torch.clamp(sprop, 0, 5).long()] * self.volume
        fs = seg.fluid | seg.structure
        force_s = force_s + torch.where(
            fs[:, None], mass_s[:, None] * self._grav_t,
            torch.zeros((), dtype=self.dtype, device=self.device))
        (force,) = pk.unsort(frame, force_s)
        return force

    def _force(self, pos, vel, prop):
        """Total pairwise + body force with a fresh frame (no reuse).  One
        window table serves both phases (the JAX row-major functions each
        compute the same table again)."""
        frame = pk.sort_frame(pos, vel, prop, self._frame_grid)
        windows = pw.compute_windows(frame, self._frame_grid, self._pcfg)
        self._mark("frame")
        return self._pair_forces(frame, windows)

    @property
    def _margin_cached(self) -> bool:
        """C8 skip active: a margin is configured and the backend is the one
        that carries a reusable frame and window tables (``pallas_t``; the
        row-major ``pallas`` rebuilds every step, as in the JAX package)."""
        return (self.cfg.numerics.rebuild_margin > 0.0
                and self._backend == "pallas_t")

    def _init_cache(self, state: ParticleState) -> dict:
        """Empty frame cache whose infinite ``ref_pos`` forces a rebuild on
        first use (``pos - inf`` is not finite, so the cache is stale)."""
        return dict(
            orig=None, key=None, prop_s=None, ws=None, wl=None,
            ref_pos=torch.full_like(state.pos, float("inf")),
            rebuilds=0,
        )

    def _force_cached(self, pos, vel, prop, cache: dict, probe=None):
        """Force evaluation under the C8 margin predicate
        (neighborCalculation, src/main.cpp:1472-1494): reuse the cached sort
        permutation + window tables until the displacement set's diameter
        exceeds the margin.  The candidate support is widened by the margin
        (cell_grid build), so the stale frame still covers every pair within
        the true support; family-radius masks test CURRENT positions, so
        forces are exact either way -- only the summation order differs.
        Returns ``(force, new_cache)``.

        The predicate is the DIAMETER of the displacement set, not the max
        displacement: pair validity depends on relative motion only.  The
        branch is a Python ``if`` on one device scalar: one host
        synchronisation a step.

        ``probe`` (the guarded chunk's squared top speed of the state that
        this step starts from) is read in that same transfer; where it is
        not finite or not below the speed bound, nothing is evaluated and
        ``(None, cache)`` is returned."""
        d = pos - cache["ref_pos"]
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

        if probe is None:
            disp2_host = disp2.item()
        else:
            disp2_host, v2 = torch.stack([disp2, probe]).tolist()
            if not self._healthy(v2):
                return None, cache
        if disp2_host > self._rebuild_thresh2:
            frame = pk.sort_frame(pos, vel, prop, self._frame_grid)
            ws, wl_ = pw.compute_windows(frame, self._frame_grid, self._pcfg)
            new_cache = dict(orig=frame.orig, key=frame.key,
                             prop_s=frame.prop, ws=ws, wl=wl_, ref_pos=pos,
                             rebuilds=cache["rebuilds"] + 1)
        else:
            orig = cache["orig"]
            frame = pk.SortedFrame(key=cache["key"], pos=pos[orig],
                                   vel=vel[orig], prop=cache["prop_s"],
                                   orig=orig)
            ws, wl_ = cache["ws"], cache["wl"]
            new_cache = cache
        self._mark("frame")
        return self._pair_forces(frame, (ws, wl_)), new_cache

    def _step_core(self, state: ParticleState, cache, probe=None):
        """One full time step (the loop body of main(), src/main.cpp:592-686).
        ``cache`` is the C8 frame cache (None = rebuild every step).  With a
        cache, ``probe`` is handed to :meth:`_force_cached`; where that finds
        the state diverged, the step is not taken and ``(None, cache)`` is
        returned."""
        cfg = self.cfg
        dt = cfg.dt
        prop = state.prop
        vel, time = state.vel, state.time
        self._mark("begin")

        # walls are static here (checked at setup): no prescribed motion
        pos = wl.periodic_wrap(state.pos, self._dmin_t, self._width_t)

        if cache is None:
            force = self._force(pos, vel, prop)
        else:
            force, cache = self._force_cached(pos, vel, prop, cache, probe)
            if force is None:
                return None, cache

        # velocity kick for fluid + structure (calculateAcceleration,
        # src/main.cpp:2938-2955)
        seg = Segments(prop)
        fs = seg.fluid | seg.structure
        mass = self.tables.density[torch.clamp(prop, 0, 5).long()] * self.volume
        accel = force / torch.where(mass > 0, mass, torch.ones_like(mass))[:, None]
        vel = torch.where(fs[:, None], vel + accel * dt, vel)

        # fluid drift (calculateConvection, src/main.cpp:1892-1906)
        pos = torch.where(seg.fluid[:, None], pos + vel * dt, pos)
        self._mark("integrate")

        # elastic substeps (src/main.cpp:653-663); skipped when the scene
        # has no structure particles
        if self.has_structure and cfg.substeps > 0:
            pos, vel = sl.run_substeps(
                pos, vel, self.solid, self._width_t, cfg.elastic_dt,
                cfg.substeps,
                double_position_update=cfg.compat.double_substep_position_update,
            )
            self._mark("solid")

        return state.replace(pos=pos, vel=vel, time=time + dt), cache

    def apply_initial_velocity_profile(self, state: ParticleState):
        """The scene's initial velocity profile (``bar_first_mode`` of the
        JAX package); it comes with the scene-modules slice."""
        raise NotImplementedError(
            "apply_initial_velocity_profile (the 'bar_first_mode' profile) "
            "is not ported yet (scene-modules slice)")

    def _refuse_wrap(self, extremes: list, where=None) -> None:
        """Raise where pairs of a state span the periodic boundary, as
        set-up does: the window sweeps clip windows at the domain edge, so
        without ghost rows such pairs would be dropped without a word.
        ``extremes`` holds the :func:`valid_extremes` of the states a chunk
        sweeps and returns, in order, the state it starts from first (the
        error names the first that wraps and its step), or of the one state
        that ``where`` names.  They are read back in one transfer, so a
        chunk tests every step's state for one small reduction a step and
        one host read.  A stop-gap: the periodic-ghost slice replaces it
        with the JAX package's ghost refresh at every chunk boundary."""
        for k, (lo, hi) in enumerate(torch.stack(extremes).tolist()):
            axes = _wrap_test(self.cell_grid, lo, hi, self._frame_support,
                              self.cfg.two_dimensional)
            if any(axes):
                names = ", ".join(a for a, w in zip("xyz", axes) if w)
                at = where or ("in the state the chunk starts from" if k == 0
                               else f"after {k} steps of the chunk")
                raise NotImplementedError(
                    f"pairs span the periodic boundary on axis {names} {at}: "
                    "periodic ghosts are not ported yet (periodic-ghosts "
                    "slice), and without them the window sweeps would drop "
                    "those pairs")

    # ------------------------------------------------------------------
    def step(self, state: ParticleState) -> ParticleState:
        """One step with a fresh frame; the input state is left intact."""
        with torch.no_grad():
            return self._step_core(state, None)[0]

    def run_chunk(self, state: ParticleState, n_steps: int) -> ParticleState:
        """``n_steps`` steps.  With a rebuild margin the frame cache lives
        for the chunk (it starts empty, so the first step rebuilds), as in
        the JAX package; ``last_chunk_rebuilds`` and ``rebuilds`` count the
        frame rebuilds.  The input state is left intact.

        Raises ``NotImplementedError``, once the chunk is done, where pairs
        of the state it starts from, of any state a step of it starts from,
        or of the state it would return span the periodic boundary
        (:meth:`_refuse_wrap`)."""
        cache = self._init_cache(state) if self._margin_cached else None
        with torch.no_grad():
            invalid = state.prop < 0  # types do not change inside a chunk
            extremes = [valid_extremes(state.pos, invalid)]
            for _ in range(n_steps):
                state, cache = self._step_core(state, cache)
                extremes.append(valid_extremes(state.pos, invalid))
        done = cache["rebuilds"] if cache is not None else n_steps
        self.last_chunk_rebuilds = done
        self.rebuilds += done
        self._refuse_wrap(extremes)
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

        With a rebuild margin the step already reads one device scalar a
        step (the C8 predicate); the health scalar of the state a step
        starts from is read in that same transfer, so the guard adds one
        small reduction a step and one host read a chunk (for the last
        state).  Without a margin there is no such read and the guard makes
        its own, once a step.

        Raises ``NotImplementedError`` as :meth:`run_chunk` does, where a
        chunk stays healthy.  A diverged chunk is returned with ``healthy``
        False and not tested: the caller discards it and runs again from an
        earlier state, and that run is tested."""
        cache = self._init_cache(state) if self._margin_cached else None
        done, healthy = 0, True
        with torch.no_grad():
            invalid = state.prop < 0  # types do not change inside a chunk
            extremes = [valid_extremes(state.pos, invalid)]
            probe = None  # the entry state is not judged, as in the JAX loop
            while done < n_steps:
                nxt, cache = self._step_core(state, cache, probe)
                if nxt is None:  # `state`, the result of step `done`, is bad
                    healthy = False
                    break
                state, done = nxt, done + 1
                extremes.append(valid_extremes(state.pos, invalid))
                probe = self._top_speed2(state, invalid)
                if cache is None and not self._healthy(probe.item()):
                    healthy = False
                    break
            if healthy and cache is not None and probe is not None:
                healthy = self._healthy(probe.item())
        rebuilds = cache["rebuilds"] if cache is not None else done
        self.last_chunk_rebuilds = rebuilds
        self.rebuilds += rebuilds
        if healthy:
            self._refuse_wrap(extremes)
        return state, done, healthy

    # ------------------------------------------------------------------
    def _diagnostics(self, state: ParticleState) -> dict:
        """Output-time field recomputation (VTK fields + virial stress,
        src/main.cpp:984-1189, 3077-3318) on the device: a fresh frame and
        fresh windows (never the C8 cache, so every field is in one frame's
        order), phase 1 with the neighbour count, phase 2, the virial sweep,
        then one scatter back to slot order.

        Tensor outputs come in memory-friendly layouts -- solid tensors in
        compact subset space [S, sd, sd], virial components [9, N] -- and
        are assembled on the host by :meth:`diagnostics`."""
        cfg = self.cfg
        prop, pos, vel = state.prop, state.pos, state.vel
        fgrid, pcfg = self._frame_grid, self._pcfg
        phase1, phase2, virial = self._sweeps
        self._mark("begin")
        frame = pk.sort_frame(pos, vel, prop, fgrid)
        windows = pw.compute_windows(frame, fgrid, pcfg)
        self._mark("frame")
        f1 = phase1(frame, fgrid, self.kernels, self.tables, cfg=pcfg,
                    windows=windows, count=True)
        self._mark("phase1")
        force_s = phase2(
            frame, f1, fgrid, self.kernels, self.tables, volume=self.volume,
            two_dimensional=cfg.two_dimensional, cfg=pcfg, windows=windows)
        self._mark("phase2")
        virial_s, vp_s = virial(
            frame, f1, fgrid, self.kernels, self.tables, volume=self.volume,
            two_dimensional=cfg.two_dimensional, cfg=pcfg, windows=windows)
        self._mark("virial")
        # true max cell occupancy (the window sweep consults no cell
        # capacity; the metric stays commensurate with the other engines')
        edges = torch.searchsorted(
            frame.key, torch.arange(fgrid.num_cells + 1, dtype=torch.int32,
                                    device=self.device))
        cell_overflow = (edges[1:] - edges[:-1]).max().to(torch.int32)

        # back to slot order: all rows in one scatter by the permutation
        rows = torch.cat([
            force_s.T, f1["pressure_p"][None], f1["pressure_a"][None],
            f1["vol_strain"][None], f1["density_a"][None],
            f1["divergence"][None], f1["gravity_center"].T,
            f1["neighbor_count"].to(self.dtype)[None], vp_s[None], virial_s,
        ])
        slot = torch.empty_like(rows)
        slot[:, frame.orig] = rows
        force = slot[0:3].T
        pp, pa, vs, da = slot[3], slot[4], slot[5], slot[6]
        gc, nbr_count, vp, virial_rows = slot[8:11].T, slot[11], slot[12], slot[13:22]
        self._mark("unsort")

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
            # no ghost rows in this port yet
            ghost_overflow=torch.zeros((), dtype=torch.int32,
                                       device=self.device),
            window_overflow=self._window_overflow(windows),
            virial_rows=virial_rows,
            virial_pressure=vp,
            max_speed=torch.where(seg.valid, torch.linalg.norm(vel, dim=1),
                                  zero).max(),
        )
        self._mark("solid and tail")
        return out

    @staticmethod
    def _window_overflow(windows) -> torch.Tensor:
        """Longest window of the frame.  The sweeps walk windows of any
        length exactly, so nothing overflows: this is a load signal only
        (the command line logs it as ``window_len``)."""
        return windows[1].max().to(torch.int32)

    def diagnostics(self, state: ParticleState) -> dict:
        """Device diagnostics + host-side tensor assembly (the full [N,3,3]
        arrays are built in numpy).  Keys, shapes and dtypes are those of the
        JAX package's ``Simulation.diagnostics``.  Raises
        ``NotImplementedError`` where pairs of ``state`` span the periodic
        boundary (:meth:`_refuse_wrap`): the sweeps here use the same
        unghosted frame as the step."""
        t0 = _time.perf_counter()
        self._refuse_wrap([valid_extremes(state.pos, state.prop < 0)],
                          "in the state of the diagnostics")
        with torch.no_grad():
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
