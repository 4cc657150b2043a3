"""The simulation: setup, the time step, and the chunked run loop.

Counterpart of ``particlemethod_fsi_tpu/solver.py``, for the window-sweep
backend (``pallas_t`` there) on one device.  Ported: ``adjust_domain``,
``Simulation.__init__`` (without ghosts, 3-D plane padding and diagnostics),
``_is_planar``, ``_initial_structure_neighbors``, ``_force``,
``_margin_cached``, ``_init_cache``, ``_force_cached`` (without the ghost
branches), ``_step_core``, ``step`` and ``run_chunk``.  Sequence of one step
(matching src/main.cpp:592-663):

  periodic wrap -> frame rebuild or reuse (C8 predicate) -> phase 1
  (densities, divergence) + EOS -> phase 2 (pairwise forces) -> gravity ->
  velocity kick (fluid + structure) -> fluid convection -> elastic substeps.

Not ported yet, and raised for by name rather than run some other way:
prescribed wall motion and ``Rolling``, the Turek inlet and the Bar initial
velocity profile, periodic ghosts, 3-D plane padding, frames of 2^24 cells or
more, the ``pallas`` / ``packed`` / ``gather`` backends, the divergence-guarded
chunk and the diagnostics.

PyTorch runs eagerly, so where the JAX package traces ``lax.cond`` and
``lax.scan`` this module has a Python ``if`` on one device scalar a step (a
host synchronisation) and a Python loop.  Every op returns new tensors:
``step`` and ``run_chunk`` leave their input state intact.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from particlemethod_fsi_tpu_torch import state as state_lib
from particlemethod_fsi_tpu_torch.config import CaseConfig
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


def wrapped_axes(grid: CellGrid, positions, valid, support: float,
                 two_dimensional: bool):
    """Axes where interacting pairs span the periodic boundary (the test of
    ``ops/ghosts.py::wrapped_axes`` in the JAX package; such a scene needs
    ghost rows, which are not ported yet)."""
    pos = np.asarray(positions)[np.asarray(valid)]
    axes = [False, False, False]
    if pos.size == 0:
        return tuple(axes)
    for d in range(3):
        if grid.cell_count[d] < 3 or (two_dimensional and d == 2):
            continue
        lo = float(pos[:, d].min()) - grid.domain_min[d]
        hi = grid.domain_min[d] + grid.domain_width[d] - float(pos[:, d].max())
        if lo + hi < support:
            axes[d] = True
    return tuple(axes)


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

        if cfg.numerics.backend not in ("auto", "pallas_t"):
            raise NotImplementedError(
                f"backend {cfg.numerics.backend!r}: only the window sweep "
                "('pallas_t', or 'auto') is ported; the row-major, packed "
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
        if self._frame_grid.num_cells >= (1 << 24):
            raise NotImplementedError(
                "frames of 2^24 cells or more run on the row-major kernels "
                "in the JAX package; those are not ported yet")

        self._pcfg = make_window_config(cfg, self.kernels,
                                        planar=self._is_planar(grid))
        if self.n_pad % self._pcfg.block != 0:
            raise ValueError(
                f"n_pad={self.n_pad} is not a multiple of the receiver block "
                f"{self._pcfg.block}")
        self._grav_t = self._host_vec(cfg.gravity)

        self.rebuilds = 0  # frame rebuilds over every run_chunk so far
        self.last_chunk_rebuilds = 0
        # set to a list to record ("name", torch.cuda.Event) marks at the
        # section ends of every step (chip_smoke.py's breakdown)
        self.profile_events: Optional[list] = None

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
    def _pair_forces(self, frame: pk.SortedFrame, windows):
        """Phase 1 + EOS, phase 2, gravity, and the return to slot order,
        for a frame that is already sorted."""
        fgrid = self._frame_grid
        f1 = pwt.phase1_fields_t(frame, fgrid, self.kernels, self.tables,
                                 cfg=self._pcfg, windows=windows)
        self._mark("phase1")
        force_s = pwt.phase2_forces_t(
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
        """Total pairwise + body force with a fresh frame (no reuse)."""
        frame = pk.sort_frame(pos, vel, prop, self._frame_grid)
        windows = pw.compute_windows(frame, self._frame_grid, self._pcfg)
        self._mark("frame")
        return self._pair_forces(frame, windows)

    @property
    def _margin_cached(self) -> bool:
        """C8 skip active: a margin is configured."""
        return self.cfg.numerics.rebuild_margin > 0.0

    def _init_cache(self, state: ParticleState) -> dict:
        """Empty frame cache whose infinite ``ref_pos`` forces a rebuild on
        first use (``pos - inf`` is not finite, so the cache is stale)."""
        return dict(
            orig=None, key=None, prop_s=None, ws=None, wl=None,
            ref_pos=torch.full_like(state.pos, float("inf")),
            rebuilds=0,
        )

    def _force_cached(self, pos, vel, prop, cache: dict):
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
        synchronisation a step."""
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

        if disp2.item() > self._rebuild_thresh2:
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

    def _step_core(self, state: ParticleState, cache):
        """One full time step (the loop body of main(), src/main.cpp:592-686).
        ``cache`` is the C8 frame cache (None = rebuild every step)."""
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
            force, cache = self._force_cached(pos, vel, prop, cache)

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

    # ------------------------------------------------------------------
    def step(self, state: ParticleState) -> ParticleState:
        """One step with a fresh frame; the input state is left intact."""
        with torch.no_grad():
            return self._step_core(state, None)[0]

    def run_chunk(self, state: ParticleState, n_steps: int) -> ParticleState:
        """``n_steps`` steps.  With a rebuild margin the frame cache lives
        for the chunk (it starts empty, so the first step rebuilds), as in
        the JAX package; ``last_chunk_rebuilds`` and ``rebuilds`` count the
        frame rebuilds.  The input state is left intact."""
        cache = self._init_cache(state) if self._margin_cached else None
        with torch.no_grad():
            for _ in range(n_steps):
                state, cache = self._step_core(state, cache)
        done = cache["rebuilds"] if cache is not None else n_steps
        self.last_chunk_rebuilds = done
        self.rebuilds += done
        return state
