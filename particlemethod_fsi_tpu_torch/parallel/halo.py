"""Multi-device slab decomposition with particle migration and ghost-strip
exchange over a ring of ranks: the 1-D halo mode.

Counterpart of ``particlemethod_fsi_tpu/parallel/halo.py`` for a 1-axis
mesh (``ny == 1``): :class:`HaloConfig`, :class:`HaloState`,
:func:`mesh_shape`, :func:`uniform_splits`, :func:`compute_splits`,
:func:`default_halo_config`, :func:`partition_state`, :func:`rebalance`,
:func:`regrow_config` (with :func:`regrow_sizes`), :func:`quantize_config`,
:func:`adapt_config` (with :func:`adapt_sizes`),
:func:`gather_state`, :func:`to_slot_state` and :func:`make_halo_step`
(here a :class:`HaloStep` object with ``step``, ``run_chunk`` and
``run_chunk_guarded``, and the local engine's name in ``engine`` where the
JAX function keeps it in an attribute of itself).  Not ported yet: the
2-axis rectangles (``compute_splits_y``, ``normalize_splits_y``, the y
strips and the y ring).

Each rank is a process with one device and holds its own region: the
fluid and wall rows whose x lies in ``[splits[rank], splits[rank + 1])``,
in a buffer of ``capacity`` rows (``prop = -1`` where empty), with each
row's original slot id ``oid`` (int32 end to end), plus the structure
particles replicated on every rank.  A step, as in the JAX step:

* the C8 predicate: the largest displacement since the last rebuild over
  every rank (a MAX all-reduce, read once a step, so every rank takes the
  same branch);
* on a rebuild, migrants go one hop along the ring to their destination
  region (routed by destination, so a particle that wrapped from xmax to x0
  takes one hop), overflow migrants stay and are counted, the region is
  compacted and the x strips (one support plus the C8 margin deep) are
  selected afresh; at one rank nothing can migrate and nothing is
  exchanged;
* every step, each strip's rows ride the ring to the neighbour as ghost
  rows; on the window sweep they are shifted by the domain width where they
  crossed the global boundary, into the one-cell ghost layer on each x side
  of the frame grid (:func:`_extended_grid`); the packed engine takes the
  minimum image instead (and dedupes the strips at two ranks, drops them at
  one);
* phase 1 on the frame of own rows, ghost rows and structure rows (the
  window sweep, ``pallas_t``: kernel 1, with the frame, windows and strips
  reused while the predicate holds; or the packed engine), then the ghost
  rows' fields from their owners (pressure P always; pressure A and the
  gravity centre only with surface tension; mu never), the structure rows'
  fields as owner-masked sums, phase 2 (kernel 2 or the packed engine), the
  kick and drift of own rows, and the replicated elastic substeps.

Every rank issues the same collectives in the same order.  Where the JAX
step runs a ``ppermute`` unconditionally, the port skips it only on a
branch every rank takes together (the rebuild, after the all-reduce); the
device-local skips of the JAX step (no migrant on this shard) are local
work only.  At one rank a ring exchange is a local copy.

Where the port's host code differs from the JAX module (``ADVICE.md``'s
notes on it):

* :func:`adapt_config` clamps the fresh caps to the capacity, as
  :func:`make_halo_step` does, before comparing them with the running ones
  (the JAX function compares unclamped caps, so a geometry-sized halo cap
  above the capacity reads as growth at every output);
* its shrink metric counts the migration buffers (``2 * migration_cap``)
  beside the frame rows, so a config inflated only there shrinks too;
* :func:`regrow_wanted` (the command line's proactive capacity check)
  triggers where the fullest region passes ``1 / margin`` of its capacity,
  the fill the occupancy margin sizes for, where the JAX command line
  triggers at a fixed 0.95 (with margin 1.08 that left 2.4 % of drift).
"""

from __future__ import annotations

import types
from typing import NamedTuple, Optional

import numpy as np
import torch

from particlemethod_fsi_tpu_torch.ops import ghosts as gh
from particlemethod_fsi_tpu_torch.ops import packed_engine as pk
from particlemethod_fsi_tpu_torch.ops import solid as sl
from particlemethod_fsi_tpu_torch.ops import walls as wl
from particlemethod_fsi_tpu_torch.ops import windows as pw
from particlemethod_fsi_tpu_torch.ops import windows_t as pwt
from particlemethod_fsi_tpu_torch.ops.neighbors import CellGrid
from particlemethod_fsi_tpu_torch.parallel.comm import Comm
from particlemethod_fsi_tpu_torch.solver import Simulation, _inverse_permutation
from particlemethod_fsi_tpu_torch.state import ParticleState, Segments


class HaloConfig(NamedTuple):
    capacity: int  # per-rank particle slots (own fluid/wall particles)
    migration_cap: int = 256  # max migrants per direction per step
    halo_cap: int = 2048  # max x-halo particles per direction
    halo_cap_y: int = 0  # y halo of a 2-axis mesh: 0 here (1-D slabs only)


class HaloState(NamedTuple):
    """One rank's region rows and the replicated part of the state."""

    prop: torch.Tensor  # [cap] int32, -1 = empty
    pos: torch.Tensor  # [cap, 3]
    pos0: torch.Tensor
    vel: torch.Tensor
    oid: torch.Tensor  # [cap] int32 original slot id (-1 = empty)
    s_pos: torch.Tensor  # [S_pad, 3] replicated structure positions
    s_vel: torch.Tensor  # [S_pad, 3]
    wall_center: torch.Tensor
    splits: torch.Tensor  # [n+1] region boundaries along x (replicated)
    time: torch.Tensor


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def mesh_shape(comm: Comm) -> tuple[int, int]:
    """(nx, ny) of the decomposition: (ranks, 1), 1-D slabs."""
    return comm.size, 1


def uniform_splits(sim, n: int, axis: int = 0) -> np.ndarray:
    lo = sim.domain_min[axis]
    w = sim.domain_width[axis] / n
    return lo + w * np.arange(n + 1)


def _ghost_reach(sim) -> float:
    return (sim.kernels.support_radius
            + sim.cfg.numerics.rebuild_margin * sim.spacing)


def _clip_min_width(s, lo, hi, n, support):
    """Enforce the ghost-reach minimum width on a [n+1] split array."""
    s = np.asarray(s, dtype=np.float64).copy()
    s[0], s[-1] = lo, hi
    for i in range(1, n + 1):
        s[i] = max(s[i], s[i - 1] + support)
    s[-1] = hi
    for i in range(n - 1, 0, -1):
        s[i] = min(s[i], s[i + 1] - support)
    if s[0] > s[1] - support:
        raise ValueError("split clipping failed: domain too narrow")
    return s


def compute_splits(sim, ndev: int, positions, valid,
                   axis: int = 0) -> np.ndarray:
    """Equal-count split planes along one axis: coordinate quantiles of the
    mobile particles, clipped so every region stays at least one ghost reach
    (support + the C8 margin) wide: a narrower region would need two-hop
    ghosts the ring never delivers."""
    x = _np(positions)[_np(valid), axis]
    lo = sim.domain_min[axis]
    hi = lo + sim.domain_width[axis]
    support = _ghost_reach(sim)
    if (hi - lo) < ndev * support:
        raise ValueError(
            f"domain axis-{axis} width {hi - lo:g} cannot host {ndev} "
            f"regions of minimum width {support:g}")
    q = np.quantile(x, np.linspace(0.0, 1.0, ndev + 1)) if x.size else \
        uniform_splits(sim, ndev, axis)
    return _clip_min_width(q, lo, hi, ndev, support)


def _dest_regions(pos, splits, nx):
    """Host-side destination region per particle."""
    return np.clip(np.searchsorted(splits, pos[:, 0], side="right") - 1,
                   0, nx - 1)


def default_halo_config(sim, ndev: int, *, occupancy_margin: float = 1.2,
                        splits: Optional[np.ndarray] = None, state=None,
                        npad_floor: bool = True) -> HaloConfig:
    """Size the per-rank buffers from the case geometry: a halo strip is
    one support radius (plus the C8 margin and a row of slack) deep by the
    domain's full cross-section, counted in lattice sites.  With
    ``splits`` the capacity is also sized from the initial occupancy of the
    regions under those planes; ``npad_floor=False`` (which needs
    ``splits``) drops the ``n_pad``-based floor and sizes from that peak
    alone.  Every cap is a multiple of 128 rows."""
    nx = int(ndev)
    if splits is None:
        npad_floor = True  # no occupancy measurement to size from
    cap = int(np.ceil(sim.n_pad * occupancy_margin / nx / 128.0)) * 128 \
        if npad_floor else 0
    s = sim.state0 if state is None else state
    prop = _np(s.prop)
    pos = _np(s.pos)
    valid = (prop >= 0) & ~((prop >= 2) & (prop < 4))
    if splits is not None:
        dest = _dest_regions(pos[valid], np.asarray(splits), nx)
        peak = int(np.bincount(dest, minlength=nx).max())
        cap = max(cap, int(np.ceil(peak * occupancy_margin / 128.0)) * 128)
    l0 = sim.spacing
    depth_rows = (sim.kernels.support_radius / l0
                  + sim.cfg.numerics.rebuild_margin)
    z_sites = 1.0 if sim.cfg.two_dimensional else sim.domain_width[2] / l0
    cross_sites = sim.domain_width[1] / l0
    strip_particles = cross_sites * (depth_rows + 1.0) * z_sites
    halo = int(np.ceil(strip_particles * occupancy_margin / 128.0)) * 128
    return HaloConfig(capacity=cap, migration_cap=max(256, halo // 4),
                      halo_cap=halo, halo_cap_y=0)


def _slot_arrays(sim, state):
    """(prop, pos, vel, pos0, oid, time, wall_center) on the host of a
    slot-ordered state (``sim.state0`` when None) or of a gathered dict."""
    s = sim.state0 if state is None else state
    if isinstance(s, dict):
        return (np.asarray(s["prop"]), np.asarray(s["pos"]),
                np.asarray(s["vel"]), np.asarray(s["pos0"]),
                np.asarray(s["oid"]), float(s["time"]),
                np.asarray(s["wall_center"]))
    prop = _np(s.prop)
    return (prop, _np(s.pos), _np(s.vel), _np(s.pos0),
            np.arange(prop.shape[0], dtype=np.int32), float(s.time),
            _np(s.wall_center))


def partition_state(sim, comm: Comm, hcfg: HaloConfig,
                    splits: Optional[np.ndarray] = None,
                    state=None) -> HaloState:
    """Host-side partition: the fluid and wall particles into the regions
    of ``splits`` (equal width by default), this rank's region as its
    state; the structure particles into the replicated subset arrays.
    ``state`` defaults to ``sim.state0`` (a gathered dict from
    :func:`gather_state` re-partitions mid-run).  Every rank computes the
    same partition from the same input and keeps its own block."""
    nx = comm.size
    splits = uniform_splits(sim, nx, 0) if splits is None \
        else np.asarray(splits)
    reach = _ghost_reach(sim)
    if nx > 1:
        widths = np.diff(np.asarray(splits, dtype=np.float64))
        if widths.min() < reach - 1e-12:
            raise ValueError(
                f"x region width {widths.min():g} < ghost reach "
                f"{reach:g} (support + rebuild margin); use fewer devices "
                "or equal-count splits")
    prop, pos, vel, pos0, oid, time, wall_center = _slot_arrays(sim, state)
    is_struct = (prop >= 2) & (prop < 4)
    valid = (prop >= 0) & ~is_struct
    out = _fill_regions(prop, pos, vel, pos0, oid, valid, splits, nx,
                        hcfg.capacity)
    if isinstance(state, dict):
        s_pos = np.asarray(state["s_pos"])
        s_vel = np.asarray(state["s_vel"])
    else:
        # replicated structure subset (solid-static order) from slot arrays
        s_idx = _np(sim.solid.s_idx)
        s_valid = _np(sim.solid.s_valid)
        safe = np.where(s_valid, s_idx, 0)
        s_pos = np.where(s_valid[:, None], pos[safe], 0.0)
        s_vel = np.where(s_valid[:, None], vel[safe], 0.0)

    c = hcfg.capacity
    blk = slice(comm.rank * c, (comm.rank + 1) * c)

    def dev(a, dtype=None):
        return torch.as_tensor(np.array(a, order="C")).to(
            sim.device, sim.dtype if dtype is None else dtype)

    return HaloState(
        prop=dev(out["prop"][blk], torch.int32), pos=dev(out["pos"][blk]),
        pos0=dev(out["pos0"][blk]), vel=dev(out["vel"][blk]),
        oid=dev(out["oid"][blk], torch.int32),
        s_pos=dev(s_pos), s_vel=dev(s_vel), wall_center=dev(wall_center),
        splits=dev(splits), time=dev(np.asarray(time)))


def _fill_regions(prop, pos, vel, pos0, oid, valid, splits, nx, c):
    dest = _dest_regions(pos, splits, nx)
    out_prop = np.full((nx * c,), -1, dtype=np.int32)
    out_pos = np.zeros((nx * c, 3), dtype=pos.dtype)
    out_vel = np.zeros((nx * c, 3), dtype=vel.dtype)
    out_pos0 = np.zeros((nx * c, 3), dtype=pos0.dtype)
    out_oid = np.full((nx * c,), -1, dtype=np.int32)
    for r in range(nx):
        idx = np.nonzero(valid & (dest == r))[0]
        if idx.size > c:
            raise ValueError(
                f"region {r} holds {idx.size} particles > capacity {c}; "
                "raise HaloConfig.capacity")
        sli = slice(r * c, r * c + idx.size)
        out_prop[sli] = prop[idx]
        out_pos[sli] = pos[idx]
        out_vel[sli] = vel[idx]
        out_pos0[sli] = pos0[idx]
        out_oid[sli] = oid[idx]
    return dict(prop=out_prop, pos=out_pos, vel=out_vel, pos0=out_pos0,
                oid=out_oid)


def gathered_rows(comm: Comm, state: HaloState) -> dict:
    """Every rank's region rows, in rank order, on the host (one
    all-gather), with the replicated part of the state: the dict that
    :func:`partition_state` re-partitions."""
    prop, pos, vel, pos0, oid = comm.all_gather(
        state.prop, state.pos, state.vel, state.pos0, state.oid)
    return dict(prop=_np(prop), pos=_np(pos), vel=_np(vel), pos0=_np(pos0),
                oid=_np(oid), s_pos=_np(state.s_pos), s_vel=_np(state.s_vel),
                wall_center=_np(state.wall_center), time=float(state.time))


def rebalance(sim, comm: Comm, hcfg: HaloConfig, state: HaloState,
              splits: Optional[np.ndarray] = None) -> HaloState:
    """Load rebalancing at output cadence: equal-count split planes from the
    current distribution (or the ``splits`` given, e.g. by
    :func:`adapt_config`) and a re-partition of the fluid and wall rows
    (the structure subset and the wall state carry over)."""
    g = gathered_rows(comm, state)
    if splits is None:
        splits = compute_splits(sim, comm.size, g["pos"], g["prop"] >= 0)
    return partition_state(sim, comm, hcfg, splits=splits, state=g)


def _region_rows(comm: Comm, state: HaloState):
    """Every rank's ``(prop, pos)`` region rows on the host."""
    prop, pos = comm.all_gather(state.prop, state.pos)
    return _np(prop), _np(pos)


def _fresh_config(sim, nx, prop, pos, **kw):
    """Equal-count planes of the rows' distribution and the halo config
    sized from them (:func:`default_halo_config`)."""
    splits = compute_splits(sim, nx, pos, prop >= 0)
    fresh = default_halo_config(
        sim, nx, splits=splits,
        state=types.SimpleNamespace(prop=prop, pos=pos), **kw)
    return fresh, splits


def regrow_config(sim, comm: Comm, hcfg: HaloConfig,
                  state: HaloState) -> tuple[HaloConfig, np.ndarray]:
    """Grown buffer sizes after a saturation event (:func:`regrow_sizes`
    of every rank's rows)."""
    return regrow_sizes(sim, comm.size, hcfg, *_region_rows(comm, state))


def regrow_sizes(sim, nx: int, hcfg: HaloConfig, prop,
                 pos) -> tuple[HaloConfig, np.ndarray]:
    """Double the migration and halo caps and refresh the capacity from
    the occupancy of the region rows ``prop``, ``pos`` (host arrays) under
    fresh equal-count planes (the overflow count does not say which buffer
    saturated, so all grow).  Returns ``(hcfg, splits)`` for a new
    :func:`make_halo_step` and :func:`partition_state`."""
    fresh, splits = _fresh_config(sim, nx, prop, pos)
    grown = HaloConfig(
        capacity=max(fresh.capacity, hcfg.capacity),
        migration_cap=max(fresh.migration_cap, 2 * hcfg.migration_cap),
        halo_cap=max(fresh.halo_cap, 2 * hcfg.halo_cap),
        halo_cap_y=0)
    return grown, splits


def quantize_config(hcfg: HaloConfig, quantum: int = 1024) -> HaloConfig:
    """Round every cap up to a ``quantum``-row multiple (the quantum itself
    a multiple of 128), so adaptive re-sizing lands on a small recurring set
    of frame shapes."""
    q = max(128, (int(quantum) // 128) * 128)

    def r(v):
        return int(np.ceil(v / q)) * q if v > 0 else 0

    return HaloConfig(capacity=r(hcfg.capacity),
                      migration_cap=r(hcfg.migration_cap),
                      halo_cap=r(hcfg.halo_cap),
                      halo_cap_y=r(hcfg.halo_cap_y))


def clamp_config(hcfg: HaloConfig) -> HaloConfig:
    """The migration and halo caps clamped to the capacity, as
    :func:`make_halo_step` runs them (a strip or a migrant set never holds
    more rows than the region)."""
    return hcfg._replace(migration_cap=min(hcfg.migration_cap, hcfg.capacity),
                         halo_cap=min(hcfg.halo_cap, hcfg.capacity),
                         halo_cap_y=0)


def swept_rows(c: HaloConfig) -> int:
    """The shrink metric of :func:`adapt_config`: the frame rows a step
    sweeps (own + both x ghost strips) and the migration buffers a rebuild
    moves and compacts."""
    return c.capacity + 2 * c.halo_cap + 2 * c.migration_cap


def adapt_config(sim, comm: Comm, hcfg: HaloConfig, state: HaloState,
                 **kw) -> tuple[HaloConfig, np.ndarray, bool]:
    """Occupancy-adaptive buffer sizing at output cadence
    (:func:`adapt_sizes` of every rank's rows)."""
    return adapt_sizes(sim, comm.size, hcfg, *_region_rows(comm, state),
                       **kw)


def adapt_sizes(sim, nx: int, hcfg: HaloConfig, prop, pos, *,
                occupancy_margin: float = 1.08, quantum: int = 1024,
                shrink_quanta: int = 2) -> tuple[HaloConfig, np.ndarray,
                                                 bool]:
    """The caps track the occupancy of the region rows ``prop``, ``pos``
    (host arrays) under fresh equal-count planes: they grow when drift
    concentrated particles, and shrink once rebalancing spread them out
    again, only where that saves at least ``shrink_quanta`` quanta of
    :func:`swept_rows` (so a boundary-straddling occupancy cannot thrash).
    Returns ``(new_hcfg, splits, changed)``; ``changed`` means the caller
    must build a new step and re-partition, else a :func:`rebalance` under
    ``splits`` suffices.  The fresh caps are clamped as the step clamps
    them before they are compared (see the module's notes)."""
    fresh, splits = _fresh_config(sim, nx, prop, pos,
                                  occupancy_margin=occupancy_margin,
                                  npad_floor=False)
    fresh = clamp_config(quantize_config(fresh, quantum))
    grow = any(f > c for f, c in zip(fresh, hcfg))
    if grow:
        new = HaloConfig(*(max(f, c) for f, c in zip(fresh, hcfg)))
    elif swept_rows(fresh) + shrink_quanta * quantum <= swept_rows(hcfg):
        new = fresh
    else:
        new = hcfg
    return new, splits, new != hcfg


def regrow_wanted(occupancy: int, hcfg: HaloConfig,
                  occupancy_margin: float) -> bool:
    """The command line's proactive capacity check: the fullest region
    holds more than ``1 / occupancy_margin`` of the capacity (the fill the
    margin sizes for), so drift inside the next interval could reach the
    capacity, where consolidation loses rows.  The JAX command line tests
    ``occupancy > 0.95 * capacity`` (see the module's notes)."""
    return occupancy * occupancy_margin > hcfg.capacity


def gather_state(sim, comm: Comm, state: HaloState) -> dict:
    """The halo-sharded state on the host (every rank gets it): fluid and
    wall rows in rank order, then the structure rows in subset order;
    ``oid`` gives each row's original slot id."""
    g = gathered_rows(comm, state)
    keep = g["prop"] >= 0
    s_valid = _np(sim.solid.s_valid)
    s_slot = np.where(s_valid, _np(sim.solid.s_idx), 0)
    prop0 = _np(sim.state0.prop)
    pos0_slots = _np(sim.state0.pos0)
    return dict(
        prop=np.concatenate([g["prop"][keep], prop0[s_slot][s_valid]]),
        pos=np.concatenate([g["pos"][keep], g["s_pos"][s_valid]]),
        pos0=np.concatenate([g["pos0"][keep], pos0_slots[s_slot][s_valid]]),
        vel=np.concatenate([g["vel"][keep], g["s_vel"][s_valid]]),
        oid=np.concatenate([g["oid"][keep],
                            s_slot[s_valid].astype(np.int32)]),
        wall_center=g["wall_center"], time=g["time"])


def to_slot_state(sim, comm: Comm, state: HaloState) -> ParticleState:
    """The halo-sharded state restored to a slot-ordered ParticleState on
    ``sim.device`` (the one-device layout), so every one-device output and
    diagnostic path works on multi-device runs unchanged."""
    g = gather_state(sim, comm, state)
    n_pad = sim.n_pad
    prop = np.full(n_pad, -1, dtype=np.int32)
    pos = np.zeros((n_pad, 3), dtype=g["pos"].dtype)
    pos0 = np.zeros_like(pos)
    vel = np.zeros_like(pos)
    oid = g["oid"]
    prop[oid] = g["prop"]
    pos[oid] = g["pos"]
    pos0[oid] = g["pos0"]
    vel[oid] = g["vel"]

    def dev(a, dtype):
        return torch.as_tensor(a).to(sim.device, dtype)

    return ParticleState(
        prop=dev(prop, torch.int32), pos=dev(pos, sim.dtype),
        pos0=dev(pos0, sim.dtype), vel=dev(vel, sim.dtype),
        wall_center=dev(g["wall_center"], sim.dtype),
        time=torch.tensor(g["time"], dtype=sim.dtype, device=sim.device),
        ghost_overflow=torch.zeros((), dtype=torch.int32, device=sim.device))


def _extract(buf_cap: int, key_first, *fields):
    """Fixed-size extraction: the rows where ``key_first`` holds lead, in
    their order; returns the first ``buf_cap`` rows of each field, the
    leading mask, the rows that did not fit and the rows taken."""
    key = (~key_first).to(torch.int32)
    order = torch.sort(key, stable=True).indices
    take = order[:buf_cap]
    mask = key[take] == 0
    overflow = (key == 0).sum() - mask.sum()
    return [a[take] for a in fields], mask, overflow.to(torch.int32), take


def _extended_grid(grid: CellGrid) -> CellGrid:
    """The cell grid grown by one ghost-cell layer on each x side: the halo
    frame's wrap layer.  The window sweep pairs by coordinate adjacency, so
    strips that crossed the global boundary are shifted into this layer."""
    dmin = list(grid.domain_min)
    width = list(grid.domain_width)
    counts = list(grid.cell_count)
    cw = grid.cell_width
    dmin[0] -= cw[0]
    width[0] += 2.0 * cw[0]
    counts[0] += 2
    return CellGrid(domain_min=tuple(dmin), domain_width=tuple(width),
                    cell_count=tuple(counts), cell_width=cw,
                    support=grid.support, offsets=grid.offsets)


def _finite_or_inf(t: torch.Tensor) -> torch.Tensor:
    """NaN as +inf, so that a MAX over the ranks cannot lose it."""
    return torch.nan_to_num(t, nan=float("inf"))


def global_top_speed2(comm: Comm, state) -> float:
    """The largest squared speed of a valid row over every rank's rows of
    ``state`` (inf where any is NaN)."""
    return float(comm.max(_finite_or_inf(Simulation._top_speed2(state)))
                 .item())


class HaloStep:
    """The halo-exchange step of one rank (``make_halo_step`` of the JAX
    package): :meth:`step`, :meth:`run_chunk` and :meth:`run_chunk_guarded`
    over :class:`HaloState`; ``hcfg`` the caps as run (clamped), ``engine``
    the local engine (``"pallas_t"`` or ``"packed"``), ``rebuilds`` and
    ``last_chunk_rebuilds`` the frame rebuilds.  Sections of a step are
    marked with ``sim._mark`` (``sim.profile_events``)."""

    def __init__(self, sim, comm: Comm, hcfg: Optional[HaloConfig] = None):
        nx = comm.size
        self.sim, self.comm = sim, comm
        hcfg = hcfg or default_halo_config(sim, nx)
        g_axes = gh.spec_axes(sim._ghosts)
        # the window sweep when the backend is pallas_t and only x wraps
        # (x rides the ring's shifted ghost layer; y and z have no
        # decomposed axis here), else the packed engine
        self.use_pallas = (sim._backend == "pallas_t" and not g_axes[1]
                           and not g_axes[2])
        self.engine = "pallas_t" if self.use_pallas else "packed"
        self.frame_grid = (_extended_grid(sim.cell_grid) if self.use_pallas
                           else sim.cell_grid)
        self.hcfg = clamp_config(hcfg)
        cfg = sim.cfg
        self.cap = self.hcfg.capacity
        self.mig = self.hcfg.migration_cap
        self.hal = self.hcfg.halo_cap
        self.s_pad = sim.solid.s_pad if sim.has_structure else 0
        self.n_rows = self.cap + 2 * self.hal + self.s_pad
        self.struct_base = self.cap + 2 * self.hal
        if self.use_pallas and self.n_rows % sim._pcfg.block:
            raise ValueError(
                f"halo frame rows {self.n_rows} (capacity + 2 halo_cap + "
                f"structure rows) must be a multiple of the receiver block "
                f"{sim._pcfg.block}")
        # C8 frame reuse on the window sweep with a margin
        self.use_c8 = bool(self.use_pallas
                           and cfg.numerics.rebuild_margin > 0.0)
        margin_len = cfg.numerics.rebuild_margin * sim.spacing
        self.strip_support = (sim.kernels.support_radius
                              + (margin_len if self.use_c8 else 0.0))
        self.want_st = any(v != 0.0 for v in sim.kernels.cof_a)
        dev = sim.device
        if sim.has_structure:
            sv = _np(sim.solid.s_valid)
            si = np.where(sv, _np(sim.solid.s_idx), 0)
            s_prop = np.where(sv, _np(sim.state0.prop)[si], -1)
            self.s_prop = torch.as_tensor(s_prop.astype(np.int32)).to(dev)
            s_type = torch.clamp(self.s_prop, 0, 5).long()
            zero = torch.zeros((), dtype=sim.dtype, device=dev)
            self.s_mu = torch.where(sim.solid.s_valid,
                                    sim.tables.shear_viscosity[s_type], zero)
            self.s_mass = torch.where(
                sim.solid.s_valid, sim.tables.density[s_type] * sim.volume,
                torch.ones((), dtype=sim.dtype, device=dev))
        self.rebuilds = 0
        self.last_chunk_rebuilds = 0

    # ------------------------------------------------------------------
    def _dummy(self, dtype):
        dev = self.sim.device
        m = self.mig
        z3 = torch.zeros((m, 3), dtype=dtype, device=dev)
        return [torch.full((m,), -1, dtype=torch.int32, device=dev), z3, z3,
                z3, torch.full((m,), -1, dtype=torch.int32, device=dev)]

    def _migrate(self, prop, pos, vel, pos0, oid, valid, splits):
        """Send each migrant one hop towards its destination region, compact
        the region with the arrivals; overflow migrants stay (deferred).
        Returns the compacted rows and the overflow count."""
        comm, nx, rank = self.comm, self.comm.size, self.comm.rank
        dest = torch.clamp(
            torch.searchsorted(splits, pos[:, 0].contiguous(), right=True)
            - 1, 0, nx - 1)
        dist = torch.where(valid, (dest - rank) % nx, 0)
        go_right = (dist > 0) & (dist <= nx // 2)
        go_left = (dist > 0) & ~go_right
        sent = torch.zeros_like(valid)
        mover = torch.zeros((), dtype=torch.int32, device=valid.device)
        pay_l = pay_r = self._dummy(pos.dtype)
        # the compaction sorts run only where this rank has a migrant (a
        # local decision: the ring exchanges below run on every rank)
        if bool((go_left | go_right).any()):
            fields = (prop, pos, vel, pos0, oid)
            pay_l, lmask, lover, ltake = _extract(self.mig, go_left, *fields)
            pay_r, rmask, rover, rtake = _extract(self.mig, go_right, *fields)
            pay_l[0] = torch.where(lmask, pay_l[0], -1)
            pay_r[0] = torch.where(rmask, pay_r[0], -1)
            # only rows that rode the ring leave: overflow migrants stay
            sent_l = torch.zeros_like(valid)
            sent_l[ltake] = lmask
            sent_r = torch.zeros_like(valid)
            sent_r[rtake] = rmask
            sent = sent_l | sent_r
            mover = lover + rover
        recv_a = comm.ring(-1, *pay_l)  # the right neighbour's left-goers
        recv_b = comm.ring(+1, *pay_r)
        if not bool(sent.any() | (recv_a[0] >= 0).any()
                    | (recv_b[0] >= 0).any()):
            return prop, pos, pos0, vel, oid, mover
        keep = torch.where(valid & ~sent, prop, -1)
        all_ = [torch.cat([k, a, b]) for k, a, b in zip(
            (keep, pos, vel, pos0, oid), recv_a, recv_b)]
        (p2, x2, v2, x02, o2), cmask, cover, _ = _extract(
            self.cap, all_[0] >= 0, *all_)
        return (torch.where(cmask, p2, -1), x2, x02, v2,
                torch.where(cmask, o2, -1), mover + cover)

    def _strips(self, prop, pos, splits):
        """This rank's x strips, one ``strip_support`` deep inside each
        edge: ``(idx_l, idx_r, mask_l, mask_r, overflow)``."""
        rank, nx = self.comm.rank, self.comm.size
        valid = prop >= 0
        strip_l = valid & (pos[:, 0] < splits[rank] + self.strip_support)
        strip_r = valid & (pos[:, 0] >= splits[rank + 1] - self.strip_support)
        if not self.use_pallas and nx == 2:
            # packed-engine dedupe: at two ranks both directions reach the
            # one neighbour and the minimum image makes the two unshifted
            # copies identical; one copy covers both relations
            strip_r = strip_r & ~strip_l
        if not self.use_pallas and nx == 1:
            strip_l = torch.zeros_like(strip_l)
            strip_r = torch.zeros_like(strip_r)
        _, mask_l, over_l, idx_l = _extract(self.hal, strip_l)
        _, mask_r, over_r, idx_r = _extract(self.hal, strip_r)
        return idx_l, idx_r, mask_l, mask_r, over_l + over_r

    def _local_fields(self, frame, windows, views):
        sim = self.sim
        if self.use_pallas:
            return pwt.phase1_fields_t(frame, self.frame_grid, sim.kernels,
                                       sim.tables, cfg=sim._pcfg,
                                       windows=windows)
        parts = [pk.phase1_fields(frame, rv, sim.cell_grid, sim.kernels,
                                  sim.tables, cap=sim.cell_capacity)
                 for rv in views]
        return {k: torch.cat([p[k] for p in parts]) if parts[0][k].dim()
                else parts[0][k] for k in parts[0]}

    def _local_forces(self, frame, windows, views, fields):
        sim, cfg = self.sim, self.sim.cfg
        if self.use_pallas:
            return pwt.phase2_forces_t(
                frame, fields, self.frame_grid, sim.kernels, sim.tables,
                volume=sim.volume, two_dimensional=cfg.two_dimensional,
                cfg=sim._pcfg, windows=windows)
        out, at = [], 0
        for rv in views:
            n = rv.pos.shape[0]
            mine = {k: v[at:at + n] if v.dim() else v
                    for k, v in fields.items()}
            out.append(pk.phase2_forces(
                frame, rv, fields, mine, sim.cell_grid, sim.kernels,
                sim.tables, volume=sim.volume,
                two_dimensional=cfg.two_dimensional, cap=sim.cell_capacity))
            at += n
        return torch.cat(out)

    def _exchange(self, st: HaloState, cache: Optional[dict], probe: bool):
        """A step up to its frame: the pre-steps, the C8 predicate (and the
        guard's probe), on a rebuild the migration and the fresh strips, the
        strip exchange and the frame.  ``None`` where the probe finds the
        incoming state unhealthy."""
        sim, comm, cfg = self.sim, self.comm, self.sim.cfg
        rank, nx = comm.rank, comm.size
        dt = cfg.dt
        prop, pos, pos0, vel, oid = st.prop, st.pos, st.pos0, st.vel, st.oid
        s_pos, s_vel, wall_center, splits = (st.s_pos, st.s_vel,
                                             st.wall_center, st.splits)
        dev = pos.device
        zero = torch.zeros((), dtype=pos.dtype, device=dev)
        sim._mark("begin")

        # --- elementwise pre-steps ---------------------------------------
        if cfg.scene.velocity_profile == "turek_inlet":
            vel = wl.turek_inlet_velocity(pos, vel, prop, st.time, cfg.scene)
        if not sim._walls_static:
            pos, vel, wall_center = wl.apply_wall_motion(
                pos, vel, prop, wall_center, st.time,
                wall_velocity=sim.wall_velocity, wall_omega=sim.wall_omega,
                wall_rotation=sim.wall_rotation, dt=dt, scene=cfg.scene,
                freeze=cfg.compat.freeze_wall_motion)
        pos = wl.periodic_wrap(pos, sim._dmin_t, sim._width_t)
        if sim.has_structure:
            s_pos = wl.periodic_wrap(s_pos, sim._dmin_t, sim._width_t)
        valid = prop >= 0

        # --- C8 predicate and the guard's probe: one MAX over the ranks --
        scalars = []
        if cache is not None:
            d2 = torch.sum((pos - cache["ref_own"]) ** 2, dim=1)
            disp2 = torch.where(valid, d2, zero).max()
            if sim.has_structure:
                ds2 = torch.sum((s_pos - cache["ref_s"]) ** 2, dim=1)
                disp2 = torch.maximum(disp2, torch.where(
                    sim.solid.s_valid, ds2, zero).max())
            scalars.append(disp2)
        if probe:
            scalars.append(Simulation._top_speed2(st))
        vals = (comm.max(_finite_or_inf(torch.stack(scalars))).tolist()
                if scalars else [])
        if probe and not sim._healthy(vals[-1]):
            return None
        rebuild = cache is None or vals[0] > sim._rebuild_thresh2
        sim._mark("read")

        # --- migration, compaction and fresh strips on a rebuild ----------
        over = torch.zeros((), dtype=torch.int32, device=dev)
        if rebuild:
            if nx > 1:
                prop, pos, pos0, vel, oid, over = self._migrate(
                    prop, pos, vel, pos0, oid, valid, splits)
            idx_l, idx_r, mask_l, mask_r, sover = self._strips(
                prop, pos, splits)
            over = over + sover
        else:
            idx_l, idx_r = cache["idx_l"], cache["idx_r"]
            mask_l, mask_r = cache["mask_l"], cache["mask_r"]

        # --- x strip exchange (every step: ghosts move while reused) ------
        minus = torch.full((), -1, dtype=torch.int32, device=dev)
        ghosts_r = comm.ring(-1, torch.where(mask_l, prop[idx_l], minus),
                             pos[idx_l], vel[idx_l])
        ghosts_l = comm.ring(+1, torch.where(mask_r, prop[idx_r], minus),
                             pos[idx_r], vel[idx_r])
        gl_pos, gr_pos = ghosts_l[1], ghosts_r[1]
        if self.use_pallas:
            # strips that crossed the global ring boundary go into the
            # frame grid's x ghost layer (one rank: x ghost duplication)
            wx = sim.domain_width[0]
            if rank == 0:
                gl_pos = torch.cat([gl_pos[:, :1] - wx, gl_pos[:, 1:]], 1)
            if rank == nx - 1:
                gr_pos = torch.cat([gr_pos[:, :1] + wx, gr_pos[:, 1:]], 1)
        parts = [(prop, pos, vel), (ghosts_l[0], gl_pos, ghosts_l[2]),
                 (ghosts_r[0], gr_pos, ghosts_r[2])]
        if sim.has_structure:
            parts.append((self.s_prop, s_pos, s_vel))
        fprop, fpos, fvel = (torch.cat(c) for c in zip(*parts))
        sim._mark("strips and migration")

        # --- frame: fresh sort + windows, or the cached permutation -------
        if rebuild:
            if self.use_pallas:
                frame = pk.sort_frame(fpos, fvel, fprop, self.frame_grid)
                windows = pw.compute_windows(frame, self.frame_grid,
                                             sim._pcfg)
            else:
                frame = pk.sort_frame(fpos, fvel, fprop, sim.cell_grid,
                                      with_cell_start=True)
                windows = None
            inv = _inverse_permutation(frame.orig)
            ref_own, ref_s = pos, s_pos
        else:
            orig = cache["orig"]
            frame = pk.SortedFrame(key=cache["key"], pos=fpos[orig],
                                   vel=fvel[orig], prop=cache["prop_s"],
                                   orig=orig)
            windows, inv = cache["windows"], cache["inv"]
            ref_own, ref_s = cache["ref_own"], cache["ref_s"]
        views = (None if self.use_pallas
                 else pk.frame_views(frame, sim.cell_grid, sim.cell_capacity))
        sim._mark("frame")

        return types.SimpleNamespace(
            prop=prop, pos=pos, pos0=pos0, vel=vel, oid=oid, s_pos=s_pos,
            s_vel=s_vel, wall_center=wall_center, over=over, rebuild=rebuild,
            idx_l=idx_l, idx_r=idx_r, mask_l=mask_l, mask_r=mask_r,
            frame=frame, windows=windows, inv=inv, views=views,
            ref_own=ref_own, ref_s=ref_s)

    def frame(self, state: HaloState):
        """The halo frame a rebuilding step builds from ``state`` (after the
        pre-steps, the migration and the strip exchange; every rank calls
        it together): ``(frame, windows)``, the windows None on the packed
        engine."""
        with torch.no_grad():
            x = self._exchange(state, None, False)
        return x.frame, x.windows

    def _step(self, st: HaloState, cache: Optional[dict], probe: bool):
        """One step.  ``cache`` is the C8 frame cache (None: rebuild);
        ``probe`` reads the incoming state's top speed over every rank with
        the step's one read, and where it is not healthy the step is not
        taken (``None`` returned).  Returns ``(state, overflow, cache,
        rebuilt)`` with this rank's overflow."""
        x = self._exchange(st, cache, probe)
        if x is None:
            return None
        sim, comm, cfg = self.sim, self.comm, self.sim.cfg
        rank, dt, splits = comm.rank, cfg.dt, st.splits
        prop, pos, vel, s_pos, s_vel = x.prop, x.pos, x.vel, x.s_pos, x.s_vel
        frame, windows, views, inv = x.frame, x.windows, x.views, x.inv
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)

        # --- phase 1 everywhere; authoritative fields from the owners -----
        f1 = dict(self._local_fields(frame, windows, views))
        sim._mark("phase1")
        names = (("pressure_p", "pressure_a", "gravity_center")
                 if self.want_st else ("pressure_p",))
        sent_l = [f1[k][inv[x.idx_l]] for k in names]
        sent_r = [f1[k][inv[x.idx_r]] for k in names]
        got_l = comm.ring(+1, *sent_r)
        got_r = comm.ring(-1, *sent_l)
        ghost_slots = inv[self.cap:self.cap + 2 * self.hal]
        for k, a, b in zip(names, got_l, got_r):
            f1[k] = f1[k].index_put((ghost_slots,), torch.cat([a, b]))
        if sim.has_structure:
            # structure fields: the owner rank's values, shared by a sum
            s_own = (sim.solid.s_valid & (s_pos[:, 0] >= splits[rank])
                     & (s_pos[:, 0] < splits[rank + 1]))
            ss = inv[self.struct_base:self.struct_base + self.s_pad]
            packed = torch.cat([f1["pressure_p"][ss][:, None],
                                f1["pressure_a"][ss][:, None],
                                f1["gravity_center"][ss]], 1)
            packed = comm.sum(torch.where(s_own[:, None], packed, zero))
            f1["pressure_p"] = f1["pressure_p"].index_put((ss,), packed[:, 0])
            f1["pressure_a"] = f1["pressure_a"].index_put((ss,), packed[:, 1])
            f1["gravity_center"] = f1["gravity_center"].index_put(
                (ss,), packed[:, 2:5])
            f1["mu"] = f1["mu"].index_put((ss,), self.s_mu)
        sim._mark("ghost fields")

        force_s = self._local_forces(frame, windows, views, f1)
        sim._mark("phase2")

        # --- fluid/wall integration on own rows ---------------------------
        force = force_s[inv[:self.cap]]
        seg = Segments(prop)
        mass = sim.tables.density[torch.clamp(prop, 0, 5).long()] * sim.volume
        fs = seg.fluid | seg.structure
        force = force + torch.where(fs[:, None], mass[:, None] * sim._grav_t,
                                    zero)
        accel = force / torch.where(mass > 0, mass,
                                    torch.ones_like(mass))[:, None]
        vel = torch.where(fs[:, None], vel + accel * dt, vel)
        pos = torch.where(seg.fluid[:, None], pos + vel * dt, pos)
        sim._mark("integrate")

        # --- structure: replicated integration + elastic substeps ---------
        if sim.has_structure:
            s_valid = sim.solid.s_valid[:, None]
            s_force = comm.sum(torch.where(
                s_own[:, None], force_s[ss], zero))
            s_force = s_force + torch.where(
                s_valid, self.s_mass[:, None] * sim._grav_t, zero)
            s_vel = torch.where(
                s_valid, s_vel + s_force / self.s_mass[:, None] * dt, s_vel)
            for _ in range(cfg.substeps):
                s_pos, s_vel, _, _ = sl.substep_subset(
                    s_pos, s_vel, sim.solid, sim._width_t, cfg.elastic_dt,
                    double_position_update=(
                        cfg.compat.double_substep_position_update))
            sim._mark("solid")

        new = HaloState(prop=prop, pos=pos, pos0=x.pos0, vel=vel, oid=x.oid,
                        s_pos=s_pos, s_vel=s_vel, wall_center=x.wall_center,
                        splits=splits, time=st.time + dt)
        new_cache = None
        if self.use_c8:
            new_cache = (dict(orig=frame.orig, key=frame.key,
                              prop_s=frame.prop, inv=inv, windows=windows,
                              idx_l=x.idx_l, idx_r=x.idx_r, mask_l=x.mask_l,
                              mask_r=x.mask_r, ref_own=x.ref_own,
                              ref_s=x.ref_s)
                         if x.rebuild else cache)
        return new, x.over, new_cache, x.rebuild

    # ------------------------------------------------------------------
    def step(self, state: HaloState):
        """One step with a fresh frame; ``(state, overflow)``, the overflow
        the largest over the ranks."""
        with torch.no_grad():
            new, over, _, _ = self._step(state, None, False)
            self.rebuilds += 1
            return new, int(self.comm.max(over.reshape(1)).item())

    def run_chunk(self, state: HaloState, n_steps: int):
        """``n_steps`` steps, the C8 cache carried across them (it starts
        empty, so the first step rebuilds); ``(state, overflow)`` with the
        overflow the largest over the steps and the ranks."""
        state, over, _, _ = self._run(state, n_steps, guarded=False)
        return state, over

    def run_chunk_guarded(self, state: HaloState, n_steps: int):
        """Divergence-guarded chunk: stop at the FIRST state whose largest
        valid-particle speed (over every rank) is not finite or past the
        watchdog bound.  Returns ``(state, overflow, steps_done, healthy)``;
        on divergence the state is that first bad state and ``steps_done``
        counts the bad step."""
        return self._run(state, n_steps, guarded=True)

    def _run(self, state, n_steps, guarded):
        cache, done, healthy, rebuilds = None, 0, True, 0
        over = torch.zeros((), dtype=torch.int32, device=self.sim.device)
        with torch.no_grad():
            while done < n_steps:
                out = self._step(state, cache, guarded and done > 0)
                if out is None:
                    healthy = False
                    break
                state, o, cache, rebuilt = out
                over = torch.maximum(over, o)
                rebuilds += int(rebuilt)
                done += 1
            reads = [over.to(state.pos.dtype)]
            if guarded and healthy:
                reads.append(Simulation._top_speed2(state))
            vals = self.comm.max(_finite_or_inf(torch.stack(reads))).tolist()
            if guarded and healthy:
                healthy = self.sim._healthy(vals[1])
        self.last_chunk_rebuilds = rebuilds
        self.rebuilds += rebuilds
        return state, int(vals[0]), done, healthy


def make_halo_step(sim, comm: Comm,
                   hcfg: Optional[HaloConfig] = None) -> HaloStep:
    """The halo-exchange step of this rank for a configured Simulation
    (:class:`HaloStep`); ``hcfg`` defaults to :func:`default_halo_config`
    at equal-width planes."""
    return HaloStep(sim, comm, hcfg)
