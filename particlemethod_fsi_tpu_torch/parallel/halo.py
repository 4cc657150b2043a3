"""Multi-device domain decomposition with particle migration and ghost-strip
exchange over rings of ranks: the halo mode, over 1-D slabs or 2-axis
rectangles.

Counterpart of ``particlemethod_fsi_tpu/parallel/halo.py``:
:class:`HaloConfig`, :class:`HaloState`, :func:`mesh_shape`,
:func:`uniform_splits`, :func:`compute_splits`, :func:`compute_splits_y`,
:func:`normalize_splits_y`, :func:`default_halo_config`,
:func:`partition_state`, :func:`rebalance`, :func:`regrow_config` (with
:func:`regrow_sizes`), :func:`quantize_config`, :func:`adapt_config` (with
:func:`adapt_sizes`), :func:`gather_state`, :func:`to_slot_state` and
:func:`make_halo_step` (here a :class:`HaloStep` object with ``step``,
``run_chunk`` and ``run_chunk_guarded``, and the local engine's name in
``engine`` where the JAX function keeps it in an attribute of itself).

The mesh is the ranks' :attr:`Comm.shape` ``(nx, ny)``: ``(ranks, 1)``
gives x slabs, a grid from ``sharding.make_mesh_grid`` gives x * y
rectangles with per-column y planes (``splits_y`` ``[nx, ny+1]``).

Each rank is a process with one device and holds its own region: the
fluid and wall rows whose x lies in ``[splits[ix], splits[ix + 1])`` (and
on a 2-axis mesh whose y lies in ``[splits_y[ix, iy], splits_y[ix, iy +
1])``), in a buffer of ``capacity`` rows (``prop = -1`` where empty), with
each row's original slot id ``oid`` (int32 end to end), plus the structure
particles replicated on every rank.  A step, as in the JAX step:

* the C8 predicate: the largest displacement since the last rebuild over
  every rank (a MAX all-reduce, read once a step, so every rank takes the
  same branch);
* on a rebuild, migrants go one hop along the x ring to their destination
  column (routed by destination, so a particle that wrapped from xmax to x0
  takes one hop), overflow migrants stay and are counted, and the region is
  compacted; on a 2-axis mesh the rows then go one hop along the y ring to
  their row under the column's own y planes, and the region is compacted
  again (both stages' overflow counted); the x strips (one support plus the
  C8 margin deep) are selected afresh; along an axis of one rank nothing
  migrates;
* every step, each x strip's rows ride the x ring to the neighbour as ghost
  rows; on the window sweep they are shifted by the domain width where they
  crossed the global boundary, into the one-cell ghost layer on each x side
  of the frame grid (:func:`_extended_grid`); the packed engine takes the
  minimum image instead (and dedupes the strips at two ranks, drops them at
  one);
* on a 2-axis mesh the y strips are selected (on a rebuild) from the own
  rows and the x ghost rows, after the x shift, and ride the y ring the same
  way: so a corner neighbour's rows arrive in two hops, forwarded as x
  ghosts.  On the window sweep the frame grid has a ghost layer on each y
  side too and the y strips that crossed the global y boundary are shifted
  by the domain height: a y-periodic scene keeps the window sweep there,
  where on x slabs it takes the packed engine.  The frame is own rows, x
  ghosts, y ghosts, structure;
* phase 1 on the frame of own rows, ghost rows and structure rows (the
  window sweep, ``pallas_t``: kernel 1, with the frame, windows and strips
  reused while the predicate holds; or the packed engine), then the ghost
  rows' fields from their owners (pressure P always; pressure A and the
  gravity centre only with surface tension; mu never; on a 2-axis mesh the
  x ghosts first, then the y ghosts from the patched fields, so that
  forwarded corners carry their owners' values), the structure rows'
  fields as owner-masked sums (the owner's rectangle half-open), phase 2
  (kernel 2 or the packed engine), the kick and drift of own rows, and the
  replicated elastic substeps.

Every rank issues the same collectives in the same order.  Where the JAX
step runs a ``ppermute`` unconditionally, the port skips it only on a
branch every rank takes together (the rebuild, after the all-reduce); the
device-local skips of the JAX step (no migrant on this shard) are local
work only.  Along an axis of one rank a ring exchange is a local copy.

Where the port's host code differs from the JAX module (``ADVICE.md``'s
notes on it):

* :func:`adapt_config` clamps the fresh caps (the y cap too) to the
  capacity, as :func:`make_halo_step` does, before comparing them with the
  running ones (the JAX function compares unclamped caps, so a
  geometry-sized halo cap above the capacity reads as growth at every
  output);
* its shrink metric counts the migration buffers (``2 * migration_cap``)
  beside the frame rows (own, both x strips and both y strips), so a
  config inflated only there shrinks too;
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
    halo_cap_y: int = 0  # max y-halo particles per direction (2-axis mesh)


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
    splits: torch.Tensor  # [nx+1] region boundaries along x (replicated)
    splits_y: torch.Tensor  # [nx, ny+1] per-column y boundaries (replicated)
    time: torch.Tensor


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def mesh_shape(comm: Comm) -> tuple[int, int]:
    """(nx, ny) of the decomposition: the ranks' mesh (``(ranks, 1)``: 1-D
    slabs)."""
    return comm.shape


def _shape(ndev) -> tuple[int, int]:
    """An int (1-axis mesh) or an ``(nx, ny)`` shape, as ``(nx, ny)``."""
    if np.isscalar(ndev):
        return int(ndev), 1
    return int(ndev[0]), int(ndev[1])


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


def compute_splits_y(sim, nx: int, ny: int, positions, valid,
                     splits_x=None) -> np.ndarray:
    """``[nx, ny+1]`` y split planes, one row per x column.  At ``ny == 2``
    each column's planes are the equal-count quantiles of the particles in
    that column (exact balance on L-shaped densities, where the tensor
    product of global quantiles is far out of balance); the one-hop
    two-stage exchange still reaches every corner pair there, since an x
    ghost's y row differs from the receiver's by at most one.  At ``ny >
    2`` (or without ``splits_x``) the global quantiles are tiled, and a
    column too thin to condition on (fewer than ``2 * ny`` particles) takes
    them too."""
    lo = sim.domain_min[1]
    hi = lo + sim.domain_width[1]
    support = _ghost_reach(sim)
    if ny == 1:
        return np.tile(np.asarray([lo, hi]), (nx, 1))
    if (hi - lo) < ny * support:
        raise ValueError(
            f"domain axis-1 width {hi - lo:g} cannot host {ny} regions "
            f"of minimum width {support:g}")
    pos = _np(positions)[_np(valid)]
    gq = compute_splits(sim, ny, positions, valid, axis=1)
    if ny != 2 or splits_x is None:
        return np.tile(gq, (nx, 1))
    sx = np.asarray(splits_x)
    out = np.empty((nx, ny + 1), dtype=np.float64)
    for ix in range(nx):
        in_x = (pos[:, 0] >= sx[ix]) & (pos[:, 0] < sx[ix + 1])
        ys = pos[in_x, 1]
        if ys.size < 2 * ny:
            out[ix] = gq  # too thin to condition on: the global planes
            continue
        q = np.quantile(ys, np.linspace(0.0, 1.0, ny + 1))
        out[ix] = _clip_min_width(q, lo, hi, ny, support)
    return out


def normalize_splits_y(splits_y, nx: int, ny: int) -> np.ndarray:
    """``[ny+1]`` global planes (tiled) or ``[nx, ny+1]`` per-column planes
    as an ``[nx, ny+1]`` array."""
    sy = np.asarray(_np(splits_y), dtype=np.float64)
    if sy.ndim == 1:
        sy = np.tile(sy, (nx, 1))
    if sy.shape != (nx, ny + 1):
        raise ValueError(f"splits_y shape {sy.shape} != ({nx}, {ny + 1})")
    return sy


def _dest_regions(pos, splits_x, splits_y, nx, ny):
    """Host-side destination region (``ix * ny + iy``) per particle."""
    ix = np.clip(np.searchsorted(splits_x, pos[:, 0], side="right") - 1,
                 0, nx - 1)
    if ny == 1:
        return ix
    sy = normalize_splits_y(splits_y, nx, ny)
    iy = np.zeros_like(ix)
    for col in range(nx):
        m = ix == col
        iy[m] = np.clip(
            np.searchsorted(sy[col], pos[m, 1], side="right") - 1, 0, ny - 1)
    return ix * ny + iy


def default_halo_config(sim, ndev, *, occupancy_margin: float = 1.2,
                        splits: Optional[np.ndarray] = None,
                        splits_y: Optional[np.ndarray] = None, state=None,
                        npad_floor: bool = True) -> HaloConfig:
    """Size the per-rank buffers from the case geometry: a halo strip is
    one support radius (plus the C8 margin and a row of slack) deep by the
    region's cross-section, counted in lattice sites.  ``ndev`` is an int
    (1-axis mesh) or an ``(nx, ny)`` shape.  With ``splits`` /
    ``splits_y`` (and always on a 2-axis mesh) the capacity is also sized
    from the initial occupancy of the regions under those planes, and on a
    2-axis mesh both strips' caps from their initial occupancy too;
    ``npad_floor=False`` (which needs planes) drops the ``n_pad``-based
    floor and sizes from the peak alone.  Every cap is a multiple of 128
    rows."""
    nx, ny = _shape(ndev)
    ntot = nx * ny
    have_splits = splits is not None or splits_y is not None or ny > 1
    if not have_splits:
        npad_floor = True  # no occupancy measurement to size from
    cap = int(np.ceil(sim.n_pad * occupancy_margin / ntot / 128.0)) * 128 \
        if npad_floor else 0
    s = sim.state0 if state is None else state
    prop = _np(s.prop)
    pos = _np(s.pos)
    valid = (prop >= 0) & ~((prop >= 2) & (prop < 4))
    sx = uniform_splits(sim, nx, 0) if splits is None else _np(splits)
    sy = normalize_splits_y(
        uniform_splits(sim, ny, 1) if splits_y is None else splits_y, nx, ny)
    if have_splits:
        dest = _dest_regions(pos[valid], sx, sy, nx, ny)
        peak = int(np.bincount(dest, minlength=ntot).max())
        cap = max(cap, int(np.ceil(peak * occupancy_margin / 128.0)) * 128)
    l0 = sim.spacing
    depth_rows = (sim.kernels.support_radius / l0
                  + sim.cfg.numerics.rebuild_margin)
    z_sites = 1.0 if sim.cfg.two_dimensional else sim.domain_width[2] / l0
    # x strips span the region's y cross-section: the domain's height on x
    # slabs, a row's height and the forwarded ghost depth on a 2-axis mesh
    cross_sites = sim.domain_width[1] / l0
    if ny > 1:
        cross_sites = cross_sites / ny + 2.0 * (depth_rows + 1.0)
    strip_particles = cross_sites * (depth_rows + 1.0) * z_sites
    halo = int(np.ceil(strip_particles * occupancy_margin / 128.0)) * 128
    halo_y = 0
    if ny > 1:
        # y strips span the region's x width and both x ghost layers
        cross_x = sim.domain_width[0] / l0 / nx + 2.0 * (depth_rows + 1.0)
        strip_y = cross_x * (depth_rows + 1.0) * z_sites
        halo_y = int(np.ceil(strip_y * occupancy_margin / 128.0)) * 128
        # the strips' initial peaks under the given planes
        reach = _ghost_reach(sim) + l0
        px, py = pos[valid, 0], pos[valid, 1]
        peaks_x, peaks_y = 0, 0
        for ix in range(nx):
            in_x = (px >= sx[ix]) & (px < sx[ix + 1])
            sy_c = sy[ix]
            near_x = (px >= sx[ix] - reach) & (px < sx[ix + 1] + reach)
            for iy in range(ny):
                in_y = (py >= sy_c[iy]) & (py < sy_c[iy + 1])
                own = in_x & in_y
                peaks_x = max(peaks_x,
                              int(np.sum(own & (px < sx[ix] + reach))),
                              int(np.sum(own & (px >= sx[ix + 1] - reach))))
                peaks_y = max(peaks_y,
                              int(np.sum(near_x & in_y
                                         & (py < sy_c[iy] + reach))),
                              int(np.sum(near_x & in_y
                                         & (py >= sy_c[iy + 1] - reach))))
        halo = max(halo, int(np.ceil(
            peaks_x * occupancy_margin / 128.0)) * 128)
        halo_y = max(halo_y, int(np.ceil(
            peaks_y * occupancy_margin / 128.0)) * 128)
    return HaloConfig(capacity=cap, migration_cap=max(256, (halo + halo_y)
                                                      // 4),
                      halo_cap=halo, halo_cap_y=halo_y)


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
                    splits_y: Optional[np.ndarray] = None,
                    state=None) -> HaloState:
    """Host-side partition: the fluid and wall particles into the regions
    of ``splits`` / ``splits_y`` (equal width by default; ``splits_y``
    ``[ny+1]`` or ``[nx, ny+1]``), this rank's region as its state; the
    structure particles into the replicated subset arrays.  ``state``
    defaults to ``sim.state0`` (a gathered dict from :func:`gather_state`
    re-partitions mid-run).  Every rank computes the same partition from the
    same input and keeps its own block."""
    nx, ny = mesh_shape(comm)
    splits = uniform_splits(sim, nx, 0) if splits is None else _np(splits)
    splits_y = normalize_splits_y(
        uniform_splits(sim, ny, 1) if splits_y is None else splits_y, nx, ny)
    # a region narrower than the ghost reach (support + the C8 margin)
    # would need two-hop ghosts the ring never delivers
    reach = _ghost_reach(sim)
    for name, s, n in [("x", splits, nx)] + [
            (f"y[col {c}]", splits_y[c], ny) for c in range(nx)]:
        if n == 1:
            continue
        widths = np.diff(np.asarray(s, dtype=np.float64))
        if widths.min() < reach - 1e-12:
            raise ValueError(
                f"{name} region width {widths.min():g} < ghost reach "
                f"{reach:g} (support + rebuild margin); use fewer devices "
                "or equal-count splits")
    prop, pos, vel, pos0, oid, time, wall_center = _slot_arrays(sim, state)
    is_struct = (prop >= 2) & (prop < 4)
    valid = (prop >= 0) & ~is_struct
    out = _fill_regions(prop, pos, vel, pos0, oid, valid, splits, splits_y,
                        nx, ny, hcfg.capacity)
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
        splits=dev(splits), splits_y=dev(splits_y),
        time=dev(np.asarray(time)))


def _fill_regions(prop, pos, vel, pos0, oid, valid, splits, splits_y, nx,
                  ny, c):
    dest = _dest_regions(pos, splits, splits_y, nx, ny)
    ndev = nx * ny
    out_prop = np.full((ndev * c,), -1, dtype=np.int32)
    out_pos = np.zeros((ndev * c, 3), dtype=pos.dtype)
    out_vel = np.zeros((ndev * c, 3), dtype=vel.dtype)
    out_pos0 = np.zeros((ndev * c, 3), dtype=pos0.dtype)
    out_oid = np.full((ndev * c,), -1, dtype=np.int32)
    for r in range(ndev):
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
              splits: Optional[np.ndarray] = None,
              splits_y: Optional[np.ndarray] = None) -> HaloState:
    """Load rebalancing at output cadence: equal-count split planes from the
    current distribution (or the ``splits`` / ``splits_y`` given, e.g. by
    :func:`adapt_config`) and a re-partition of the fluid and wall rows
    (the structure subset and the wall state carry over)."""
    nx, ny = mesh_shape(comm)
    g = gathered_rows(comm, state)
    valid = g["prop"] >= 0
    if splits is None:
        splits = compute_splits(sim, nx, g["pos"], valid)
    if splits_y is None:
        splits_y = compute_splits_y(sim, nx, ny, g["pos"], valid,
                                    splits_x=splits)
    return partition_state(sim, comm, hcfg, splits=splits,
                           splits_y=splits_y, state=g)


def _region_rows(comm: Comm, state: HaloState):
    """Every rank's ``(prop, pos)`` region rows on the host."""
    prop, pos = comm.all_gather(state.prop, state.pos)
    return _np(prop), _np(pos)


def _fresh_config(sim, shape, prop, pos, **kw):
    """Equal-count planes of the rows' distribution and the halo config
    sized from them (:func:`default_halo_config`)."""
    nx, ny = _shape(shape)
    valid = prop >= 0
    splits = compute_splits(sim, nx, pos, valid)
    splits_y = compute_splits_y(sim, nx, ny, pos, valid, splits_x=splits)
    fresh = default_halo_config(
        sim, (nx, ny), splits=splits, splits_y=splits_y,
        state=types.SimpleNamespace(prop=prop, pos=pos), **kw)
    return fresh, splits, splits_y


def regrow_config(sim, comm: Comm, hcfg: HaloConfig, state: HaloState
                  ) -> tuple[HaloConfig, np.ndarray, np.ndarray]:
    """Grown buffer sizes after a saturation event (:func:`regrow_sizes`
    of every rank's rows)."""
    return regrow_sizes(sim, mesh_shape(comm), hcfg,
                        *_region_rows(comm, state))


def regrow_sizes(sim, ndev, hcfg: HaloConfig, prop, pos
                 ) -> tuple[HaloConfig, np.ndarray, np.ndarray]:
    """Double the migration and halo caps (both axes') and refresh the
    capacity from the occupancy of the region rows ``prop``, ``pos`` (host
    arrays) under fresh equal-count planes (the overflow count does not say
    which buffer saturated, so all grow).  ``ndev`` is an int or an ``(nx,
    ny)`` shape.  Returns ``(hcfg, splits, splits_y)`` for a new
    :func:`make_halo_step` and :func:`partition_state`."""
    fresh, splits, splits_y = _fresh_config(sim, ndev, prop, pos)
    grown = HaloConfig(
        capacity=max(fresh.capacity, hcfg.capacity),
        migration_cap=max(fresh.migration_cap, 2 * hcfg.migration_cap),
        halo_cap=max(fresh.halo_cap, 2 * hcfg.halo_cap),
        halo_cap_y=max(fresh.halo_cap_y, 2 * hcfg.halo_cap_y))
    return grown, splits, splits_y


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
    c = hcfg.capacity
    return hcfg._replace(migration_cap=min(hcfg.migration_cap, c),
                         halo_cap=min(hcfg.halo_cap, c),
                         halo_cap_y=min(hcfg.halo_cap_y, c))


def swept_rows(c: HaloConfig) -> int:
    """The shrink metric of :func:`adapt_config`: the frame rows a step
    sweeps (own + both x strips + both y strips) and the migration buffers
    a rebuild moves and compacts."""
    return (c.capacity + 2 * c.halo_cap + 2 * c.halo_cap_y
            + 2 * c.migration_cap)


def adapt_config(sim, comm: Comm, hcfg: HaloConfig, state: HaloState,
                 **kw) -> tuple[HaloConfig, np.ndarray, np.ndarray, bool]:
    """Occupancy-adaptive buffer sizing at output cadence
    (:func:`adapt_sizes` of every rank's rows)."""
    return adapt_sizes(sim, mesh_shape(comm), hcfg,
                       *_region_rows(comm, state), **kw)


def adapt_sizes(sim, ndev, hcfg: HaloConfig, prop, pos, *,
                occupancy_margin: float = 1.08, quantum: int = 1024,
                shrink_quanta: int = 2) -> tuple[HaloConfig, np.ndarray,
                                                 np.ndarray, bool]:
    """The caps track the occupancy of the region rows ``prop``, ``pos``
    (host arrays) under fresh equal-count planes: they grow when drift
    concentrated particles, and shrink once rebalancing spread them out
    again, only where that saves at least ``shrink_quanta`` quanta of
    :func:`swept_rows` (so a boundary-straddling occupancy cannot thrash).
    ``ndev`` is an int or an ``(nx, ny)`` shape.  Returns ``(new_hcfg,
    splits, splits_y, changed)``; ``changed`` means the caller must build a
    new step and re-partition, else a :func:`rebalance` under the planes
    suffices.  The fresh caps are clamped as the step clamps them before
    they are compared (see the module's notes)."""
    fresh, splits, splits_y = _fresh_config(
        sim, ndev, prop, pos, occupancy_margin=occupancy_margin,
        npad_floor=False)
    fresh = clamp_config(quantize_config(fresh, quantum))
    grow = any(f > c for f, c in zip(fresh, hcfg))
    if grow:
        new = HaloConfig(*(max(f, c) for f, c in zip(fresh, hcfg)))
    elif swept_rows(fresh) + shrink_quanta * quantum <= swept_rows(hcfg):
        new = fresh
    else:
        new = hcfg
    return new, splits, splits_y, new != hcfg


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


def _extended_grid(grid: CellGrid, extend_y: bool = False) -> CellGrid:
    """The cell grid grown by one ghost-cell layer on each x side (and on
    each y side on a 2-axis mesh): the halo frame's wrap layer.  The window
    sweep pairs by coordinate adjacency, so strips that crossed the global
    boundary are shifted into this layer."""
    dmin = list(grid.domain_min)
    width = list(grid.domain_width)
    counts = list(grid.cell_count)
    cw = grid.cell_width
    for d in (0, 1) if extend_y else (0,):
        dmin[d] -= cw[d]
        width[d] += 2.0 * cw[d]
        counts[d] += 2
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
    ``last_chunk_rebuilds`` the frame rebuilds.  Chunks, steps and their
    sections are spans of ``sim.spans`` (``utils/trace.py``): marks while
    ``sim.profile_events`` is a list, ranges under the profiler."""

    def __init__(self, sim, comm: Comm, hcfg: Optional[HaloConfig] = None):
        self.sim, self.comm = sim, comm
        self.nx, self.ny = mesh_shape(comm)
        self.ix, self.iy = comm.coords
        self.two_axis = self.ny > 1
        hcfg = hcfg or default_halo_config(sim, (self.nx, self.ny))
        g_axes = gh.spec_axes(sim._ghosts)
        # the window sweep when the backend is pallas_t and every wrapped
        # axis rides a ring's shifted ghost layer: x always, y on a 2-axis
        # mesh (every y-boundary pair crosses ranks there); z never
        self.use_pallas = (sim._backend == "pallas_t"
                           and (not g_axes[1] or self.two_axis)
                           and not g_axes[2])
        self.engine = "pallas_t" if self.use_pallas else "packed"
        self.frame_grid = (_extended_grid(sim.cell_grid, self.two_axis)
                           if self.use_pallas else sim.cell_grid)
        if self.two_axis and hcfg.halo_cap_y <= 0:
            raise ValueError("2-axis mesh needs HaloConfig.halo_cap_y > 0 "
                             "(default_halo_config sizes it from the "
                             "geometry)")
        self.hcfg = clamp_config(hcfg)
        if not self.two_axis:
            self.hcfg = self.hcfg._replace(halo_cap_y=0)
        cfg = sim.cfg
        self.cap = self.hcfg.capacity
        self.mig = self.hcfg.migration_cap
        self.hal = self.hcfg.halo_cap
        self.hal_y = self.hcfg.halo_cap_y
        self.s_pad = sim.solid.s_pad if sim.has_structure else 0
        # frame rows: own, x ghosts (the y strips' source), y ghosts,
        # structure
        self.base_rows = self.cap + 2 * self.hal
        self.struct_base = self.base_rows + 2 * self.hal_y
        self.n_rows = self.struct_base + self.s_pad
        if self.use_pallas and self.n_rows % sim._pcfg.block:
            raise ValueError(
                f"halo frame rows {self.n_rows} (capacity + 2 halo_cap + "
                f"2 halo_cap_y + structure rows) must be a multiple of the "
                f"receiver block {sim._pcfg.block}")
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

    def _migrate(self, axis, planes, prop, pos, vel, pos0, oid):
        """Send each migrant one hop along the ring of mesh axis ``axis``
        towards its destination under ``planes`` (the x planes, or this
        column's y planes), compact the region with the arrivals; overflow
        migrants stay (deferred).  Returns the compacted rows and the
        overflow count."""
        comm = self.comm
        n = (self.nx, self.ny)[axis]
        me = (self.ix, self.iy)[axis]
        valid = prop >= 0
        dest = torch.clamp(
            torch.searchsorted(planes, pos[:, axis].contiguous(), right=True)
            - 1, 0, n - 1)
        dist = torch.where(valid, (dest - me) % n, 0)
        go_up = (dist > 0) & (dist <= n // 2)
        go_down = (dist > 0) & ~go_up
        sent = torch.zeros_like(valid)
        mover = torch.zeros((), dtype=torch.int32, device=valid.device)
        pay_d = pay_u = self._dummy(pos.dtype)
        # the compaction sorts run only where this rank has a migrant (a
        # local decision: the ring exchanges below run on every rank)
        if bool((go_down | go_up).any()):
            fields = (prop, pos, vel, pos0, oid)
            pay_d, dmask, dover, dtake = _extract(self.mig, go_down, *fields)
            pay_u, umask, uover, utake = _extract(self.mig, go_up, *fields)
            pay_d[0] = torch.where(dmask, pay_d[0], -1)
            pay_u[0] = torch.where(umask, pay_u[0], -1)
            # only rows that rode the ring leave: overflow migrants stay
            sent_d = torch.zeros_like(valid)
            sent_d[dtake] = dmask
            sent_u = torch.zeros_like(valid)
            sent_u[utake] = umask
            sent = sent_d | sent_u
            mover = dover + uover
        # the next rank's down-goers, then the previous rank's up-goers
        recv_a = comm.ring(-1, *pay_d, axis=axis)
        recv_b = comm.ring(+1, *pay_u, axis=axis)
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

    def _strips(self, prop, pos, lo, hi, axis, cap, n):
        """The strips one ``strip_support`` deep inside the edges ``lo``
        and ``hi`` along ``axis``, of ``cap`` rows each (``n`` ranks along
        the axis): ``(idx_lo, idx_hi, mask_lo, mask_hi, overflow)``."""
        valid = prop >= 0
        strip_lo = valid & (pos[:, axis] < lo + self.strip_support)
        strip_hi = valid & (pos[:, axis] >= hi - self.strip_support)
        if not self.use_pallas and n == 2:
            # packed-engine dedupe: at two ranks both directions reach the
            # one neighbour and the minimum image makes the two unshifted
            # copies identical; one copy covers both relations
            strip_hi = strip_hi & ~strip_lo
        if not self.use_pallas and n == 1:
            strip_lo = torch.zeros_like(strip_lo)
            strip_hi = torch.zeros_like(strip_hi)
        _, mask_lo, over_lo, idx_lo = _extract(cap, strip_lo)
        _, mask_hi, over_hi, idx_hi = _extract(cap, strip_hi)
        return idx_lo, idx_hi, mask_lo, mask_hi, over_lo + over_hi

    def _ring_strips(self, prop, pos, vel, idx_lo, idx_hi, mask_lo, mask_hi,
                     axis):
        """Each strip's rows to the neighbour along ``axis`` (types -1
        beyond the mask): ``(ghosts from below, ghosts from above)`` as
        ``[prop, pos, vel]``, the window sweep's shifted by the domain's
        width where they crossed the global boundary."""
        comm = self.comm
        n, me = (self.nx, self.ny)[axis], (self.ix, self.iy)[axis]
        minus = torch.full((), -1, dtype=torch.int32, device=pos.device)
        above = comm.ring(-1, torch.where(mask_lo, prop[idx_lo], minus),
                          pos[idx_lo], vel[idx_lo], axis=axis)
        below = comm.ring(+1, torch.where(mask_hi, prop[idx_hi], minus),
                          pos[idx_hi], vel[idx_hi], axis=axis)
        if self.use_pallas:
            # into the frame grid's ghost layer (one rank along the axis:
            # ghost duplication, as on one device)
            w = self.sim.domain_width[axis]
            for g, edge, sign in ((below, 0, -1.0), (above, n - 1, 1.0)):
                if me == edge:
                    p = g[1].clone()
                    p[:, axis] += sign * w
                    g[1] = p
        return below, above

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
        strip exchanges and the frame.  ``None`` where the probe finds the
        incoming state unhealthy."""
        sim, comm, cfg = self.sim, self.comm, self.sim.cfg
        ix, iy = self.ix, self.iy
        dt = cfg.dt
        prop, pos, pos0, vel, oid = st.prop, st.pos, st.pos0, st.vel, st.oid
        s_pos, s_vel, wall_center, splits = (st.s_pos, st.s_vel,
                                             st.wall_center, st.splits)
        sy_col = st.splits_y[ix]  # this column's y planes
        dev = pos.device
        zero = torch.zeros((), dtype=pos.dtype, device=dev)
        sp = sim.spans
        sp.step()
        sp.begin("read")

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
        sp.mark("read")

        sp.begin("strips and migration")

        # --- migration (x, then y), compaction and fresh x strips ---------
        over = torch.zeros((), dtype=torch.int32, device=dev)
        if rebuild:
            for axis, planes in ((0, splits), (1, sy_col)):
                if (self.nx, self.ny)[axis] > 1:
                    prop, pos, pos0, vel, oid, o = self._migrate(
                        axis, planes, prop, pos, vel, pos0, oid)
                    over = over + o
            strips = self._strips(prop, pos, splits[ix], splits[ix + 1], 0,
                                  self.hal, self.nx)
            over = over + strips[4]
            idx_l, idx_r, mask_l, mask_r = strips[:4]
        else:
            idx_l, idx_r = cache["idx_l"], cache["idx_r"]
            mask_l, mask_r = cache["mask_l"], cache["mask_r"]

        # --- x strip exchange (every step: ghosts move while reused) ------
        ghosts_l, ghosts_r = self._ring_strips(prop, pos, vel, idx_l, idx_r,
                                               mask_l, mask_r, 0)
        parts = [(prop, pos, vel), ghosts_l, ghosts_r]
        y_strips = None
        if self.two_axis:
            # --- y strips from own + x-ghost rows (corners ride the
            # forwarded x ghosts, already x-shifted), then the y ring ------
            base_prop, base_pos, base_vel = (torch.cat(c)
                                             for c in zip(*parts))
            if rebuild:
                y_strips = self._strips(base_prop, base_pos, sy_col[iy],
                                        sy_col[iy + 1], 1, self.hal_y,
                                        self.ny)
                over = over + y_strips[4]
                y_strips = y_strips[:4]
            else:
                y_strips = (cache["idx_yl"], cache["idx_yr"],
                            cache["mask_yl"], cache["mask_yr"])
            ghosts_d, ghosts_u = self._ring_strips(base_prop, base_pos,
                                                   base_vel, *y_strips, 1)
            parts += [ghosts_d, ghosts_u]
        if sim.has_structure:
            parts.append((self.s_prop, s_pos, s_vel))
        fprop, fpos, fvel = (torch.cat(c) for c in zip(*parts))
        sp.mark("strips and migration")

        sp.begin("frame")
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
        sp.mark("frame", rebuilt=rebuild)

        return types.SimpleNamespace(
            prop=prop, pos=pos, pos0=pos0, vel=vel, oid=oid, s_pos=s_pos,
            s_vel=s_vel, wall_center=wall_center, over=over, rebuild=rebuild,
            idx_l=idx_l, idx_r=idx_r, mask_l=mask_l, mask_r=mask_r,
            y_strips=y_strips, frame=frame, windows=windows, inv=inv,
            views=views, ref_own=ref_own, ref_s=ref_s)

    def frame(self, state: HaloState):
        """The halo frame a rebuilding step builds from ``state`` (after the
        pre-steps, the migration and the strip exchanges; every rank calls
        it together): ``(frame, windows)``, the windows None on the packed
        engine."""
        with torch.no_grad():
            x = self._exchange(state, None, False)
        self.sim.spans.end()
        return x.frame, x.windows

    def _patch_ghosts(self, f1, names, inv, idx_lo, idx_hi, first, axis):
        """The ghost rows' fields ``names`` from their owners along
        ``axis``: the fields of this rank's strip rows go to the neighbour,
        whose ghost rows (from frame row ``first`` on, the ones from below
        first) take them."""
        comm = self.comm
        sent_lo = [f1[k][inv[idx_lo]] for k in names]
        sent_hi = [f1[k][inv[idx_hi]] for k in names]
        got_below = comm.ring(+1, *sent_hi, axis=axis)
        got_above = comm.ring(-1, *sent_lo, axis=axis)
        slots = inv[first:first + idx_lo.shape[0] + idx_hi.shape[0]]
        for k, a, b in zip(names, got_below, got_above):
            f1[k] = f1[k].index_put((slots,), torch.cat([a, b]))

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
        ix, iy, dt, splits = self.ix, self.iy, cfg.dt, st.splits
        prop, pos, vel, s_pos, s_vel = x.prop, x.pos, x.vel, x.s_pos, x.s_vel
        frame, windows, views, inv = x.frame, x.windows, x.views, x.inv
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
        sp = sim.spans

        # --- phase 1 everywhere; authoritative fields from the owners -----
        sp.begin("phase1")
        f1 = dict(self._local_fields(frame, windows, views))
        sp.mark("phase1")
        sp.begin("ghost fields")
        names = (("pressure_p", "pressure_a", "gravity_center")
                 if self.want_st else ("pressure_p",))
        # x ghosts first, so that the y strips forward their owners' fields
        # to the corners
        self._patch_ghosts(f1, names, inv, x.idx_l, x.idx_r, self.cap, 0)
        if self.two_axis:
            self._patch_ghosts(f1, names, inv, x.y_strips[0], x.y_strips[1],
                               self.base_rows, 1)
        if sim.has_structure:
            # structure fields: the owner rank's values, shared by a sum
            s_own = (sim.solid.s_valid & (s_pos[:, 0] >= splits[ix])
                     & (s_pos[:, 0] < splits[ix + 1]))
            if self.two_axis:
                sy_col = st.splits_y[ix]
                s_own = (s_own & (s_pos[:, 1] >= sy_col[iy])
                         & (s_pos[:, 1] < sy_col[iy + 1]))
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
        sp.mark("ghost fields")

        sp.begin("phase2")
        force_s = self._local_forces(frame, windows, views, f1)
        sp.mark("phase2")

        # --- fluid/wall integration on own rows ---------------------------
        sp.begin("integrate")
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
        sp.mark("integrate")

        # --- structure: replicated integration + elastic substeps ---------
        if sim.has_structure:
            sp.begin("solid")
            s_valid = sim.solid.s_valid[:, None]
            s_force = comm.sum(torch.where(
                s_own[:, None], force_s[ss], zero))
            s_force = s_force + torch.where(
                s_valid, self.s_mass[:, None] * sim._grav_t, zero)
            s_vel = torch.where(
                s_valid, s_vel + s_force / self.s_mass[:, None] * dt, s_vel)
            s_pos, s_vel = sl.substeps_subset(
                s_pos, s_vel, sim.solid, sim._width_t, cfg.elastic_dt,
                cfg.substeps, double_position_update=(
                    cfg.compat.double_substep_position_update), spans=sp)
            sp.mark("solid")

        new = HaloState(prop=prop, pos=pos, pos0=x.pos0, vel=vel, oid=x.oid,
                        s_pos=s_pos, s_vel=s_vel, wall_center=x.wall_center,
                        splits=splits, splits_y=st.splits_y,
                        time=st.time + dt)
        new_cache = None
        if self.use_c8:
            new_cache = cache
            if x.rebuild:
                new_cache = dict(orig=frame.orig, key=frame.key,
                                 prop_s=frame.prop, inv=inv, windows=windows,
                                 idx_l=x.idx_l, idx_r=x.idx_r,
                                 mask_l=x.mask_l, mask_r=x.mask_r,
                                 ref_own=x.ref_own, ref_s=x.ref_s)
                if self.two_axis:
                    new_cache.update(zip(("idx_yl", "idx_yr", "mask_yl",
                                          "mask_yr"), x.y_strips))
        return new, x.over, new_cache, x.rebuild

    # ------------------------------------------------------------------
    def step(self, state: HaloState):
        """One step with a fresh frame; ``(state, overflow)``, the overflow
        the largest over the ranks."""
        self.sim.spans.chunk()
        with torch.no_grad():
            new, over, _, _ = self._step(state, None, False)
            self.sim.spans.end()
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
        self.sim.spans.chunk()
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
        self.sim.spans.end()
        self.last_chunk_rebuilds = rebuilds
        self.rebuilds += rebuilds
        return state, int(vals[0]), done, healthy


def make_halo_step(sim, comm: Comm,
                   hcfg: Optional[HaloConfig] = None) -> HaloStep:
    """The halo-exchange step of this rank for a configured Simulation
    (:class:`HaloStep`); ``hcfg`` defaults to :func:`default_halo_config`
    at equal-width planes."""
    return HaloStep(sim, comm, hcfg)
