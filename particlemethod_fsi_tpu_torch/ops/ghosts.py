"""Periodic ghost rows: scenes whose pairs span the periodic boundary on the
window sweeps.

Counterpart of ``particlemethod_fsi_tpu/ops/ghosts.py``.  Ported:
:class:`GhostSpec`, :func:`wrapped_axes`, :func:`build_ghost_spec`,
:func:`spec_axes`, :func:`spec_is_stale`, :func:`_compact` and
:func:`extend_with_ghosts`.  Added here: :func:`valid_extremes` and
:func:`wrapped_axes_device` (the wrap test on device positions, read back as
six numbers), :func:`strip_counts` (each image strip's occupancy on the
device) and :func:`stale_from_counts` (the test of :func:`spec_is_stale` on
those counts), so that a chunk boundary where nothing is stale reads a few
numbers, not the positions.

The window sweeps clip windows at the domain edge instead of wrapping them,
so a pair across a periodic boundary would be missed.  The reference takes
the minimum image inside every pair kernel (src/main.cpp:98, 1743-1810);
here the frame is extended instead:

* the cell grid grows one ghost cell layer beyond each wrapped boundary;
* every particle within the frame's reach of a wrapped boundary is copied,
  shifted by +/- the domain width, into the ghost layer (corner particles
  get the diagonal images too);
* ghost rows are senders only: their outputs are dropped at the unsort, so
  every pair kernel runs unchanged on the extended frame.

Extraction is fixed-capacity: a cumsum + ``searchsorted`` compaction takes
the first ``cap`` strip members of each image; what overflows is counted and
surfaced, never silent.  Capacities are sized on the host from the strips'
occupancy when the spec is built.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from particlemethod_fsi_tpu_torch.ops.neighbors import CellGrid

# each image's capacity: its strip's occupancy at build time times this
OCCUPANCY_MARGIN = 2.0
# a plan is stale once a strip's occupancy times this exceeds its capacity
HEADROOM = 1.25


class GhostSpec(NamedTuple):
    """Ghost-duplication plan, built on the host."""

    grid: CellGrid  # extended grid (ghost layer on wrapped axes)
    shifts: tuple[tuple[int, int, int], ...]  # nonzero image shifts
    caps: tuple[int, ...]  # fixed extraction capacity per shift
    support: float

    @property
    def total_capacity(self) -> int:
        return sum(self.caps)


def wrap_test(grid: CellGrid, pos_min, pos_max, support: float,
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
    """Axes where interacting pairs span the periodic boundary (numpy
    positions and validity)."""
    pos = np.asarray(positions)[np.asarray(valid)]
    if pos.size == 0:
        return (False, False, False)
    return wrap_test(grid, pos.min(axis=0), pos.max(axis=0), support,
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
    return wrap_test(grid, pos_min, pos_max, support, two_dimensional)


def _limits(base_grid: CellGrid, support: float, dtype=np.float64):
    """Per axis, as Python floats: the strips' bounds, the domain's low end
    plus the support and its high end minus it, and the domain's width,
    each rounded as arithmetic in ``dtype`` rounds it (the JAX package
    computes them from arrays of the positions' type).  Numbers, not device
    tensors: a tensor made from host values is a copy that waits for the
    device's queue."""
    t = np.dtype(dtype).type
    lo = [t(v) for v in base_grid.domain_min]
    width = [t(v) for v in base_grid.domain_width]
    sup = t(support)
    below = [float(a + sup) for a in lo]
    above = [float((a + w) - sup) for a, w in zip(lo, width)]
    return below, above, [float(w) for w in width]


def _np_type(pos: torch.Tensor):
    return np.float32 if pos.dtype == torch.float32 else np.float64


def _strip_mask(shift, pos, valid, below, above):
    """Members of one image's source strip: an image beyond the top takes
    its sources near the bottom (``pos < below``), and the other way round
    (``pos >= above``); numpy arrays and tensors alike."""
    m = valid
    for d in range(3):
        if shift[d] > 0:
            m = m & (pos[:, d] < below[d])
        elif shift[d] < 0:
            m = m & (pos[:, d] >= above[d])
    return m


def build_ghost_spec(grid: CellGrid, axes: tuple[bool, bool, bool],
                     positions, valid, support: float) -> GhostSpec:
    """Extended grid + per-image capacities sized from the current strips
    (numpy positions and validity)."""
    dmin = list(grid.domain_min)
    width = list(grid.domain_width)
    counts = list(grid.cell_count)
    cw = list(grid.cell_width)
    for d in range(3):
        if axes[d]:
            dmin[d] -= cw[d]
            width[d] += 2.0 * cw[d]
            counts[d] += 2
    egrid = CellGrid(
        domain_min=tuple(dmin), domain_width=tuple(width),
        cell_count=tuple(counts), cell_width=tuple(cw),
        support=grid.support, offsets=grid.offsets,
    )

    pos = np.asarray(positions)[np.asarray(valid)]
    below, above, _ = _limits(grid, support)
    shift_axes = [(-1, 0, 1) if axes[d] else (0,) for d in range(3)]
    shifts, caps = [], []
    every = np.ones(pos.shape[0], dtype=bool)
    for s in itertools.product(*shift_axes):
        if s == (0, 0, 0):
            continue
        m = _strip_mask(s, pos, every, below, above)
        cap = int(math.ceil(max(int(m.sum()), 16)
                            * OCCUPANCY_MARGIN / 128.0)) * 128
        shifts.append(tuple(s))
        caps.append(cap)
    # keep the extended frame length a multiple of 256 (the state pads to
    # 256, and the window tables tile the frame in receiver blocks)
    total = sum(caps)
    if total % 256:
        caps[-1] += 256 - total % 256
    return GhostSpec(grid=egrid, shifts=tuple(shifts), caps=tuple(caps),
                     support=support)


def spec_axes(spec: Optional[GhostSpec]) -> tuple[bool, bool, bool]:
    """Wrapped axes a spec covers (axes with any nonzero image shift)."""
    axes = [False, False, False]
    if spec is not None:
        for s in spec.shifts:
            for d in range(3):
                axes[d] |= s[d] != 0
    return tuple(axes)


def stale_from_counts(spec: Optional[GhostSpec], axes_now, counts) -> bool:
    """The test of :func:`spec_is_stale` on each image strip's occupancy
    ``counts`` (in the order of ``spec.shifts``)."""
    if any(a and not c for a, c in zip(axes_now, spec_axes(spec))):
        return True
    if spec is None:
        return False
    return any(n * HEADROOM > cap for n, cap in zip(counts, spec.caps))


def spec_is_stale(spec: Optional[GhostSpec], base_grid: CellGrid, positions,
                  valid, support: float,
                  axes_now: tuple[bool, bool, bool]) -> bool:
    """Host-side check that a ghost plan still covers the CURRENT particle
    distribution (numpy positions and validity).

    Stale when (a) an axis wraps now but is not covered, or (b) any image
    strip's current occupancy is within :data:`HEADROOM` of its fixed
    capacity."""
    counts = ()
    if spec is not None:
        pos = np.asarray(positions)[np.asarray(valid)]
        below, above, _ = _limits(base_grid, support)
        every = np.ones(pos.shape[0], dtype=bool)
        counts = [int(_strip_mask(s, pos, every, below, above).sum())
                  for s in spec.shifts]
    return stale_from_counts(spec, axes_now, counts)


def strip_counts(spec: GhostSpec, base_grid: CellGrid, pos: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Each image strip's occupancy on the device, ``[len(spec.shifts)]``
    int64 (the counts :func:`spec_is_stale` takes on the host)."""
    below, above, _ = _limits(base_grid, spec.support, _np_type(pos))
    return torch.stack([_strip_mask(s, pos, valid, below, above).sum()
                        for s in spec.shifts])


def _compact(mask: torch.Tensor, cap: int):
    """Indices of the first ``cap`` True rows + validity mask + overflow.

    cumsum + searchsorted compaction: O(N) elementwise + an O(cap log N)
    query, no sort and no scatter."""
    c = torch.cumsum(mask.to(torch.int32), dim=0, dtype=torch.int32)
    total = c[-1]
    ranks = torch.arange(1, cap + 1, dtype=torch.int32, device=mask.device)
    idx = torch.searchsorted(c, ranks)
    got = ranks <= total
    overflow = torch.clamp_min(total - cap, 0)
    return torch.clamp(idx, 0, mask.shape[0] - 1), got, overflow


def extend_with_ghosts(spec: GhostSpec, base_grid: CellGrid, pos, vel, prop):
    """Append shifted ghost images of boundary-strip particles.

    Returns ``(pos_e, vel_e, prop_e, src, overflow)``: tensors of
    ``pos``'s rows plus ``spec.total_capacity``; ghost rows carry the source
    particle's prop (senders need it for the type tables) and a shifted
    position; unfilled slots are prop = -1 at position 0 (the padding
    rows' poison, keyed to the sort sentinel).  ``src``
    ``[total_capacity]`` int64 is each ghost row's source slot (0 for
    unfilled slots: they lie in no ring).  Phase-2 sender fields must be
    copied from the sources through ``src``, because a ghost's own phase-1
    sums are incomplete (its neighbourhood is clipped at the edge of the
    extended domain).  ``overflow`` is an int32 scalar."""
    below, above, width = _limits(base_grid, spec.support, _np_type(pos))
    valid = prop >= 0
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    parts_pos, parts_vel, parts_prop, parts_src = [pos], [vel], [prop], []
    overflow = torch.zeros((), dtype=torch.int32, device=pos.device)
    for s, cap in zip(spec.shifts, spec.caps):
        m = _strip_mask(s, pos, valid, below, above)
        idx, got, over = _compact(m, cap)
        overflow = overflow + over
        idx = idx.long()
        image = pos[idx]
        for d in range(3):
            if s[d]:
                image[:, d] += s[d] * width[d]
        parts_pos.append(torch.where(got[:, None], image, zero))
        parts_vel.append(torch.where(got[:, None], vel[idx], zero))
        parts_prop.append(torch.where(got, prop[idx],
                                      torch.full_like(prop[idx], -1)))
        parts_src.append(torch.where(got, idx, torch.zeros_like(idx)))
    return (torch.cat(parts_pos), torch.cat(parts_vel), torch.cat(parts_prop),
            torch.cat(parts_src), overflow)
