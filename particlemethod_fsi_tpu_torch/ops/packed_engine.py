"""The cell-sorted particle frame.

Counterpart of ``particlemethod_fsi_tpu/ops/packed_engine.py``.  Ported:
:class:`SortedFrame`, :func:`_cell_key` (with its :func:`cell_coords`),
:func:`sort_frame` (the ``with_cell_start=False`` form the window sweeps
use), :func:`unsort` and :func:`pad_frame_planes` (the 3-D frame's plane
alignment).  The packed candidate engine itself (cell tables,
``phase1_fields``, ``phase2_forces``, ``packed_virial``) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from particlemethod_fsi_tpu_torch.ops.neighbors import CellGrid

# rows a cell plane of a 3-D frame is aligned to; every receiver block size
# divides it
PLANE_ALIGN = 256

class SortedFrame(NamedTuple):
    """Per-step sorted particle frame.  The JAX frame's ``cell_start`` and
    ``coords`` serve the packed engine only and are not carried."""

    key: torch.Tensor  # [N] int32 cell id (sentinel = num_cells on padding)
    pos: torch.Tensor  # [N,3] sorted
    vel: torch.Tensor  # [N,3]
    prop: torch.Tensor  # [N] int32
    orig: torch.Tensor  # [N] int64 original slot index


def cell_coords(pos: torch.Tensor, grid: CellGrid) -> torch.Tensor:
    """``[N, 3]`` int32 cell coordinate per particle: a true divide by the
    cell width, floored and clipped into the grid, exactly as the JAX
    package computes it (the row-major sweeps' ring test uses the same
    divide, so a particle on a cell boundary lands in one cell for both)."""
    dmin = torch.as_tensor(grid.domain_min, dtype=pos.dtype, device=pos.device)
    cw = torch.as_tensor(grid.cell_width, dtype=pos.dtype, device=pos.device)
    nc = torch.as_tensor(grid.cell_count, dtype=torch.int32, device=pos.device)
    ci = torch.floor((pos - dmin) / cw).to(torch.int32)
    return torch.minimum(torch.clamp_min(ci, 0), nc - 1)


def _cell_key(pos: torch.Tensor, grid: CellGrid, valid: torch.Tensor):
    """int32 cell id per particle (x fastest), ``num_cells`` where invalid."""
    ci = cell_coords(pos, grid)
    nx, ny, _ = grid.cell_count
    key = ci[:, 0] + nx * (ci[:, 1] + ny * ci[:, 2])
    return torch.where(valid, key, grid.num_cells)


def sort_frame(pos, vel, prop, grid: CellGrid) -> SortedFrame:
    """Sort particles by cell id.  A stable sort of the key alone reproduces
    the JAX package's total order on ``(key, slot)``, so the frame agrees
    with it row by row; the payload follows with one gather each."""
    key = _cell_key(pos, grid, prop >= 0)
    skey, sorig = torch.sort(key, stable=True)
    return SortedFrame(key=skey, pos=pos[sorig], vel=vel[sorig],
                       prop=prop[sorig], orig=sorig)


def unsort(frame: SortedFrame, *arrays, n: Optional[int] = None):
    """Return sorted-order tensors to original slot order, keeping the
    first ``n`` slots (all by default).  ``frame.orig`` is a permutation of
    the frame's rows, so the inverse is one scatter, ``out[orig] = x``; on a
    ghost-extended frame the ghost rows (``orig >= n_pad``) land past the
    slots and ``n = n_pad`` drops them, as the JAX solver's
    ``force[: self.n_pad]`` does."""
    out = []
    for a in arrays:
        if a.shape[0] != frame.orig.shape[0]:
            raise ValueError("unsort: array length differs from the frame's")
        o = torch.empty_like(a)
        o[frame.orig] = a
        out.append(o if n is None else o[:n])
    return out


def pad_frame_planes(frame: SortedFrame, grid: CellGrid) -> SortedFrame:
    """Re-pack a 3-D sorted frame so that every cell plane (z slab) starts
    at a row that is a multiple of :data:`PLANE_ALIGN`, by pad rows at each plane's
    end; the frame's own sentinel rows (invalid slots, key ``num_cells``)
    form a tail region, padded the same way.  No receiver block (block
    sizes divide :data:`PLANE_ALIGN`) then spans a plane end, which would make its
    windows span a whole plane.

    Output length ``n + (nz + 1) * PLANE_ALIGN``.  Pad rows carry the last cell of
    their own plane as key (the tail region's: the sentinel), so keys stay
    sorted and windows plane-local; type -1; position 1e9 (a plane pad's key
    is a real cell, so it can enter a ring, and the radius test must reject
    it) and velocity 0.  Key, type, position and velocity equal the JAX
    package's row for row.  ``orig`` differs on the pads only: there
    ``n + row``, which its key-sort unsort takes; here the unused indices
    ``[n, n_out)`` in row order, so that ``orig`` stays a permutation of the
    output's rows with every real slot first and :func:`unsort` (a scatter)
    keeps working."""
    nx, ny, _ = grid.cell_count
    plane_cells = nx * ny
    n_planes = grid.num_cells // plane_cells
    key_in = frame.key
    dev = key_in.device
    n = key_in.shape[0]
    n_out = n + (n_planes + 1) * PLANE_ALIGN
    bounds = torch.arange(n_planes + 1, device=dev,
                          dtype=torch.int32) * plane_cells
    starts = torch.cat([torch.searchsorted(key_in, bounds),
                        torch.full((1,), n, device=dev, dtype=torch.int64)])
    counts = starts[1:] - starts[:-1]  # [nz + 1]: each plane, then the tail
    padded = (counts + (PLANE_ALIGN - 1)) // PLANE_ALIGN * PLANE_ALIGN
    ps = torch.cat([torch.zeros(1, device=dev, dtype=torch.int64),
                    torch.cumsum(padded, 0)])
    j = torch.arange(n_out, device=dev)
    q = torch.clamp(torch.searchsorted(ps, j, right=True) - 1, 0, n_planes)
    off = j - ps[q]
    src = torch.clamp(starts[q] + off, 0, n - 1)
    valid = off < counts[q]
    pad_key = torch.where(q < n_planes, (q + 1) * plane_cells - 1,
                          grid.num_cells).to(key_in.dtype)
    key = torch.where(valid, key_in[src], pad_key)
    prop = torch.where(valid, frame.prop[src],
                       torch.full_like(frame.prop[src], -1))
    pad_rank = torch.cumsum((~valid).to(torch.int64), 0) - 1
    orig = torch.where(valid, frame.orig[src], n + pad_rank)
    pos = torch.where(valid[:, None], frame.pos[src],
                      torch.full_like(frame.pos[src], 1.0e9))
    vel = torch.where(valid[:, None], frame.vel[src],
                      torch.zeros_like(frame.vel[src]))
    return SortedFrame(key=key, pos=pos, vel=vel, prop=prop, orig=orig)
