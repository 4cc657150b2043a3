"""The cell-sorted particle frame.

Counterpart of ``particlemethod_fsi_tpu/ops/packed_engine.py``.  Ported:
:class:`SortedFrame`, :func:`_cell_key` (with its :func:`cell_coords`),
:func:`sort_frame` (the ``with_cell_start=False`` form the window sweeps
use) and :func:`unsort`.
The packed candidate engine itself (cell tables, ``phase1_fields``,
``phase2_forces``, ``packed_virial``) and ``pad_frame_planes`` are not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from particlemethod_fsi_tpu_torch.ops.neighbors import CellGrid


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
