"""Window tables over the cell-sorted frame.

Counterpart of ``particlemethod_fsi_tpu/ops/pallas_pairwise.py``, of which
only the layout-independent part is ported: :class:`WindowConfig` (there
``PallasConfig``), :func:`row_offsets` and :func:`compute_windows`.  That
module's three row-major TPU kernels are not ported yet.

For a block of B consecutive sorted receivers, all neighbors within one
cell-row offset lie in a contiguous range of the sorted frame ("window"):
cells are one candidate radius wide and x is the fastest sort key, so the
candidate set for row offset dy (and dz in 3-D) is the rows of cells
``c_lo + off - 1 .. c_hi + off + 1``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from particlemethod_fsi_tpu_torch.ops.neighbors import CellGrid
from particlemethod_fsi_tpu_torch.ops.packed_engine import SortedFrame


class WindowConfig(NamedTuple):
    """Specialization of the window sweep (``PallasConfig`` in the JAX
    package; same fields, so one carries across)."""

    block: int = 64  # receivers per window-table row = threads per CUDA block
    wmax: int = 128  # JAX package: rows per window chunk; unused by the CUDA kernels
    # physics specialization (results are identical: the skipped terms are
    # exactly zero / exactly 1.0 multiplies)
    surface_tension: bool = True  # any CofA != 0
    uniform_ratio: bool = False  # all InteractionRatio == 1
    # planar: all particle z equal, all z velocities zero, no z gravity/wall
    # motion (checked host-side in the solver): every z term is exactly zero
    planar: bool = False
    # all four support radii equal: the family masks and (1-q) powers
    # coincide and are computed once
    uniform_radii: bool = False
    subblocks: int = 1  # JAX package only
    merged: bool = False  # JAX package only


def row_offsets(grid: CellGrid):
    """Distinct cell-row offsets: {-1,0,1} on y (x is the fast axis) and, in
    3-D, on z.  Row offset o maps to a cell-id offset o_y*nx + o_z*nx*ny."""
    nx, ny, nz = grid.cell_count
    ys = (-1, 0, 1) if ny >= 3 else tuple(range(ny))
    zs = (-1, 0, 1) if nz >= 3 else tuple(range(nz))
    return tuple(oy * nx + oz * nx * ny for oz in zs for oy in ys), tuple(
        (oy, oz) for oz in zs for oy in ys
    )


def compute_windows(frame: SortedFrame, grid: CellGrid, cfg: WindowConfig):
    """Per-(block, offset) window ``(win_start, win_len)``, both
    ``[nblocks, n_off]`` int32.  Only the needed boundary cells are looked
    up (2 * nblocks * n_off left-sided ``searchsorted`` queries)."""
    n = frame.key.shape[0]
    b = cfg.block
    nblocks = n // b
    ncells = grid.num_cells
    key = torch.clamp(frame.key, 0, ncells - 1)
    c_lo = key[0::b][:nblocks]  # first receiver's cell per block
    c_hi = key[b - 1::b][:nblocks]
    offs, _ = row_offsets(grid)
    lo_cells = torch.stack(
        [torch.clamp(c_lo + off - 1, 0, ncells) for off in offs], dim=1)
    hi_cells = torch.stack(
        [torch.clamp(c_hi + off + 2, 0, ncells) for off in offs], dim=1)
    starts = torch.searchsorted(frame.key, lo_cells.contiguous())
    ends = torch.searchsorted(frame.key, hi_cells.contiguous())
    win_start = torch.clamp(starts, 0, n).to(torch.int32)
    win_len = torch.clamp_min(ends - starts, 0).to(torch.int32)
    return win_start, win_len
