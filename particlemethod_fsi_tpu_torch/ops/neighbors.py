"""Uniform cell-grid geometry and the periodic minimum image.

Counterpart of ``particlemethod_fsi_tpu/ops/neighbors.py``, all of it but
``build_neighbor_list``'s ``pair_filter`` (the port builds its structure
lists on the host, ``Simulation._initial_structure_neighbors``): the cell
grid, the minimum image, and the gather engine's padded ``[N, K]`` neighbor
matrix (:class:`NeighborList`, :func:`build_neighbor_list`).

Cell width is the full candidate radius per axis, so only the 3x3(x3) cell
neighborhood needs scanning; per-axis cell width is stretched to divide the
domain exactly, which keeps the periodic wrap correct.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class CellGrid:
    """Static cell-grid geometry (built once per case on the host)."""

    domain_min: tuple[float, float, float]
    domain_width: tuple[float, float, float]
    cell_count: tuple[int, int, int]
    cell_width: tuple[float, float, float]
    support: float  # candidate radius = MaxRadius + MARGIN (+ C8 margin)
    offsets: tuple[tuple[int, int, int], ...]  # distinct wrapped cell offsets

    @property
    def num_cells(self) -> int:
        nc = self.cell_count
        return nc[0] * nc[1] * nc[2]


def build_cell_grid(
    domain_min, domain_max, support: float, *, two_dimensional: bool
) -> CellGrid:
    """Choose per-axis cell counts so that cell width >= support and the cells
    tile the domain exactly (required for periodic wrap correctness)."""
    dmin = tuple(float(x) for x in domain_min)
    width = tuple(float(hi - lo) for lo, hi in zip(dmin, domain_max))
    counts = []
    for d in range(3):
        if two_dimensional and d == 2:
            counts.append(1)  # fake z layer (src/main.cpp:1420-1421)
        else:
            counts.append(max(1, int(math.floor(width[d] / support))))
    cw = tuple(width[d] / counts[d] for d in range(3))

    # per-axis distinct offsets: {-1,0,1} when >=3 cells, else each cell once
    def axis_offsets(nc: int):
        if nc >= 3:
            return (-1, 0, 1)
        if nc == 2:
            return (0, 1)
        return (0,)

    offs = tuple(
        (ox, oy, oz)
        for ox in axis_offsets(counts[0])
        for oy in axis_offsets(counts[1])
        for oz in axis_offsets(counts[2])
    )
    return CellGrid(
        domain_min=dmin,
        domain_width=width,
        cell_count=tuple(counts),
        cell_width=cw,
        support=float(support),
        offsets=offs,
    )


def min_image(dx: torch.Tensor, domain_width) -> torch.Tensor:
    """Periodic minimum-image convention, matching the reference's
    ``Mod(dx + W/2, W) - W/2`` with ``Mod(x,w) = x - w*floor(x/w)``
    (src/main.cpp:98, used in every pairwise op).  ``domain_width`` covers
    the trailing axis of ``dx`` (pass a slice for 2-component inputs)."""
    w = torch.as_tensor(domain_width, dtype=dx.dtype, device=dx.device)
    half = 0.5 * w
    y = dx + half
    return y - w * torch.floor(y / w) - half


class NeighborList(NamedTuple):
    """Padded neighbor matrix.  ``idx[i, k]`` indexes the padded particle
    arrays; entries with ``mask[i, k] == False`` are padding (idx 0)."""

    idx: torch.Tensor  # [N, K] int64
    mask: torch.Tensor  # [N, K] bool
    count: torch.Tensor  # [N] int32 -- full in-radius count incl. overflow
    cell_overflow: torch.Tensor  # scalar int32: max cell occupancy seen


def _cell_coords(pos: torch.Tensor, grid: CellGrid) -> torch.Tensor:
    """``[N, 3]`` int32 cell coordinates per particle (src/main.cpp:1671-1673),
    floored and clipped into the grid."""
    dmin = torch.as_tensor(grid.domain_min, dtype=pos.dtype, device=pos.device)
    cw = torch.as_tensor(grid.cell_width, dtype=pos.dtype, device=pos.device)
    nc = torch.as_tensor(grid.cell_count, dtype=torch.int32, device=pos.device)
    ci = torch.floor((pos - dmin) / cw).to(torch.int32)
    # positions are wrapped into the domain each step, but guard anyway
    return torch.minimum(torch.clamp_min(ci, 0), nc - 1)


def _linear_cell_id(coords: torch.Tensor, grid: CellGrid) -> torch.Tensor:
    nx, ny, _ = grid.cell_count
    return coords[..., 0] + nx * (coords[..., 1] + ny * coords[..., 2])


def build_neighbor_list(pos: torch.Tensor, valid: torch.Tensor,
                        grid: CellGrid, *, max_neighbors: int,
                        cell_capacity: int) -> NeighborList:
    """The padded neighbor matrix of all valid particles, equal to the JAX
    function's: particles sorted by cell (stably, so slot order within a
    cell), a dense ``[num_cells * cap]`` table of the first ``cap`` of each
    cell, candidates from the wrapped 3x3(x3) cell neighbourhood in
    ``grid.offsets`` order, kept where within ``grid.support`` (the minimum
    image), and compacted to the first ``max_neighbors`` in that scan order.
    Self-pairs are excluded (src/main.cpp:1769).

    Cell overflow (``cap`` exceeded) and neighbour overflow (``count > K``)
    drop entries, as in the reference (src/main.cpp:1766-1772); both are
    returned, never silent.  Where JAX drops an out-of-range table write and
    clamps an out-of-range gather, indices are masked or clamped here before
    they index."""
    n = pos.shape[0]
    dev = pos.device
    num_cells = grid.num_cells
    cap = cell_capacity

    coords = _cell_coords(pos, grid)  # [N, 3]
    cell = torch.where(valid, _linear_cell_id(coords, grid), num_cells)

    # sort particles by cell id (the bitonic sort's role, src/main.cpp:1686-1708)
    iota = torch.arange(n, device=dev)
    sorted_cell, sorted_idx = torch.sort(cell, stable=True)

    # per-cell segment offsets (CellParticleBegin/End, src/main.cpp:1715-1728)
    cell_start = torch.searchsorted(
        sorted_cell, torch.arange(num_cells + 1, dtype=sorted_cell.dtype,
                                  device=dev))
    occupancy = cell_start[1:] - cell_start[:-1]
    cell_overflow = occupancy.max().to(torch.int32)

    # dense [num_cells * cap] id table; rank-overflow writes are dropped
    rank = iota - cell_start[torch.clamp(sorted_cell, 0, num_cells - 1).long()]
    keep = (sorted_cell < num_cells) & (rank >= 0) & (rank < cap)
    table = torch.full((num_cells * cap,), n, dtype=torch.int64, device=dev)
    table[(sorted_cell.long() * cap + rank)[keep]] = sorted_idx[keep]

    # candidate gather over the wrapped cell neighborhood
    nc = torch.as_tensor(grid.cell_count, dtype=torch.int32, device=dev)
    r = torch.arange(cap, device=dev)
    cand = torch.cat([
        table[_linear_cell_id(
            torch.remainder(coords + torch.as_tensor(off, dtype=torch.int32,
                                                     device=dev), nc),
            grid).long()[:, None] * cap + r[None, :]]
        for off in grid.offsets], dim=1)  # [N, n_off * cap]

    # distance + validity tests (min-image, src/main.cpp:1758-1773)
    cand_safe = torch.clamp(cand, 0, n - 1)
    xij = min_image(pos[cand_safe] - pos[:, None, :], grid.domain_width)
    rij2 = torch.sum(xij * xij, dim=-1)
    ok = ((cand < n) & (cand != iota[:, None]) & valid[cand_safe]
          & valid[:, None] & (rij2 <= grid.support * grid.support))
    count = ok.sum(dim=1).to(torch.int32)

    # compact valid candidates to the first K columns: a stable sort of the
    # integer form of ~ok keeps the cell-scan order among them; overflow
    # beyond K is counted but dropped
    order = torch.sort((~ok).to(torch.uint8), dim=1,
                       stable=True).indices[:, :max_neighbors]
    nbr_ok = torch.gather(ok, 1, order)
    nbr_idx = torch.where(nbr_ok, torch.gather(cand_safe, 1, order), 0)
    return NeighborList(idx=nbr_idx, mask=nbr_ok, count=count,
                        cell_overflow=cell_overflow)
