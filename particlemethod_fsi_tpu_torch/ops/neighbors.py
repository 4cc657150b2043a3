"""Uniform cell-grid geometry and the periodic minimum image.

Counterpart of ``particlemethod_fsi_tpu/ops/neighbors.py``.  Ported:
:class:`CellGrid`, :func:`build_cell_grid`, :func:`min_image`.  The padded
``[N, K]`` neighbor matrix (``build_neighbor_list``, the gather engine) is
not ported yet.

Cell width is the full candidate radius per axis, so only the 3x3(x3) cell
neighborhood needs scanning; per-axis cell width is stretched to divide the
domain exactly, which keeps the periodic wrap correct.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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
