"""Window tables over the cell-sorted frame, and the row-major window sweeps
with their hand-written CUDA kernels.

Counterpart of ``particlemethod_fsi_tpu/ops/pallas_pairwise.py``:

===============================  ========================================
here                             there
===============================  ========================================
:class:`WindowConfig`            ``PallasConfig`` (same fields)
:func:`row_offsets`              ``row_offsets``
:func:`compute_windows`          ``compute_windows``
:func:`check_no_wrap_pairs`      ``check_no_wrap_pairs``
``phase1_rows_sweep`` (+ kernel) ``_phase1_kernel`` via ``_pallas_sweep``
:func:`phase1_fields`            ``phase1_fields_pallas`` (with EOS tail)
``phase2_rows_sweep`` (+ kernel) ``_phase2_kernel``
:func:`phase2_forces`            ``phase2_forces_pallas``
``virial_rows_sweep`` (+ kernel) ``_virial_kernel``
:func:`virial`                   ``virial_pallas``
===============================  ========================================

For a block of B consecutive sorted receivers, all neighbors within one
cell-row offset lie in a contiguous range of the sorted frame ("window"):
cells are one candidate radius wide and x is the fastest sort key, so the
candidate set for row offset dy (and dz in 3-D) is the rows of cells
``c_lo + off - 1 .. c_hi + off + 1``.

The row-major sweeps (``backend="pallas"``; the JAX package also routes
frames of 2^24 cells or more there) take the same inputs as the field-major
ones of :mod:`windows_t` and differ in what the kernels test, which is the
point of porting them separately:

* **the ring from positions**: a pair is in the ring of row offset
  ``(oy, oz)`` when the sender's cell coordinate, recomputed from its
  position by the true divide of :func:`packed_engine.cell_coords`, lies
  within one cell of the receiver's in x and exactly ``oy`` (and in 3-D
  ``oz``) away in y (z) -- not the sort key;
* **validity**: ``prop_j >= 0`` (pad rows carry the sentinel key but may sit
  inside the fluid), ``j != i``, ``rij2 > 0`` and ``rij2 <= support^2``
  (every kernel walks only each receiver's ring run, which it finds from
  the sorted key: on a frame sorted from its own positions a valid row's
  key is its linear cell; the tail's pads, key ``num_cells``, lie in no
  run, and a 3-D frame's plane pads, keyed with their plane's last cell,
  are rejected by the ring test on their position);
* **the neighbour count is always produced**, and ``mu_h = 2 mu_i mu_j /
  (mu_i + mu_j)`` (0 where the sum is not positive) comes from ``mu``
  itself, not from an inverse-viscosity field.

What the TPU layout forced and this port drops: the ``[N + wmax, 128]``
packed rows, the poisoned tail, the SMEM tables in 128-block chunks, the
``wmax`` chunking with its double-buffered DMA and the sub-block grid.

This module also holds what both sweep families share: the launch counts,
the consistency checks and C-argument helpers of the wrappers, and the plain
PyTorch sweep bodies (dense masked ``[blocks, B, W]`` pair blocks, a slab of
receiver blocks at a time), which :mod:`windows_t` calls with the key ring
and this module with the position ring.  Each sweep has a wrapper that
launches its CUDA kernel for a CUDA tensor -- or raises -- and takes the
plain version only for a CPU tensor, and a count in :data:`launch_counts`
incremented where the kernel is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from particlemethod_fsi_tpu_torch.config import TYPE_COUNT
from particlemethod_fsi_tpu_torch.ops import cuda_loader
from particlemethod_fsi_tpu_torch.ops.fluid import TypeTables, is_structure
from particlemethod_fsi_tpu_torch.ops.neighbors import CellGrid
from particlemethod_fsi_tpu_torch.ops.packed_engine import SortedFrame, cell_coords
from particlemethod_fsi_tpu_torch.ops.smoothing import KernelSet


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


def check_no_wrap_pairs(grid: CellGrid, positions, valid, support: float) -> bool:
    """Host-side set-up check for the no-wrap precondition of the window
    sweeps (windows are clipped at the domain edge, not wrapped): on every
    periodic axis with >= 3 cells, the gap between the extreme particles
    across the boundary must exceed the support radius."""
    pos = np.asarray(positions)[np.asarray(valid)]
    if pos.size == 0:
        return True
    for d in range(3):
        if grid.cell_count[d] < 3:
            continue
        lo = float(pos[:, d].min()) - grid.domain_min[d]
        hi = grid.domain_min[d] + grid.domain_width[d] - float(pos[:, d].max())
        if lo + hi < support:
            return False
    return True


# ---------------------------------------------------------------------------
# launch counts and the wrappers' shared checks
# ---------------------------------------------------------------------------

# kernel launches per wrapper, both sweep families (plain ints; the plain
# versions never count)
launch_counts = {"phase1_sweep": 0, "phase2_sweep": 0, "virial_sweep": 0,
                 "phase1_rows": 0, "phase2_rows": 0, "virial_rows": 0}

# rows of the phase-1 sweeps' output
P1_DA, P1_GX, P1_GY, P1_GZ, P1_WP, P1_DIV, P1_COUNT = range(7)

# pair slots the plain versions hold at once ([blocks, B, W] per temporary)
_PLAIN_PAIR_BUDGET = 1 << 22


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check_frame(frame: SortedFrame, win_start, win_len, n_off: int,
                 block: int):
    pos = frame.pos
    n = pos.shape[0]
    if pos.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"window sweep: unsupported dtype {pos.dtype}")
    if block <= 0 or block > 1024 or n % block != 0:
        raise ValueError(
            f"window sweep: frame rows {n} must be a multiple of block "
            f"{block} <= 1024")
    for name, t, shape, dtype in (
        ("pos", pos, (n, 3), pos.dtype), ("vel", frame.vel, (n, 3), pos.dtype),
        ("key", frame.key, (n,), torch.int32),
        ("prop", frame.prop, (n,), torch.int32),
        ("win_start", win_start, (n // block, n_off), torch.int32),
        ("win_len", win_len, (n // block, n_off), torch.int32),
    ):
        _check_tensor(name, t, shape, dtype, pos.device)


def _check_tensor(name, t, shape, dtype, device):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"window sweep: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}")


def _check_phase2_fields(frame: SortedFrame, pp, pa, gc, visc,
                         cfg: WindowConfig, visc_name: str):
    n = frame.pos.shape[0]
    dtype, dev = frame.pos.dtype, frame.pos.device
    _check_tensor("pressure_p", pp, (n,), dtype, dev)
    _check_tensor(visc_name, visc, (n,), dtype, dev)
    if cfg.surface_tension:
        _check_tensor("pressure_a", pa, (n,), dtype, dev)
        _check_tensor("gravity_center", gc, (n, 3), dtype, dev)


def _c_doubles(values):
    return (ctypes.c_double * len(values))(*[float(v) for v in values])


def _c_ints(values):
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(
            f"{what}: launch refused (cudaGetLastError = {err}; -1 means the "
            f"arguments are outside what the kernel takes)")


def _phase1_consts(ks: KernelSet, support: float):
    norm_p = 1.0 / ks.swp / ks.radius_p**ks.dim_power
    return [
        ks.radius_a**2, ks.radius_g**2, ks.radius_p**2,
        1.0 / ks.radius_a, 1.0 / ks.radius_g, 1.0 / ks.radius_p,
        1.0 / ks.swa / ks.radius_a**ks.dim_power,
        1.0 / ks.swg / ks.radius_g**ks.dim_power,
        ks.r2g, ks.radius_g,
        norm_p, 2.0 * norm_p / ks.radius_p,  # -sum(udote*dwp)
        support * support,
    ]


def _phase2_consts(ks: KernelSet, volume: float, two_dimensional: bool):
    norm_p = 1.0 / ks.swp / ks.radius_p**ks.dim_power
    norm_v = 1.0 / ks.swv / ks.radius_v**ks.dim_power
    norm_g = 1.0 / ks.swg / ks.radius_g**ks.dim_power
    return [
        ks.radius_p**2, ks.radius_a**2, ks.radius_v**2, ks.radius_g**2,
        1.0 / ks.radius_p, 1.0 / ks.radius_a, 1.0 / ks.radius_v,
        1.0 / ks.radius_g,
        norm_p * (-2.0 / ks.radius_p),
        1.0 / ks.swa / ks.radius_a**ks.dim_power, ks.radius_a,
        norm_v * (-2.0 / ks.radius_v),
        norm_g, norm_g * (-2.0 / ks.radius_g),
        8.0 if two_dimensional else 10.0,
        volume,
        1.0 / ks.r2g * ks.radius_g * (volume / ks.spacing),
        ks.cof_k * ks.cof_k,
    ]


# ---------------------------------------------------------------------------
# ring runs (what the phase-1 and phase-2 kernels walk; for tests and
# chip_smoke.py)
# ---------------------------------------------------------------------------


def clip_runs(key, vlo, vhi, win_start, win_len, block: int):
    """Rows ``[lo, hi)`` whose key lies in ``[vlo, vhi]`` (``[N, n_off]``
    each, one row per receiver), clipped to the receiver's block window:
    two lower bounds on the sorted key, as the window kernels take them.
    Returns ``(lo, hi)`` int64 ``[N, n_off]``."""
    n = key.shape[0]
    key64 = key.long()
    blk = torch.arange(n, device=key.device) // block
    ws = win_start.long()[blk]
    we = ws + win_len.long()[blk]
    lo = torch.searchsorted(key64, vlo.contiguous())
    hi = torch.searchsorted(key64, (vhi + 1).contiguous())
    lo = torch.minimum(torch.maximum(lo, ws), we)
    hi = torch.minimum(torch.maximum(hi, lo), we)
    return lo, hi


def ring_runs_rows(frame: SortedFrame, win_start, win_len, grid: CellGrid,
                   block: int):
    """Each receiver's ring run per row offset under the row-major rule, as
    kernels 4-6 (``fsi_phase1_rows``, ``fsi_phase2_rows``,
    ``fsi_virial_rows``) find it: the
    ring of :func:`position_rule` is one range of linear cells (the
    receiver's cell row ``(cy + oy, cz + oz)``, x from ``cx - 1`` to
    ``cx + 1`` clipped to the grid; empty where that row lies outside it),
    and on a frame sorted from these positions the valid senders in it are
    the rows whose key lies in that range (the tail's pads, key
    ``num_cells``, lie in none; a plane pad of a 3-D frame may, and the
    ring test on its position rejects it).  Returns
    ``(lo, hi)`` int64 ``[N, n_off]``, clipped to the block's window.  Used
    by the tests and ``chip_smoke.py``; nothing on the main path calls it."""
    cells = cell_coords(frame.pos, grid).long()
    nx, ny, nz = grid.cell_count
    _, offs_yz = row_offsets(grid)
    dev = frame.pos.device
    oy = torch.tensor([yz[0] for yz in offs_yz], device=dev)
    oz = torch.tensor([yz[1] for yz in offs_yz], device=dev)
    cz = cells[:, 2] if nz > 1 else torch.zeros_like(cells[:, 2])
    ty = cells[:, 1, None] + oy
    tz = cz[:, None] + oz
    x0 = torch.clamp_min(cells[:, 0] - 1, 0)[:, None]
    x1 = torch.clamp_max(cells[:, 0] + 1, nx - 1)[:, None]
    row = nx * (ty + ny * tz)
    empty = (ty < 0) | (ty >= ny) | (tz < 0) | (tz >= nz)
    nothing = torch.full_like(row, -(2**31) + 1)  # the kernel's empty ring
    return clip_runs(frame.key, torch.where(empty, nothing, x0 + row),
                     torch.where(empty, nothing, x1 + row), win_start,
                     win_len, block)


# ---------------------------------------------------------------------------
# the plain versions' pair machinery
# ---------------------------------------------------------------------------


class PairRule(NamedTuple):
    """Which window senders pair with a receiver, for the plain versions:
    ``ring(r0, r1, nb, o, idx)`` is the ``[nb, B, W]`` membership mask of
    row offset ``o``, and ``cutoff2`` (or None) an upper bound on rij2 that
    every family obeys."""

    ring: Callable
    cutoff2: Optional[float]


def key_rule(frame: SortedFrame, offs) -> PairRule:
    """Kernels 1-3 (:mod:`windows_t`): the sender's key within one of
    ``key_i + off``."""
    def ring(r0, r1, nb, o, idx):
        ki = frame.key[r0:r1].view(nb, -1, 1)
        return (frame.key[idx][:, None, :] - (ki + offs[o])).abs() <= 1
    return PairRule(ring, None)


def position_rule(frame: SortedFrame, grid: CellGrid) -> PairRule:
    """Kernels 4-6: the ring from the cell coordinates of the positions,
    valid senders only (``prop_j >= 0``, ``j != i``), ``rij2 <= support^2``
    (``_edge_mask_and_geometry`` and the ``valid`` lines of the JAX
    kernels)."""
    cells = cell_coords(frame.pos, grid)
    rows = torch.arange(frame.pos.shape[0], device=frame.pos.device)
    _, offs_yz = row_offsets(grid)
    three_d = grid.cell_count[2] > 1

    def ring(r0, r1, nb, o, idx):
        oy, oz = offs_yz[o]
        ci = cells[r0:r1].view(nb, -1, 1, 3)
        cj = cells[idx][:, None, :, :]
        m = ((cj[..., 0] - ci[..., 0]).abs() <= 1) & (
            cj[..., 1] - ci[..., 1] == oy)
        if three_d:
            m = m & (cj[..., 2] - ci[..., 2] == oz)
        m = m & (frame.prop[idx] >= 0)[:, None, :]
        return m & (idx[:, None, :] != rows[r0:r1].view(nb, -1, 1))
    return PairRule(ring, grid.support * grid.support)


def _window_slabs(frame: SortedFrame, win_start, win_len, n_off: int,
                  block: int):
    """Iterate the plain versions' work: for slabs of receiver blocks and
    each cell-row offset, yield ``(r0, r1, nb, o, idx, lane_valid)`` with
    ``idx`` ``[nb, W]`` the sender rows of each block's window (0 on lanes
    past the window's end, which ``lane_valid`` masks) -- each window is
    walked exactly from start to start + len."""
    n = frame.pos.shape[0]
    nblocks = n // block
    dev = frame.pos.device
    # slabs grow while blocks x longest window stays inside the budget, so a
    # few long windows (a block that spans a cell-row end) do not shrink the
    # slabs of all the others
    longest = win_len.max(dim=1).values.tolist() if win_len.numel() else []
    bounds, b0, w = [], 0, 1
    for b, wb in enumerate(longest):
        w_new = max(w, wb)
        if b > b0 and (b + 1 - b0) * block * w_new > _PLAIN_PAIR_BUDGET:
            bounds.append((b0, b))
            b0, w_new = b, max(wb, 1)
        w = w_new
    if nblocks > b0:
        bounds.append((b0, nblocks))
    lane = torch.arange(max(longest, default=1), device=dev)
    for b0, b1 in bounds:
        for o in range(n_off):
            ln = win_len[b0:b1, o].long()
            w = int(ln.max())
            if w == 0:
                continue
            lane_valid = lane[:w][None, :] < ln[:, None]
            idx = win_start[b0:b1, o].long()[:, None] + lane[:w][None, :]
            idx = torch.where(lane_valid, idx, torch.zeros_like(idx))
            yield b0 * block, b1 * block, b1 - b0, o, idx, lane_valid


def _pair_geometry(frame: SortedFrame, r0, r1, nb, o, idx, lane_valid,
                   planar: bool, rule: PairRule):
    """[nb, B, W] ring-and-validity mask, separation components, rij2, 1/r
    and r for one slab and offset."""
    b = (r1 - r0) // nb
    xi = frame.pos[r0:r1].view(nb, b, 1, 3)
    xj = frame.pos[idx][:, None, :, :]  # [nb, 1, W, 3]
    m = rule.ring(r0, r1, nb, o, idx) & lane_valid[:, None, :]
    dx = xj[..., 0] - xi[..., 0]
    dy = xj[..., 1] - xi[..., 1]
    rij2 = dx * dx + dy * dy
    dz = None
    if not planar:
        dz = xj[..., 2] - xi[..., 2]
        rij2 = rij2 + dz * dz
    m = m & (rij2 > 0)
    if rule.cutoff2 is not None:
        m = m & (rij2 <= rule.cutoff2)
    r2s = torch.where(m, rij2, torch.ones_like(rij2))
    inv_r = torch.rsqrt(r2s)
    return m, (dx, dy, dz), rij2, inv_r, r2s * inv_r


def _pair_ratios(ratio_table, type_i, prop_j):
    """InteractionRatio[type_i][prop_j] and [prop_j][type_i] as [nb, B, W];
    a sender type outside the table selects 0 (the one-hot sum of the JAX
    kernels)."""
    ok = (prop_j >= 0) & (prop_j < TYPE_COUNT)
    pj = torch.clamp(prop_j, 0, TYPE_COUNT - 1).long()
    ti = type_i.long()
    zero = torch.zeros((), dtype=ratio_table.dtype, device=ratio_table.device)
    return (torch.where(ok, ratio_table[ti, pj], zero),
            torch.where(ok, ratio_table[pj, ti], zero))


def _masked_sum(mask, value):
    return torch.where(mask, value, torch.zeros_like(value)).sum(dim=-1)


def harmonic_mu(mu_i, mu_j):
    """``2 mu_i mu_j / (mu_i + mu_j)``, 0 where the sum is not positive (the
    ``mu_h`` of the row-major JAX kernels)."""
    den = mu_i + mu_j
    live = den > 0
    return torch.where(
        live, 2.0 * mu_i * mu_j / torch.where(live, den, torch.ones_like(den)),
        torch.zeros_like(den))


# ---------------------------------------------------------------------------
# plain sweep bodies (both families)
# ---------------------------------------------------------------------------


def phase1_plain(frame: SortedFrame, win_start, win_len, n_off: int,
                 ks: KernelSet, cfg: WindowConfig, tables: TypeTables, *,
                 support: float, count: bool, rule: PairRule):
    """The phase-1 sums per receiver under a pair rule: ``[7, N]`` (rows
    ``P1_*``: density A, gravity-centre x y z, wp sum, divergence,
    neighbour count within ``support``)."""
    n = frame.pos.shape[0]
    dtype, dev = frame.pos.dtype, frame.pos.device
    out = torch.zeros((7, n), dtype=dtype, device=dev)
    with_ratio = cfg.surface_tension and not cfg.uniform_ratio
    c = _phase1_consts(ks, support)
    (ra2, rg2, rp2, inv_ra, inv_rg, inv_rp, norm_a, norm_g, r2g, radius_g,
     norm_p, div_scale, support2) = c
    type_all = torch.clamp(frame.prop, 0, TYPE_COUNT - 1)
    for r0, r1, nb, o, idx, lane_valid in _window_slabs(
            frame, win_start, win_len, n_off, cfg.block):
        m, (dx, dy, dz), rij2, inv_r, rij = _pair_geometry(
            frame, r0, r1, nb, o, idx, lane_valid, cfg.planar, rule)
        acc = out[:, r0:r1].view(7, nb, -1)
        m_p = m & (rp2 - rij2 >= 0)
        q_p = rij * inv_rp
        omq_p = 1.0 - q_p

        if cfg.surface_tension:
            if with_ratio:
                ratio_ij, _ = _pair_ratios(
                    tables.interaction_ratio,
                    type_all[r0:r1].view(nb, -1, 1),
                    frame.prop[idx][:, None, :])
            else:
                ratio_ij = 1.0
            if cfg.uniform_radii:
                m_a = m_g = m_p
                q_a = q_p
                omq_a2 = omq_p * omq_p
                omq_g2 = omq_a2
            else:
                m_a = m & (ra2 - rij2 >= 0)
                m_g = m & (rg2 - rij2 >= 0)
                q_a = rij * inv_ra
                omq_a2 = (1.0 - q_a) ** 2
                omq_g2 = (1.0 - rij * inv_rg) ** 2
            acc[P1_DA] += _masked_sum(m_a, ratio_ij * (norm_a * q_a * omq_a2))
            w_gc = torch.where(
                m_g, ratio_ij * (norm_g * omq_g2) / r2g * radius_g,
                torch.zeros_like(rij))
            acc[P1_GX] += (dx * w_gc).sum(dim=-1)
            acc[P1_GY] += (dy * w_gc).sum(dim=-1)
            if not cfg.planar:
                acc[P1_GZ] += (dz * w_gc).sum(dim=-1)

        acc[P1_WP] += _masked_sum(m_p, omq_p * omq_p)
        vi = frame.vel[r0:r1].view(nb, -1, 1, 3)
        vj = frame.vel[idx][:, None, :, :]
        udotx = (vj[..., 0] - vi[..., 0]) * dx + (vj[..., 1] - vi[..., 1]) * dy
        if not cfg.planar:
            udotx = udotx + (vj[..., 2] - vi[..., 2]) * dz
        acc[P1_DIV] += _masked_sum(m_p, (udotx * inv_r) * omq_p)
        if count:
            acc[P1_COUNT] += (m & (rij2 <= support2)).to(dtype).sum(dim=-1)
    # fold the hoisted kernel norms back in
    out[P1_WP] *= norm_p
    out[P1_DIV] *= div_scale
    return out


def eos_fields(out, frame: SortedFrame, ks: KernelSet,
               tables: TypeTables) -> dict:
    """Phase-1 sums ``[7, N]`` -> the per-particle fields with the EOS
    (``phase1_fields_pallas`` and ``phase1_fields_pallas_t`` share this
    tail).  ``prop`` is clipped to 0..5 for the table look-ups, so pad rows
    (prop = -1) read row 0, as there."""
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    prop_i = torch.clamp(frame.prop, 0, TYPE_COUNT - 1).long()
    s_i = is_structure(frame.prop)
    da = torch.where(s_i, zero, out[P1_DA])
    gc_rows = torch.where(s_i[None, :], zero, out[P1_GX:P1_GZ + 1])
    dvg = out[P1_DIV]
    vs = out[P1_WP] - ks.n0p
    kappa = torch.where(vs < 0.0, zero, tables.bulk_modulus[prop_i])
    lam = tables.bulk_viscosity[prop_i]
    mu = tables.shear_viscosity[prop_i]
    pp = -lam * dvg + torch.where(vs > 0.0, kappa * vs, zero)
    pa = tables.cof_a[prop_i] * (da - ks.n0a) / ks.spacing
    pa = torch.where(da >= ks.n0a, zero, pa)
    return dict(
        density_a=da, gravity_center=gc_rows.T, gc_rows=gc_rows,
        vol_strain=vs, divergence=dvg, pressure_p=pp, pressure_a=pa, mu=mu,
        neighbor_count=out[P1_COUNT].to(torch.int32),
    )


def phase2_plain(frame: SortedFrame, pp, pa, gc, visc, win_start, win_len,
                 n_off: int, ks: KernelSet, cfg: WindowConfig,
                 tables: TypeTables, *, volume: float, two_dimensional: bool,
                 rule: PairRule, mu_h: Callable):
    """The pairwise force per receiver under a pair rule, ``[3, N]``.
    ``gc`` is ``[N, 3]``; ``pa`` and ``gc`` are read with surface tension
    only; ``mu_h(visc_i, visc_j)`` is the pair's viscosity from the
    per-particle field ``visc``."""
    n = frame.pos.shape[0]
    dtype, dev = frame.pos.dtype, frame.pos.device
    out = torch.zeros((3, n), dtype=dtype, device=dev)
    st = cfg.surface_tension
    with_ratio = st and not cfg.uniform_ratio
    (rp2, ra2, rv2, rg2, inv_rp, inv_ra, inv_rv, inv_rg, dwp_coef, norm_a,
     radius_a, dwv_coef, norm_g, dwg_coef, c_v, volume, scale_di,
     cof_k2) = _phase2_consts(ks, volume, two_dimensional)
    type_all = torch.clamp(frame.prop, 0, TYPE_COUNT - 1)
    rs_all = is_structure(frame.prop)
    for r0, r1, nb, o, idx, lane_valid in _window_slabs(
            frame, win_start, win_len, n_off, cfg.block):
        m, (dx, dy, dz), rij2, inv_r, rij = _pair_geometry(
            frame, r0, r1, nb, o, idx, lane_valid, cfg.planar, rule)
        acc = out[:, r0:r1].view(3, nb, -1)
        zero = torch.zeros_like(rij)
        ex, ey = dx * inv_r, dy * inv_r
        ez = None if cfg.planar else dz * inv_r
        rs = rs_all[r0:r1].view(nb, -1, 1)
        prop_j = frame.prop[idx][:, None, :]
        ss = is_structure(prop_j)
        if with_ratio:
            ratio_ij, ratio_ji = _pair_ratios(
                tables.interaction_ratio, type_all[r0:r1].view(nb, -1, 1),
                prop_j)
        else:
            ratio_ij = ratio_ji = 1.0

        # pressureP + FSI interface load
        m_p = m & (rp2 - rij2 > 0)
        q_p = rij * inv_rp
        omq_p = 1.0 - q_p
        dwp = dwp_coef * omq_p
        pp_i = pp[r0:r1].view(nb, -1, 1)
        radial = torch.where(m_p & ~(rs & ss),
                             (pp_i + pp[idx][:, None, :]) * dwp * volume, zero)

        # pressureA; exactly zero without surface tension
        if st:
            if cfg.uniform_radii:
                m_a, q_a, omq_a = m_p, q_p, omq_p
            else:
                m_a = m & (ra2 - rij2 > 0)
                q_a = rij * inv_ra
                omq_a = 1.0 - q_a
            dwa = norm_a * omq_a * (1.0 - 3.0 * q_a) / radius_a
            pa_i = pa[r0:r1].view(nb, -1, 1)
            coeff_pa = (pa_i * ratio_ij
                        + pa[idx][:, None, :] * ratio_ji) * dwa * volume
            radial = radial + torch.where(m_a & ~rs, coeff_pa, zero)

        # viscosity
        if cfg.uniform_radii:
            m_v, omq_v = m_p, omq_p
        else:
            m_v = m & (rv2 - rij2 > 0)
            omq_v = 1.0 - rij * inv_rv
        vi = frame.vel[r0:r1].view(nb, -1, 1, 3)
        vj = frame.vel[idx][:, None, :, :]
        udote = (vj[..., 0] - vi[..., 0]) * ex + (vj[..., 1] - vi[..., 1]) * ey
        if not cfg.planar:
            udote = udote + (vj[..., 2] - vi[..., 2]) * ez
        mu_ij = mu_h(visc[r0:r1].view(nb, -1, 1), visc[idx][:, None, :])
        dwv = dwv_coef * omq_v
        coeff_v = c_v * mu_ij * udote * (-dwv) * inv_r * volume
        radial = radial + torch.where(m_v & ~rs, coeff_v, zero)

        acc[0] += (radial * ex).sum(dim=-1)
        acc[1] += (radial * ey).sum(dim=-1)
        if not cfg.planar:
            acc[2] += (radial * ez).sum(dim=-1)

        # diffuse interface; zero without surface tension
        if st:
            if cfg.uniform_radii:
                m_g, omq_g = m_p, omq_p
            else:
                m_g = m & (rg2 - rij2 > 0)
                omq_g = 1.0 - rij * inv_rg
            wgv = norm_g * (omq_g * omq_g)
            dwg = dwg_coef * omq_g
            wij, wji = ratio_ij * wgv, ratio_ji * wgv
            dwij, dwji = ratio_ij * dwg, ratio_ji * dwg
            a_i = (tables.cof_a[type_all[r0:r1].long()] * cof_k2).view(nb, -1, 1)
            gci = gc[r0:r1].view(nb, -1, 1, 3)
            gcj = gc[idx][:, None, :, :]
            mdi = m_g & ~rs
            comps = [(0, dx, ex), (1, dy, ey)]
            if not cfg.planar:
                comps.append((2, dz, ez))
            gr_sum = sum((gcj[..., a] * dwji - gci[..., a] * dwij) * d
                         for a, d, _ in comps)
            gr = a_i * gr_sum
            for a, _, e in comps:
                t1 = a_i * (gcj[..., a] * wji - gci[..., a] * wij) * scale_di
                acc[a] -= _masked_sum(mdi, t1 + gr * e * scale_di)
    return out


def virial_plain(frame: SortedFrame, pp, pa, gc, visc, win_start, win_len,
                 n_off: int, ks: KernelSet, cfg: WindowConfig,
                 tables: TypeTables, *, volume: float, two_dimensional: bool,
                 rule: PairRule, mu_h: Callable):
    """The raw virial sums per receiver under a pair rule, ``[9, N]``
    (component ``3 a + b``): the force families with the receiver's
    pressure only, no structure rule and viscosity half-weighted, summed as
    ``f_a * xij_b``.  Inputs as :func:`phase2_plain`; a planar case leaves
    every row with a z index zero."""
    n = frame.pos.shape[0]
    dtype, dev = frame.pos.dtype, frame.pos.device
    out = torch.zeros((9, n), dtype=dtype, device=dev)
    st = cfg.surface_tension
    with_ratio = st and not cfg.uniform_ratio
    (rp2, ra2, rv2, rg2, inv_rp, inv_ra, inv_rv, inv_rg, dwp_coef, norm_a,
     radius_a, dwv_coef, norm_g, dwg_coef, c_v, volume, scale_di,
     cof_k2) = _phase2_consts(ks, volume, two_dimensional)
    type_all = torch.clamp(frame.prop, 0, TYPE_COUNT - 1)
    for r0, r1, nb, o, idx, lane_valid in _window_slabs(
            frame, win_start, win_len, n_off, cfg.block):
        m, (dx, dy, dz), rij2, inv_r, rij = _pair_geometry(
            frame, r0, r1, nb, o, idx, lane_valid, cfg.planar, rule)
        acc = out[:, r0:r1].view(9, nb, -1)
        zero = torch.zeros_like(rij)
        xij = [dx, dy] if cfg.planar else [dx, dy, dz]
        eij = [d * inv_r for d in xij]
        if with_ratio:
            ratio_ij, _ = _pair_ratios(
                tables.interaction_ratio, type_all[r0:r1].view(nb, -1, 1),
                frame.prop[idx][:, None, :])
        else:
            ratio_ij = 1.0

        # pressureP family: the receiver's pressure only
        m_p = m & (rp2 - rij2 > 0)
        q_p = rij * inv_rp
        omq_p = 1.0 - q_p
        dwp = dwp_coef * omq_p
        pp_i = pp[r0:r1].view(nb, -1, 1)
        coeff = torch.where(m_p, pp_i * dwp * volume, zero)

        if st:
            # pressureA family
            if cfg.uniform_radii:
                m_a, q_a, omq_a = m_p, q_p, omq_p
            else:
                m_a = m & (ra2 - rij2 > 0)
                q_a = rij * inv_ra
                omq_a = 1.0 - q_a
            dwa = norm_a * omq_a * (1.0 - 3.0 * q_a) / radius_a
            pa_i = pa[r0:r1].view(nb, -1, 1)
            coeff = coeff + torch.where(
                m_a, pa_i * ratio_ij * dwa * volume, zero)

        # viscosity, half-weighted
        if cfg.uniform_radii:
            m_v, omq_v = m_p, omq_p
        else:
            m_v = m & (rv2 - rij2 > 0)
            omq_v = 1.0 - rij * inv_rv
        vi = frame.vel[r0:r1].view(nb, -1, 1, 3)
        vj = frame.vel[idx][:, None, :, :]
        udote = sum((vj[..., a] - vi[..., a]) * eij[a]
                    for a in range(len(xij)))
        mu_ij = mu_h(visc[r0:r1].view(nb, -1, 1), visc[idx][:, None, :])
        dwv = dwv_coef * omq_v
        visc_term = c_v * mu_ij * udote * (-dwv) * inv_r * volume
        coeff = coeff + 0.5 * torch.where(m_v, visc_term, zero)

        # diffuse interface; exactly zero without surface tension
        w_g1 = gci = None
        if st:
            if cfg.uniform_radii:
                m_g, omq_g = m_p, omq_p
            else:
                m_g = m & (rg2 - rij2 > 0)
                omq_g = 1.0 - rij * inv_rg
            wgv = norm_g * (omq_g * omq_g)
            dwg = dwg_coef * omq_g
            a_i = (tables.cof_a[type_all[r0:r1].long()] * cof_k2).view(nb, -1, 1)
            gci = gc[r0:r1].view(nb, -1, 1, 3)
            gr = -sum(gci[..., a] * xij[a] for a in range(len(xij)))
            coeff = coeff + torch.where(
                m_g, -a_i * gr * ratio_ij * dwg * scale_di, zero)
            w_g1 = torch.where(m_g, a_i * ratio_ij * wgv * scale_di, zero)

        for a in range(len(xij)):
            f_a = coeff * eij[a]
            if w_g1 is not None:
                f_a = f_a + w_g1 * gci[..., a]
            for b in range(len(xij)):
                acc[3 * a + b] += (f_a * xij[b]).sum(dim=-1)
    return out


# ---------------------------------------------------------------------------
# row-major sweeps: wrappers, plain versions and kernel launches
# ---------------------------------------------------------------------------


def _rows_geometry(grid: CellGrid):
    """C arguments of the position ring: ``(oy, oz)`` per row offset
    (flattened), ``domain_min`` and ``cell_width`` (six doubles) and
    ``cell_count`` (three ints)."""
    _, offs_yz = row_offsets(grid)
    return (len(offs_yz), _c_ints([v for yz in offs_yz for v in yz]),
            _c_doubles([*grid.domain_min, *grid.cell_width]),
            _c_ints(grid.cell_count))


def phase1_rows_sweep_plain(frame: SortedFrame, win_start, win_len,
                            grid: CellGrid, ks: KernelSet, cfg: WindowConfig,
                            tables: TypeTables):
    """Plain PyTorch version of the row-major phase-1 sweep (the arithmetic
    of the JAX ``pallas_pairwise._phase1_kernel``).  Returns ``[7, N]``
    (rows ``P1_*``), the count always."""
    return phase1_plain(frame, win_start, win_len, len(row_offsets(grid)[0]),
                        ks, cfg, tables, support=grid.support, count=True,
                        rule=position_rule(frame, grid))


def _phase1_rows_cuda(frame, win_start, win_len, grid, ks, cfg, tables):
    n_off, offs_yz, geom, ncell = _rows_geometry(grid)
    _check_frame(frame, win_start, win_len, n_off, cfg.block)
    n = frame.pos.shape[0]
    lib = cuda_loader.load()
    consts = _phase1_consts(ks, grid.support)
    if len(consts) != lib.fsi_phase1_nconst():
        raise RuntimeError("phase1_rows_sweep: constant table out of step with csrc")
    out = torch.empty((7, n), dtype=frame.pos.dtype, device=frame.pos.device)
    with_ratio = cfg.surface_tension and not cfg.uniform_ratio
    with torch.cuda.device(frame.pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fsi_phase1_rows(
            int(frame.pos.dtype == torch.float64),
            frame.pos.data_ptr(), frame.vel.data_ptr(), frame.key.data_ptr(),
            frame.prop.data_ptr(), win_start.data_ptr(), win_len.data_ptr(),
            out.data_ptr(), n,
            cfg.block, n_off, offs_yz, geom, ncell, _c_doubles(consts),
            _c_doubles(tables.interaction_ratio_host), int(cfg.planar),
            int(cfg.surface_tension), int(with_ratio),
            int(cfg.uniform_radii), stream)
    _raise_on(err, "phase1_rows_sweep")
    launch_counts["phase1_rows"] += 1
    return out


def phase1_rows_sweep(frame: SortedFrame, win_start, win_len, grid: CellGrid,
                      ks: KernelSet, cfg: WindowConfig, tables: TypeTables):
    """Row-major phase-1 sums per receiver, ``[7, N]`` in sorted order (rows
    ``P1_*``, the neighbour count always).

    A CUDA frame goes through the hand-written kernel
    (``csrc/phase1_sweep.cu``, ``fsi_phase1_rows``, replacing the TPU
    ``pallas_pairwise._phase1_kernel``) or the call raises; only a CPU frame
    takes :func:`phase1_rows_sweep_plain`.  The kernel finds each
    receiver's ring run from the key (:func:`ring_runs_rows`), so the frame
    must be sorted from these positions (:func:`packed_engine.sort_frame`,
    plane-padded in 3-D; the row-major backend sorts every step)."""
    if frame.pos.is_cuda:
        return _phase1_rows_cuda(frame, win_start, win_len, grid, ks, cfg,
                                 tables)
    return phase1_rows_sweep_plain(frame, win_start, win_len, grid, ks, cfg,
                                   tables)


def phase1_fields(frame: SortedFrame, grid: CellGrid, ks: KernelSet,
                  tables: TypeTables, *, cfg: WindowConfig,
                  windows=None, count: bool = True) -> dict:
    """Row-major phase 1 (densities) + per-particle EOS; the output contract
    of the JAX ``phase1_fields_pallas``: the EOS fields, ``neighbor_count``
    and ``window_overflow`` (the longest window; the sweep walks windows of
    any length exactly, so it is a load signal only).  ``windows`` may be
    handed in to share one table between the phases of a step.  The sweep
    always counts: ``count`` is there so that both backends take the same
    arguments, and ``False`` is refused."""
    if not count:
        raise ValueError("the row-major phase 1 always counts neighbours")
    win_start, win_len = windows if windows is not None else compute_windows(
        frame, grid, cfg)
    out = phase1_rows_sweep(frame, win_start, win_len, grid, ks, cfg, tables)
    fields = eos_fields(out, frame, ks, tables)
    del fields["gc_rows"]
    fields["window_overflow"] = win_len.max().to(torch.int32)
    return fields


def _launch_rows(name: str, rows: int, frame, pp, pa, gc, mu, win_start,
                 win_len, grid, ks, cfg, tables, volume, two_dimensional):
    """Launch ``fsi_phase2_rows`` or ``fsi_virial_rows`` (one argument
    list; the sorted key finds each receiver's ring run) and return its
    ``[rows, N]`` output."""
    n_off, offs_yz, geom, ncell = _rows_geometry(grid)
    _check_frame(frame, win_start, win_len, n_off, cfg.block)
    _check_phase2_fields(frame, pp, pa, gc, mu, cfg, "mu")
    lib = cuda_loader.load()
    consts = _phase2_consts(ks, volume, two_dimensional)
    if len(consts) != lib.fsi_phase2_nconst():
        raise RuntimeError(f"{name}_sweep: constant table out of step with csrc")
    n = frame.pos.shape[0]
    dtype, dev = frame.pos.dtype, frame.pos.device
    out = torch.empty((rows, n), dtype=dtype, device=dev)
    st = cfg.surface_tension
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"fsi_{name}")(
            int(dtype == torch.float64), frame.pos.data_ptr(),
            frame.vel.data_ptr(), frame.key.data_ptr(), frame.prop.data_ptr(),
            pp.data_ptr(),
            pa.data_ptr() if st else None, gc.data_ptr() if st else None,
            mu.data_ptr(), win_start.data_ptr(), win_len.data_ptr(),
            out.data_ptr(), n, cfg.block, n_off, offs_yz, geom, ncell,
            _c_doubles(consts), _c_doubles(tables.interaction_ratio_host),
            _c_doubles(tables.cof_a_host), grid.support * grid.support,
            int(cfg.planar), int(st), int(cfg.uniform_ratio),
            int(cfg.uniform_radii), stream)
    _raise_on(err, f"{name}_sweep")
    launch_counts[name] += 1
    return out


def phase2_rows_sweep_plain(frame: SortedFrame, pp, pa, gc, mu, win_start,
                            win_len, grid: CellGrid, ks: KernelSet,
                            cfg: WindowConfig, tables: TypeTables, *,
                            volume: float, two_dimensional: bool):
    """Plain PyTorch version of the row-major phase-2 sweep (the arithmetic
    of the JAX ``pallas_pairwise._phase2_kernel``).  ``gc`` is ``[N, 3]``;
    ``pa`` and ``gc`` are read with surface tension only.  Returns
    ``[3, N]``."""
    return phase2_plain(frame, pp, pa, gc, mu, win_start, win_len,
                        len(row_offsets(grid)[0]), ks, cfg, tables,
                        volume=volume, two_dimensional=two_dimensional,
                        rule=position_rule(frame, grid), mu_h=harmonic_mu)


def phase2_rows_sweep(frame: SortedFrame, pp, pa, gc, mu, win_start, win_len,
                      grid: CellGrid, ks: KernelSet, cfg: WindowConfig,
                      tables: TypeTables, *, volume: float,
                      two_dimensional: bool):
    """Row-major pairwise force per receiver, ``[3, N]`` in sorted order.

    A CUDA frame goes through the hand-written kernel
    (``csrc/phase2_sweep.cu``, ``fsi_phase2_rows``, replacing the TPU
    ``pallas_pairwise._phase2_kernel``) or the call raises; only a CPU frame
    takes :func:`phase2_rows_sweep_plain`.  The kernel finds each
    receiver's ring run from the key (:func:`ring_runs_rows`), so the frame
    must be sorted from these positions (:func:`packed_engine.sort_frame`,
    plane-padded in 3-D; the row-major backend sorts every step)."""
    if frame.pos.is_cuda:
        return _launch_rows("phase2_rows", 3, frame, pp, pa, gc, mu,
                            win_start, win_len, grid, ks, cfg, tables, volume,
                            two_dimensional)
    return phase2_rows_sweep_plain(frame, pp, pa, gc, mu, win_start, win_len,
                                   grid, ks, cfg, tables, volume=volume,
                                   two_dimensional=two_dimensional)


def _phase2_inputs(fields: dict, cfg: WindowConfig):
    gc = fields["gravity_center"]
    if cfg.surface_tension:
        gc = gc.contiguous()
    return fields["pressure_p"], fields["pressure_a"], gc, fields["mu"]


def phase2_forces(frame: SortedFrame, fields: dict, grid: CellGrid,
                  ks: KernelSet, tables: TypeTables, *, volume: float,
                  two_dimensional: bool, cfg: WindowConfig, windows=None):
    """Row-major phase 2 (forces) over the full frame; ``[N, 3]`` in sorted
    order (the JAX ``phase2_forces_pallas``).  ``fields`` is the dict of
    :func:`phase1_fields`."""
    win_start, win_len = windows if windows is not None else compute_windows(
        frame, grid, cfg)
    out = phase2_rows_sweep(
        frame, *_phase2_inputs(fields, cfg), win_start, win_len, grid, ks,
        cfg, tables, volume=volume, two_dimensional=two_dimensional)
    return out.T


def virial_rows_sweep_plain(frame: SortedFrame, pp, pa, gc, mu, win_start,
                            win_len, grid: CellGrid, ks: KernelSet,
                            cfg: WindowConfig, tables: TypeTables, *,
                            volume: float, two_dimensional: bool):
    """Plain PyTorch version of the row-major virial sweep (the arithmetic
    of the JAX ``pallas_pairwise._virial_kernel``).  Returns the raw sums
    ``[9, N]``."""
    return virial_plain(frame, pp, pa, gc, mu, win_start, win_len,
                        len(row_offsets(grid)[0]), ks, cfg, tables,
                        volume=volume, two_dimensional=two_dimensional,
                        rule=position_rule(frame, grid), mu_h=harmonic_mu)


def virial_rows_sweep(frame: SortedFrame, pp, pa, gc, mu, win_start, win_len,
                      grid: CellGrid, ks: KernelSet, cfg: WindowConfig,
                      tables: TypeTables, *, volume: float,
                      two_dimensional: bool):
    """Row-major raw virial sums per receiver, ``[9, N]`` in sorted order.

    A CUDA frame goes through the hand-written kernel
    (``csrc/virial_sweep.cu``, ``fsi_virial_rows``, replacing the TPU
    ``pallas_pairwise._virial_kernel``) or the call raises; only a CPU frame
    takes :func:`virial_rows_sweep_plain`.  The kernel finds each
    receiver's ring run from the key (:func:`ring_runs_rows`), so the frame
    must be sorted from these positions (:func:`packed_engine.sort_frame`,
    plane-padded in 3-D; the diagnostics always build such a frame)."""
    if frame.pos.is_cuda:
        return _launch_rows("virial_rows", 9, frame, pp, pa, gc, mu,
                            win_start, win_len, grid, ks, cfg, tables, volume,
                            two_dimensional)
    return virial_rows_sweep_plain(frame, pp, pa, gc, mu, win_start, win_len,
                                   grid, ks, cfg, tables, volume=volume,
                                   two_dimensional=two_dimensional)


def virial(frame: SortedFrame, fields: dict, grid: CellGrid, ks: KernelSet,
           tables: TypeTables, *, volume: float, two_dimensional: bool,
           cfg: WindowConfig, windows=None):
    """Row-major virial stress at every particle (the JAX ``virial_pallas``):
    ``(virial_stress [9, N] row-major components, virial_pressure [N])`` in
    sorted order.  ``fields`` is the dict of :func:`phase1_fields` for the
    same frame."""
    win_start, win_len = windows if windows is not None else compute_windows(
        frame, grid, cfg)
    out = virial_rows_sweep(
        frame, *_phase2_inputs(fields, cfg), win_start, win_len, grid, ks,
        cfg, tables, volume=volume, two_dimensional=two_dimensional)
    return virial_pressure(out, volume, two_dimensional)


def virial_pressure(raw, volume: float, two_dimensional: bool):
    """Raw virial sums ``[9, N]`` -> ``(stress = raw / V, -trace / d)``."""
    stress = raw / volume
    d = 2.0 if two_dimensional else 3.0
    tr = stress[0] + stress[4]
    if not two_dimensional:
        tr = tr + stress[8]
    return stress, -tr / d
