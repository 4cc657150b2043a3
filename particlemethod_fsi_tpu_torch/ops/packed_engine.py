"""The cell-sorted particle frame and the packed candidate engine.

Counterpart of ``particlemethod_fsi_tpu/ops/packed_engine.py``, all of it:
the sorted frame (:class:`SortedFrame`, :func:`sort_frame`, :func:`unsort`,
:func:`pad_frame_planes`, the window sweeps' frame) and the ``packed``
engine over it (:func:`phase1_fields`, :func:`phase2_forces`,
:func:`packed_fluid_forces`, :func:`packed_virial`, :func:`apply_key_sort`,
:func:`resort`).

The engine's contract is the JAX one: each receiver's candidates are the
first ``cap`` sorted rows of each cell of its wrapped 3x3(x3) neighbourhood
(``grid.offsets`` order, then rank in the cell), kept where filled, not the
receiver itself and within ``grid.support`` (the minimum image, so periodic
axes need no ghost rows); the per-edge formulas are ``ops/edge_math``'s.
The JAX layout is not carried: there, fields ride as float lanes of packed
rows (the id as well) in a dense ``[ncells, W*cap]`` table, so that a TPU
fetches a candidate with one row gather.  Here the table holds sorted row
indices (``[ncells, cap]``, -1 on an empty slot), ids stay integers (a
float32 id is inexact past 2^24 rows), and each field is gathered by index
from the frame.

Receivers are evaluated in blocks of at most :data:`EDGES_PER_BLOCK`
receiver-candidate edges (``receivers_of(frame, start, count)``), so that
the ``[R, M]`` edge arrays stay within the card's memory at full size (the
3-D gate at capacity 64 has 1,728 candidates a receiver).  Every result is
a function of its own receiver's row only, so blocks give the same numbers
as one evaluation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from particlemethod_fsi_tpu_torch.config import TYPE_COUNT
from particlemethod_fsi_tpu_torch.ops import edge_math as em
from particlemethod_fsi_tpu_torch.ops import fluid as fl
from particlemethod_fsi_tpu_torch.ops.neighbors import (
    CellGrid, _cell_coords as cell_coords, _linear_cell_id, min_image)
from particlemethod_fsi_tpu_torch.ops.smoothing import KernelSet

# rows a cell plane of a 3-D frame is aligned to; every receiver block size
# divides it
PLANE_ALIGN = 256
# receiver-candidate edges evaluated at once by the packed engine (float32:
# 256 MiB an [R, M] edge array; the phases hold a few dozen of them)
EDGES_PER_BLOCK = 1 << 26


class SortedFrame(NamedTuple):
    """Per-step sorted particle frame.  ``cell_start`` and ``coords`` serve
    the packed engine only: :func:`sort_frame` computes them where asked
    (a search over every cell), and the window sweeps' frames carry None."""

    key: torch.Tensor  # [N] int32 cell id (sentinel = num_cells on padding)
    pos: torch.Tensor  # [N,3] sorted
    vel: torch.Tensor  # [N,3]
    prop: torch.Tensor  # [N] int32
    orig: torch.Tensor  # [N] int64 original slot index
    cell_start: Optional[torch.Tensor] = None  # [num_cells + 1] int64
    coords: Optional[torch.Tensor] = None  # [N,3] int32 cell coords


def _cell_key(pos: torch.Tensor, grid: CellGrid, valid: torch.Tensor):
    """int32 cell id per particle (x fastest), ``num_cells`` where invalid."""
    return torch.where(valid, _linear_cell_id(cell_coords(pos, grid), grid),
                       grid.num_cells)


def sort_frame(pos, vel, prop, grid: CellGrid, *,
               with_cell_start: bool = False) -> SortedFrame:
    """Sort particles by cell id.  A stable sort of the key alone reproduces
    the JAX package's total order on ``(key, slot)``, so the frame agrees
    with it row by row; the payload follows with one gather each.
    ``with_cell_start`` adds the packed engine's per-cell offsets and the
    sorted rows' cell coordinates (the JAX default; the window sweeps find
    their own offsets at block boundaries and skip the search)."""
    key = _cell_key(pos, grid, prop >= 0)
    skey, sorig = torch.sort(key, stable=True)
    frame = SortedFrame(key=skey, pos=pos[sorig], vel=vel[sorig],
                        prop=prop[sorig], orig=sorig)
    if not with_cell_start:
        return frame
    cell_start = torch.searchsorted(
        skey, torch.arange(grid.num_cells + 1, dtype=skey.dtype,
                           device=skey.device))
    return frame._replace(cell_start=cell_start,
                          coords=cell_coords(frame.pos, grid))


def _build_table(frame: SortedFrame, grid: CellGrid, cap: int):
    """``[num_cells, cap]`` table of each cell's first ``cap`` sorted rows
    (a cell's rows are the contiguous run ``cell_start[c] + r``), -1 on an
    empty slot; a cell past ``cap`` loses its later rows, as in JAX."""
    start = frame.cell_start[:-1]
    count = frame.cell_start[1:] - start
    r = torch.arange(cap, device=start.device)
    return torch.where(r[None, :] < count[:, None], start[:, None] + r[None, :],
                       -1)


def _ratio_lookup(ir_rows, prop_j):
    """InteractionRatio[prop_i, prop_j] from the receivers' table rows
    ``ir_rows`` [R, 6] and the senders' types ``prop_j`` [R, M]; 0 where
    ``prop_j`` is no type (the JAX one-hot sum's value there)."""
    known = (prop_j >= 0) & (prop_j < TYPE_COUNT)
    v = torch.gather(ir_rows, 1, torch.clamp(prop_j, 0, TYPE_COUNT - 1).long())
    return torch.where(known, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device))


class ReceiverView(NamedTuple):
    """A slice of the sorted frame acting as receivers.  Senders always come
    from the full frame."""

    pos: torch.Tensor  # [R,3]
    vel: torch.Tensor  # [R,3]
    prop: torch.Tensor  # [R] int32
    coords: torch.Tensor  # [R,3] cell coords
    ids: torch.Tensor  # [R] global sorted indices (for self-exclusion)
    # the kept candidates' sorted rows [R, W] and where a column holds one,
    # as :func:`frame_views` finds them (None: found from the frame)
    cand: Optional[torch.Tensor] = None
    cand_ok: Optional[torch.Tensor] = None


def receivers_of(frame: SortedFrame, start: int = 0,
                 count: Optional[int] = None) -> ReceiverView:
    """The rows ``[start, start + count)`` of a frame with ``cell_start``
    (all rows by default)."""
    n = frame.pos.shape[0]
    count = n - start if count is None else count
    sl = slice(start, start + count)
    return ReceiverView(
        pos=frame.pos[sl], vel=frame.vel[sl], prop=frame.prop[sl],
        coords=frame.coords[sl],
        ids=torch.arange(start, start + count, device=frame.pos.device))


def receiver_blocks(n: int, grid: CellGrid, cap: int, start: int = 0,
                    count: Optional[int] = None) -> list:
    """``(start, count)`` of each receiver block of the rows ``[start,
    start + count)`` of an ``n``-row frame (all rows by default): at most
    :data:`EDGES_PER_BLOCK` edges a block."""
    step = max(1, EDGES_PER_BLOCK // (len(grid.offsets) * cap))
    end = n if count is None else start + count
    return [(s, min(step, end - s)) for s in range(start, end, step)]


def _separations(frame: SortedFrame, rv: ReceiverView, grid: CellGrid, idx):
    """Minimum-image ``x_j - x_i`` [3, R, M] of the sorted rows ``idx``."""
    dw = torch.as_tensor(grid.domain_width, dtype=rv.pos.dtype,
                         device=rv.pos.device)[:, None, None]
    return min_image(frame.pos.T[:, idx] - rv.pos.T[:, :, None], dw)


def candidates(frame: SortedFrame, rv: ReceiverView, grid: CellGrid,
               cap: int):
    """The receiver view's kept candidates ``(rows [R, W], mask [R, W])``.

    The ``[R, M]`` candidates (M = offsets x ``cap``) are tested once: a
    filled slot, not the receiver, within ``grid.support`` (the candidate
    radius guard, MaxRadius+MARGIN, src/main.cpp:1765, so that edge sets
    match the gather engine's exactly).  The kept ones are compacted, each
    row's in their scan order, to the widest row's count W: a kept
    candidate's values are the JAX engine's, a dropped one contributed
    exactly zero there, so only the order of the sums changes.  Reading W
    back is one host read."""
    table = _build_table(frame, grid, cap)
    dev = rv.coords.device
    nc = torch.as_tensor(grid.cell_count, dtype=torch.int32, device=dev)
    cand = torch.cat([
        table[_linear_cell_id(
            torch.remainder(rv.coords + torch.as_tensor(
                off, dtype=torch.int32, device=dev), nc), grid).long()]
        for off in grid.offsets], dim=1)  # [R, M]
    safe = torch.clamp_min(cand, 0)
    # the squared minimum-image distance (min_image's ops in its order), one
    # component at a time and in place: the [R, M] arrays dominate a step
    rij2 = None
    for d, w in enumerate(grid.domain_width):
        x = frame.pos[:, d][safe]
        x.sub_(rv.pos[:, d, None]).add_(0.5 * w)
        x.sub_(torch.floor(x / w).mul_(w)).sub_(0.5 * w)
        rij2 = x.mul_(x) if rij2 is None else rij2.add_(x.mul_(x))
    keep = ((cand >= 0) & (cand != rv.ids[:, None])
            & (rij2 <= grid.support**2))
    del rij2
    r, m = keep.shape
    count = keep.sum(dim=1)
    width = int(count.max()) if r else 0
    src = keep.reshape(-1).nonzero().squeeze(1)  # row-major: scan order
    row = src // m
    first = torch.cumsum(count, 0) - count
    dst = row * width + (torch.arange(src.shape[0], device=dev) - first[row])
    idx = torch.zeros(r * width, dtype=safe.dtype, device=dev)
    idx[dst] = safe.reshape(-1)[src]
    ok = torch.zeros(r * width, dtype=torch.bool, device=dev)
    ok[dst] = True
    return idx.view(r, width), ok.view(r, width)


def frame_views(frame: SortedFrame, grid: CellGrid, cap: int, *,
                start: int = 0, count: Optional[int] = None,
                agree=None) -> list:
    """Every receiver block of the frame's rows ``[start, start + count)``
    (all rows by default; :func:`receiver_blocks`) as a view with its kept
    candidates, all padded to one width (the widest block's), so that each
    receiver's sums are taken over the same columns however the frame is
    split: blocks give, bit for bit, what one block gives.  ``agree`` maps
    that width to the one to pad to (a maximum over the ranks that split the
    receivers between them, so that they pad as one device does)."""
    views = [receivers_of(frame, s, c) for s, c in receiver_blocks(
        frame.pos.shape[0], grid, cap, start, count)]
    found = [candidates(frame, rv, grid, cap) for rv in views]
    width = max((idx.shape[1] for idx, _ in found), default=0)
    if agree is not None:
        width = agree(width)
    pad = [(torch.nn.functional.pad(idx, (0, width - idx.shape[1])),
            torch.nn.functional.pad(ok, (0, width - ok.shape[1])))
           for idx, ok in found]
    return [rv._replace(cand=idx, cand_ok=ok)
            for rv, (idx, ok) in zip(views, pad)]


class CandidateFields:
    """Field extractor over a receiver view's kept candidates: ``idx``
    [R, W] holds their sorted rows (row 0 in a padding slot, which the
    geometry's ``valid`` masks out)."""

    def __init__(self, idx: torch.Tensor):
        self.idx = idx

    def field(self, x: torch.Tensor) -> torch.Tensor:
        """[N] per sorted row -> [R, W]."""
        return x[self.idx]

    def vec(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 3] per sorted row -> [3, R, W]."""
        return x.T[:, self.idx]


def _receiver_candidates(frame: SortedFrame, rv: ReceiverView,
                         grid: CellGrid, cap: int):
    """The receiver view's kept candidates (found here unless the view
    carries them) and their edge geometry."""
    if rv.cand is None:
        idx, ok = candidates(frame, rv, grid, cap)
    else:
        idx, ok = rv.cand, rv.cand_ok
    return CandidateFields(idx), em.make_geometry(
        _separations(frame, rv, grid, idx), ok)


def _type_rows(rv: ReceiverView, tables: fl.TypeTables):
    prop_i = torch.clamp(rv.prop, 0, TYPE_COUNT - 1).long()
    return (
        prop_i,
        tables.interaction_ratio[prop_i],  # ratio[prop_i, :]
        tables.interaction_ratio.T[prop_i],  # ratio[:, prop_i]
        tables.cof_a[prop_i],
        fl.is_structure(rv.prop),
    )


def phase1_fields(frame: SortedFrame, rv: ReceiverView, grid: CellGrid,
                  ks: KernelSet, tables: fl.TypeTables, *, cap: int) -> dict:
    """Densities + per-particle EOS for the receiver view (calculateDensityA/
    GravityCenter/DensityP/DivergenceP + calculatePhysicalCoefficients +
    both EOS loops, src/main.cpp:2099-2425 first halves)."""
    cand, geom = _receiver_candidates(frame, rv, grid, cap)
    _, ir_row, _, _, s_i = _type_rows(rv, tables)
    ratio_ij = _ratio_lookup(ir_row, cand.field(frame.prop))
    da, gc_c, wp_sum, dvg = em.phase1_sums(
        geom, ks, vel_i=rv.vel.T, vel_j=cand.vec(frame.vel), ratio_ij=ratio_ij)
    zero = torch.zeros((), dtype=da.dtype, device=da.device)
    da = torch.where(s_i, zero, da)
    gc = torch.where(s_i[:, None], zero, gc_c.T)  # [R, 3]
    vs = wp_sum - ks.n0p
    kappa, lam, mu = fl.physical_coefficients(rv.prop, vs, tables)
    return dict(
        density_a=da, gravity_center=gc, vol_strain=vs, divergence=dvg,
        pressure_p=fl.pressure_p(vs, dvg, kappa, lam),
        pressure_a=fl.pressure_a(da, ks, rv.prop, tables), mu=mu,
        neighbor_count=geom.valid.sum(dim=1).to(torch.int32),
        cell_overflow=(frame.cell_start[1:] - frame.cell_start[:-1]).max().to(
            torch.int32),
    )


def phase2_forces(frame: SortedFrame, rv: ReceiverView, sender_fields: dict,
                  receiver_fields: dict, grid: CellGrid, ks: KernelSet,
                  tables: fl.TypeTables, *, volume: float,
                  two_dimensional: bool, cap: int):
    """Pairwise forces ``[R, 3]`` for the receiver view.  ``sender_fields``
    carries pressure_p / pressure_a / gravity_center / mu for ALL sorted
    rows (all-gathered across shards in multi-device runs);
    ``receiver_fields`` the receivers' own."""
    cand, geom = _receiver_candidates(frame, rv, grid, cap)
    _, ir_row, ir_col, cof_a_i, s_i = _type_rows(rv, tables)
    prop_j = cand.field(frame.prop)
    force_c = em.phase2_force(
        geom, ks, volume=volume, two_dimensional=two_dimensional,
        receiver_is_structure=s_i,
        sender_is_structure=fl.is_structure(prop_j),
        pp_i=receiver_fields["pressure_p"],
        pp_j=cand.field(sender_fields["pressure_p"]),
        pa_i=receiver_fields["pressure_a"],
        pa_j=cand.field(sender_fields["pressure_a"]),
        gc_i=receiver_fields["gravity_center"].T,
        gc_j=cand.vec(sender_fields["gravity_center"]),
        mu_i=receiver_fields["mu"], mu_j=cand.field(sender_fields["mu"]),
        vel_i=rv.vel.T, vel_j=cand.vec(frame.vel),
        ratio_ij=_ratio_lookup(ir_row, prop_j),
        ratio_ji=_ratio_lookup(ir_col, prop_j),
        cof_a_i=cof_a_i,
    )
    return force_c.T  # [R, 3]


def _rows(fields: dict, start: int, count: int) -> dict:
    """The receivers' rows ``[start, start + count)`` of per-row fields."""
    return {k: v[start:start + count] if v.dim() else v
            for k, v in fields.items()}


def packed_fluid_forces(frame: SortedFrame, grid: CellGrid, ks: KernelSet,
                        tables: fl.TypeTables, *, volume: float,
                        two_dimensional: bool, cap: int,
                        views: Optional[list] = None):
    """Single-device path: both fluid phases over the full frame, receivers
    in blocks (``views``, :func:`frame_views` unless the caller has them).
    Returns per-particle (force, fields) in SORTED order."""
    if views is None:
        views = frame_views(frame, grid, cap)
    parts = [phase1_fields(frame, rv, grid, ks, tables, cap=cap)
             for rv in views]
    fields = {k: torch.cat([p[k] for p in parts]) if parts[0][k].dim()
              else parts[0][k] for k in parts[0]}
    blocks = receiver_blocks(frame.pos.shape[0], grid, cap)
    force = torch.cat([
        phase2_forces(frame, rv, fields, _rows(fields, s, c), grid, ks,
                      tables, volume=volume, two_dimensional=two_dimensional,
                      cap=cap)
        for (s, c), rv in zip(blocks, views)])
    return force, fields


def _virial_block(frame: SortedFrame, rv: ReceiverView, fields: dict,
                  mine: dict, grid: CellGrid, ks: KernelSet,
                  tables: fl.TypeTables, *, volume: float,
                  two_dimensional: bool, cap: int):
    """The virial components ``[9, R]`` of the receiver view; ``fields``
    holds the senders' rows, ``mine`` the receivers'."""
    cand, geom = _receiver_candidates(frame, rv, grid, cap)
    prop_i, ir_row, _, _, _ = _type_rows(rv, tables)
    ratio_ij = _ratio_lookup(ir_row, cand.field(frame.prop))
    zero = torch.zeros((), dtype=geom.rij.dtype, device=geom.rij.device)

    pp = mine["pressure_p"][:, None]
    pa = mine["pressure_a"][:, None]
    gc = mine["gravity_center"]  # [R, 3]
    mu_i = mine["mu"][:, None]
    mu_j = cand.field(fields["mu"])
    inv_v = 1.0 / volume
    rij = geom.rij
    valid = geom.valid

    # radial coefficient assembled per family, then outer-product with xij
    coeff = torch.zeros_like(rij)
    m_p = valid & (ks.radius_p**2 - geom.rij2 > 0)
    coeff = coeff + torch.where(m_p, pp * ks.dwpdr(rij) * volume, zero)
    m_a = valid & (ks.radius_a**2 - geom.rij2 > 0)
    coeff = coeff + torch.where(m_a, pa * ratio_ij * ks.dwadr(rij) * volume,
                                zero)
    m_v = valid & (ks.radius_v**2 - geom.rij2 > 0)
    c_v = 8.0 if two_dimensional else 10.0
    uij = cand.vec(frame.vel) - rv.vel.T[:, :, None]
    udote = torch.sum(uij * geom.eij, dim=0)
    den = mu_i + mu_j
    pos_den = den > 0
    mu_h = torch.where(pos_den, 2.0 * mu_i * mu_j / torch.where(
        pos_den, den, torch.ones_like(den)), zero)
    visc = c_v * mu_h * udote * (-ks.dwvdr(rij)) / rij * volume
    coeff = coeff + 0.5 * torch.where(m_v, visc, zero)  # half-weighted (:3221)

    # diffuse-interface second term is radial; first term is along -gc_i
    m_g = valid & (ks.radius_g**2 - geom.rij2 > 0)
    a_i = (tables.cof_a[prop_i] * ks.cof_k**2)[:, None]
    scale = 1.0 / ks.r2g * ks.radius_g * (volume / ks.spacing)
    gr = torch.sum((-gc.T)[:, :, None] * geom.xij, dim=0)  # [R, M]
    dterm = -a_i * gr * ratio_ij * ks.dwgdr(rij) * scale
    coeff_r = coeff + torch.where(m_g, dterm, zero)
    w_g1 = torch.where(m_g, a_i * ratio_ij * ks.wg(rij) * scale, zero)

    comps = []
    for a in range(3):
        f_a = coeff_r * geom.eij[a] + w_g1 * gc[:, a][:, None]  # [R, M]
        for b in range(3):
            comps.append(torch.sum(f_a * geom.xij[b], dim=-1) * inv_v)
    return torch.stack(comps, dim=0)  # [9, R]


def packed_virial(frame: SortedFrame, fields: dict, grid: CellGrid,
                  ks: KernelSet, tables: fl.TypeTables, *, volume: float,
                  two_dimensional: bool, cap: int,
                  views: Optional[list] = None):
    """Per-particle virial stress over packed candidates
    (calculateVirialStressAtParticle, src/main.cpp:3077-3318): re-derives the
    four pairwise force families weighted by the RECEIVER's pressure only
    (P_i, not Pi+Pj) and accumulates sum f (x) xij / V, receivers in blocks
    (``views``, :func:`frame_views` unless the caller has them).

    Returns (virial_stress [9, N] row-major components, virial_pressure [N])
    in SORTED order."""
    blocks = receiver_blocks(frame.pos.shape[0], grid, cap)
    stress = torch.cat([
        _virial_block(frame, rv, fields, _rows(fields, s, c), grid, ks,
                      tables, volume=volume, two_dimensional=two_dimensional,
                      cap=cap)
        for (s, c), rv in zip(blocks, views or frame_views(frame, grid, cap))],
        dim=1)
    d = 2.0 if two_dimensional else 3.0
    tr = stress[0] + stress[4] + (0.0 if two_dimensional else stress[8])
    return stress, -tr / d


def apply_key_sort(keys, *arrays):
    """Reorder arrays by ascending ``keys``, ties in their order (the JAX
    multi-operand sort is stable)."""
    order = torch.sort(keys, stable=True).indices
    return [a[order] for a in arrays]


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


def resort(frame: SortedFrame, *arrays):
    """Take original-slot-order arrays INTO the frame's sorted order (the
    JAX package sorts twice by keys; ``orig`` is the permutation, so one
    gather each is the same reordering)."""
    return [a[frame.orig] for a in arrays]


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
