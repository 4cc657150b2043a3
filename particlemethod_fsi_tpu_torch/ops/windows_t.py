"""Window-sweep pair phases over the cell-sorted frame, with hand-written
CUDA kernels.

Counterpart of ``particlemethod_fsi_tpu/ops/pallas_windows_t.py``:

=============================  ==========================================
here                           there
=============================  ==========================================
``phase1_sweep`` (+ kernel)    ``_phase1_kernel`` via ``_sweep_t``
``phase1_fields_t``            ``phase1_fields_pallas_t`` (with EOS tail)
``phase2_sweep`` (+ kernel)    ``_phase2_kernel`` via ``_sweep_t``
``phase2_forces_t``            ``phase2_forces_pallas_t``
``inverse_viscosity``          the ``invmu`` lane of ``pack_phase2_t``
``virial_sweep`` (+ kernel)    ``_virial_kernel_t`` via ``_sweep_t``
``virial_t``                   ``virial_pallas_t``
=============================  ==========================================

What the TPU layout forced and this port drops: the field-major
``[W, N + wmax]`` packing (the kernels read the frame's own tensors, so
``pack_phase1_t`` has nothing left to do and ``pack_phase2_t`` shrinks to
:func:`inverse_viscosity`), window starts floored to 128 lanes, the poisoned
tail, keys as float lanes, window tables in 128-block chunks, the merged slab
and the double buffer.  What stays: the inputs (sorted frame, ``win_start`` /
``win_len`` ``[nblocks, n_off]``, the offsets of ``row_offsets``), the outputs
in sorted order, every mask and every formula.

Each sweep has three pieces in this module: the wrapper (``phase1_sweep``,
``phase2_sweep``, ``virial_sweep``), which launches the CUDA kernel for a CUDA tensor -- or
raises -- and takes the plain version only for a CPU tensor; the plain
PyTorch version (``*_plain``), which is what the CPU tests run and what the
kernel is held against on the card; and a launch count in
:data:`launch_counts`, incremented where the kernel is launched and nowhere
else.

Bound on an H100: by the roofline count (each input read once, each output
written once, against the pair math of the true neighbour pairs only) all
three sweeps are bound by bytes, some tens of bytes a particle.  The simple design
here does not reach that bound: every receiver tests every sender of its
block's windows (an order of magnitude more candidates than neighbours), so
its time goes to shared-memory reads and the ring and radius tests.  See the
notes in ``csrc/phase1_sweep.cu``, ``csrc/phase2_sweep.cu`` and
``csrc/virial_sweep.cu``; the measured
times stand in ``PERF.md``.
"""

from __future__ import annotations

import ctypes

import torch

from particlemethod_fsi_tpu_torch.config import TYPE_COUNT
from particlemethod_fsi_tpu_torch.ops import cuda_loader
from particlemethod_fsi_tpu_torch.ops.fluid import TypeTables, is_structure
from particlemethod_fsi_tpu_torch.ops.neighbors import CellGrid
from particlemethod_fsi_tpu_torch.ops.packed_engine import SortedFrame
from particlemethod_fsi_tpu_torch.ops.smoothing import KernelSet
from particlemethod_fsi_tpu_torch.ops.windows import (
    WindowConfig,
    compute_windows,
    row_offsets,
)

# kernel launches per wrapper (plain ints; the plain versions never count)
launch_counts = {"phase1_sweep": 0, "phase2_sweep": 0, "virial_sweep": 0}

# rows of phase1_sweep's output
P1_DA, P1_GX, P1_GY, P1_GZ, P1_WP, P1_DIV, P1_COUNT = range(7)

# pair slots the plain versions hold at once ([blocks, B, W] per temporary)
_PLAIN_PAIR_BUDGET = 1 << 22


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _window_slabs(frame: SortedFrame, win_start, win_len, offs, block: int):
    """Iterate the plain versions' work: for slabs of receiver blocks and
    each cell-row offset, yield ``(r0, r1, nb, off, idx, lane_valid)`` with
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
        for o, off in enumerate(offs):
            ln = win_len[b0:b1, o].long()
            w = int(ln.max())
            if w == 0:
                continue
            lane_valid = lane[:w][None, :] < ln[:, None]
            idx = win_start[b0:b1, o].long()[:, None] + lane[:w][None, :]
            idx = torch.where(lane_valid, idx, torch.zeros_like(idx))
            yield b0 * block, b1 * block, b1 - b0, off, idx, lane_valid


def _pair_geometry(frame: SortedFrame, r0, r1, nb, off, idx, lane_valid,
                   planar: bool):
    """[nb, B, W] ring-and-validity mask, separation components, rij2, 1/r
    and r for one slab and offset (``_ring_and_geom`` of the JAX module plus
    the ``rij2 > 0`` and safe-rsqrt lines of its callers)."""
    b = (r1 - r0) // nb
    xi = frame.pos[r0:r1].view(nb, b, 1, 3)
    ki = frame.key[r0:r1].view(nb, b, 1)
    xj = frame.pos[idx][:, None, :, :]  # [nb, 1, W, 3]
    kj = frame.key[idx][:, None, :]
    m = ((kj - (ki + off)).abs() <= 1) & lane_valid[:, None, :]
    dx = xj[..., 0] - xi[..., 0]
    dy = xj[..., 1] - xi[..., 1]
    rij2 = dx * dx + dy * dy
    dz = None
    if not planar:
        dz = xj[..., 2] - xi[..., 2]
        rij2 = rij2 + dz * dz
    m = m & (rij2 > 0)
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


def _c_doubles(values):
    return (ctypes.c_double * len(values))(*[float(v) for v in values])


def _c_ints(values):
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(
            f"{what}: launch refused (cudaGetLastError = {err}; -1 means the "
            f"arguments are outside what the kernel takes)")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


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


def phase1_sweep_plain(frame: SortedFrame, win_start, win_len, offs,
                       ks: KernelSet, cfg: WindowConfig, tables: TypeTables,
                       *, support: float, count: bool = False):
    """Plain PyTorch version of the phase-1 sweep (the arithmetic of the JAX
    ``_phase1_kernel``): dense masked ``[blocks, B, W]`` pair blocks, a slab
    of receiver blocks at a time.  Returns ``[7, N]`` (rows ``P1_*``)."""
    n = frame.pos.shape[0]
    dtype, dev = frame.pos.dtype, frame.pos.device
    out = torch.zeros((7, n), dtype=dtype, device=dev)
    with_ratio = cfg.surface_tension and not cfg.uniform_ratio
    c = _phase1_consts(ks, support)
    (ra2, rg2, rp2, inv_ra, inv_rg, inv_rp, norm_a, norm_g, r2g, radius_g,
     norm_p, div_scale, support2) = c
    type_all = torch.clamp(frame.prop, 0, TYPE_COUNT - 1)
    for r0, r1, nb, off, idx, lane_valid in _window_slabs(
            frame, win_start, win_len, offs, cfg.block):
        m, (dx, dy, dz), rij2, inv_r, rij = _pair_geometry(
            frame, r0, r1, nb, off, idx, lane_valid, cfg.planar)
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


def _phase1_sweep_cuda(frame, win_start, win_len, offs, ks, cfg, tables,
                       support, count):
    _check_frame(frame, win_start, win_len, len(offs), cfg.block)
    n = frame.pos.shape[0]
    lib = cuda_loader.load()
    consts = _phase1_consts(ks, support)
    if len(consts) != lib.fsi_phase1_nconst():
        raise RuntimeError("phase1_sweep: constant table out of step with csrc")
    out = torch.empty((7, n), dtype=frame.pos.dtype, device=frame.pos.device)
    with_ratio = cfg.surface_tension and not cfg.uniform_ratio
    with torch.cuda.device(frame.pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fsi_phase1_sweep(
            int(frame.pos.dtype == torch.float64),
            frame.pos.data_ptr(), frame.vel.data_ptr(), frame.key.data_ptr(),
            frame.prop.data_ptr(), win_start.data_ptr(), win_len.data_ptr(),
            out.data_ptr(), n, cfg.block, len(offs), _c_ints(offs),
            _c_doubles(consts), _c_doubles(tables.interaction_ratio_host),
            int(cfg.planar), int(cfg.surface_tension), int(with_ratio),
            int(cfg.uniform_radii), int(count), stream)
    _raise_on(err, "phase1_sweep")
    launch_counts["phase1_sweep"] += 1
    return out


def phase1_sweep(frame: SortedFrame, win_start, win_len, offs, ks: KernelSet,
                 cfg: WindowConfig, tables: TypeTables, *, support: float,
                 count: bool = False):
    """Phase-1 sums per receiver, ``[7, N]`` in sorted order (rows ``P1_*``:
    density A, gravity-centre x y z, wp sum, divergence, neighbour count).

    A CUDA frame goes through the hand-written kernel
    (``csrc/phase1_sweep.cu``, replacing the TPU ``_phase1_kernel``) or the
    call raises; only a CPU frame takes :func:`phase1_sweep_plain`."""
    if frame.pos.is_cuda:
        return _phase1_sweep_cuda(frame, win_start, win_len, offs, ks, cfg,
                                  tables, support, count)
    return phase1_sweep_plain(frame, win_start, win_len, offs, ks, cfg,
                              tables, support=support, count=count)


def phase1_fields_t(frame: SortedFrame, grid: CellGrid, ks: KernelSet,
                    tables: TypeTables, *, cfg: WindowConfig, windows=None,
                    count: bool = False) -> dict:
    """Phase 1 (densities) + per-particle EOS; the output contract of the JAX
    ``phase1_fields_pallas_t`` without its ``window_overflow`` entry (the
    sweep walks windows of any length exactly).  ``prop`` is clipped to 0..5
    for the table look-ups, so pad rows (prop = -1) read row 0, as there."""
    win_start, win_len = windows if windows is not None else compute_windows(
        frame, grid, cfg)
    offs, _ = row_offsets(grid)
    out = phase1_sweep(frame, win_start, win_len, offs, ks, cfg, tables,
                       support=grid.support, count=count)
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


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def inverse_viscosity(mu: torch.Tensor) -> torch.Tensor:
    """1/mu with mu = 0 -> inf, so that the harmonic mean
    ``2 / (1/mu_i + 1/mu_j)`` is exactly 0 when either side is inviscid (the
    ``invmu`` lane of the JAX ``pack_phase2_t``)."""
    pos = mu > 0
    return torch.where(pos, 1.0 / torch.where(pos, mu, torch.ones_like(mu)),
                       torch.full_like(mu, float("inf")))


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


def phase2_sweep_plain(frame: SortedFrame, pp, pa, gc, invmu, win_start,
                       win_len, offs, ks: KernelSet, cfg: WindowConfig,
                       tables: TypeTables, *, volume: float,
                       two_dimensional: bool):
    """Plain PyTorch version of the phase-2 sweep (the arithmetic of the JAX
    ``_phase2_kernel``).  ``gc`` is ``[N, 3]``; ``pa`` and ``gc`` are read
    with surface tension only.  Returns ``[3, N]``."""
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
    for r0, r1, nb, off, idx, lane_valid in _window_slabs(
            frame, win_start, win_len, offs, cfg.block):
        m, (dx, dy, dz), rij2, inv_r, rij = _pair_geometry(
            frame, r0, r1, nb, off, idx, lane_valid, cfg.planar)
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

        # viscosity; mu = 0 -> 1/mu = inf -> mu_h exactly 0
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
        mu_h = 2.0 / (invmu[r0:r1].view(nb, -1, 1) + invmu[idx][:, None, :])
        dwv = dwv_coef * omq_v
        coeff_v = c_v * mu_h * udote * (-dwv) * inv_r * volume
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


def _phase2_sweep_cuda(frame, pp, pa, gc, invmu, win_start, win_len, offs, ks,
                       cfg, tables, volume, two_dimensional):
    _check_frame(frame, win_start, win_len, len(offs), cfg.block)
    n = frame.pos.shape[0]
    dtype, dev = frame.pos.dtype, frame.pos.device
    _check_tensor("pressure_p", pp, (n,), dtype, dev)
    _check_tensor("invmu", invmu, (n,), dtype, dev)
    if cfg.surface_tension:
        _check_tensor("pressure_a", pa, (n,), dtype, dev)
        _check_tensor("gravity_center", gc, (n, 3), dtype, dev)
    lib = cuda_loader.load()
    consts = _phase2_consts(ks, volume, two_dimensional)
    if len(consts) != lib.fsi_phase2_nconst():
        raise RuntimeError("phase2_sweep: constant table out of step with csrc")
    out = torch.empty((3, n), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fsi_phase2_sweep(
            int(dtype == torch.float64),
            frame.pos.data_ptr(), frame.vel.data_ptr(), frame.key.data_ptr(),
            frame.prop.data_ptr(), pp.data_ptr(),
            pa.data_ptr() if cfg.surface_tension else None,
            gc.data_ptr() if cfg.surface_tension else None,
            invmu.data_ptr(), win_start.data_ptr(), win_len.data_ptr(),
            out.data_ptr(), n, cfg.block, len(offs), _c_ints(offs),
            _c_doubles(consts), _c_doubles(tables.interaction_ratio_host),
            _c_doubles(tables.cof_a_host), int(cfg.planar),
            int(cfg.surface_tension), int(cfg.uniform_ratio),
            int(cfg.uniform_radii), stream)
    _raise_on(err, "phase2_sweep")
    launch_counts["phase2_sweep"] += 1
    return out


def phase2_sweep(frame: SortedFrame, pp, pa, gc, invmu, win_start, win_len,
                 offs, ks: KernelSet, cfg: WindowConfig, tables: TypeTables, *,
                 volume: float, two_dimensional: bool):
    """Pairwise force per receiver, ``[3, N]`` in sorted order.

    A CUDA frame goes through the hand-written kernel
    (``csrc/phase2_sweep.cu``, replacing the TPU ``_phase2_kernel``) or the
    call raises; only a CPU frame takes :func:`phase2_sweep_plain`."""
    if frame.pos.is_cuda:
        return _phase2_sweep_cuda(frame, pp, pa, gc, invmu, win_start,
                                  win_len, offs, ks, cfg, tables, volume,
                                  two_dimensional)
    return phase2_sweep_plain(frame, pp, pa, gc, invmu, win_start, win_len,
                              offs, ks, cfg, tables, volume=volume,
                              two_dimensional=two_dimensional)


def phase2_forces_t(frame: SortedFrame, fields: dict, grid: CellGrid,
                    ks: KernelSet, tables: TypeTables, *, volume: float,
                    two_dimensional: bool, cfg: WindowConfig, windows=None):
    """Phase 2 (forces) over the full frame; ``[N, 3]`` in sorted order (the
    JAX ``phase2_forces_pallas_t``).  ``fields`` is the dict of
    :func:`phase1_fields_t`."""
    win_start, win_len = windows if windows is not None else compute_windows(
        frame, grid, cfg)
    offs, _ = row_offsets(grid)
    gc = fields["gravity_center"]
    if cfg.surface_tension:
        gc = gc.contiguous()
    out = phase2_sweep(
        frame, fields["pressure_p"], fields["pressure_a"], gc,
        inverse_viscosity(fields["mu"]), win_start, win_len, offs, ks, cfg,
        tables, volume=volume, two_dimensional=two_dimensional)
    return out.T


# ---------------------------------------------------------------------------
# virial (output-time diagnostics)
# ---------------------------------------------------------------------------


def virial_sweep_plain(frame: SortedFrame, pp, pa, gc, invmu, win_start,
                       win_len, offs, ks: KernelSet, cfg: WindowConfig,
                       tables: TypeTables, *, volume: float,
                       two_dimensional: bool):
    """Plain PyTorch version of the virial sweep (the arithmetic of the JAX
    ``_virial_kernel_t``): the force families with the receiver's pressure
    only and viscosity half-weighted, summed as ``f_a * xij_b``.  ``gc`` is
    ``[N, 3]``; ``pa`` and ``gc`` are read with surface tension only.
    Returns the raw sums ``[9, N]`` (component ``3 a + b``); a planar case
    leaves every row with a z index zero."""
    n = frame.pos.shape[0]
    dtype, dev = frame.pos.dtype, frame.pos.device
    out = torch.zeros((9, n), dtype=dtype, device=dev)
    st = cfg.surface_tension
    with_ratio = st and not cfg.uniform_ratio
    (rp2, ra2, rv2, rg2, inv_rp, inv_ra, inv_rv, inv_rg, dwp_coef, norm_a,
     radius_a, dwv_coef, norm_g, dwg_coef, c_v, volume, scale_di,
     cof_k2) = _phase2_consts(ks, volume, two_dimensional)
    type_all = torch.clamp(frame.prop, 0, TYPE_COUNT - 1)
    for r0, r1, nb, off, idx, lane_valid in _window_slabs(
            frame, win_start, win_len, offs, cfg.block):
        m, (dx, dy, dz), rij2, inv_r, rij = _pair_geometry(
            frame, r0, r1, nb, off, idx, lane_valid, cfg.planar)
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

        # pressureP family: the receiver's pressure only, and no structure
        # rule (phase 2 has one, the virial does not)
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

        # viscosity, half-weighted; mu_h = 0 unless the inverse sum is
        # finite and positive
        if cfg.uniform_radii:
            m_v, omq_v = m_p, omq_p
        else:
            m_v = m & (rv2 - rij2 > 0)
            omq_v = 1.0 - rij * inv_rv
        vi = frame.vel[r0:r1].view(nb, -1, 1, 3)
        vj = frame.vel[idx][:, None, :, :]
        udote = sum((vj[..., a] - vi[..., a]) * eij[a]
                    for a in range(len(xij)))
        inv_sum = invmu[r0:r1].view(nb, -1, 1) + invmu[idx][:, None, :]
        live = torch.isfinite(inv_sum) & (inv_sum > 0)
        mu_h = torch.where(
            live, 2.0 / torch.where(live, inv_sum, torch.ones_like(inv_sum)),
            zero)
        dwv = dwv_coef * omq_v
        visc = c_v * mu_h * udote * (-dwv) * inv_r * volume
        coeff = coeff + 0.5 * torch.where(m_v, visc, zero)

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


def _virial_sweep_cuda(frame, pp, pa, gc, invmu, win_start, win_len, offs, ks,
                       cfg, tables, volume, two_dimensional):
    _check_frame(frame, win_start, win_len, len(offs), cfg.block)
    n = frame.pos.shape[0]
    dtype, dev = frame.pos.dtype, frame.pos.device
    _check_tensor("pressure_p", pp, (n,), dtype, dev)
    _check_tensor("invmu", invmu, (n,), dtype, dev)
    if cfg.surface_tension:
        _check_tensor("pressure_a", pa, (n,), dtype, dev)
        _check_tensor("gravity_center", gc, (n, 3), dtype, dev)
    lib = cuda_loader.load()
    consts = _phase2_consts(ks, volume, two_dimensional)
    if len(consts) != lib.fsi_virial_nconst():
        raise RuntimeError("virial_sweep: constant table out of step with csrc")
    out = torch.empty((9, n), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fsi_virial_sweep(
            int(dtype == torch.float64),
            frame.pos.data_ptr(), frame.vel.data_ptr(), frame.key.data_ptr(),
            frame.prop.data_ptr(), pp.data_ptr(),
            pa.data_ptr() if cfg.surface_tension else None,
            gc.data_ptr() if cfg.surface_tension else None,
            invmu.data_ptr(), win_start.data_ptr(), win_len.data_ptr(),
            out.data_ptr(), n, cfg.block, len(offs), _c_ints(offs),
            _c_doubles(consts), _c_doubles(tables.interaction_ratio_host),
            _c_doubles(tables.cof_a_host), int(cfg.planar),
            int(cfg.surface_tension), int(cfg.uniform_ratio),
            int(cfg.uniform_radii), stream)
    _raise_on(err, "virial_sweep")
    launch_counts["virial_sweep"] += 1
    return out


def virial_sweep(frame: SortedFrame, pp, pa, gc, invmu, win_start, win_len,
                 offs, ks: KernelSet, cfg: WindowConfig, tables: TypeTables, *,
                 volume: float, two_dimensional: bool):
    """Raw virial sums per receiver, ``[9, N]`` in sorted order.

    A CUDA frame goes through the hand-written kernel
    (``csrc/virial_sweep.cu``, replacing the TPU ``_virial_kernel_t``) or the
    call raises; only a CPU frame takes :func:`virial_sweep_plain`."""
    if frame.pos.is_cuda:
        return _virial_sweep_cuda(frame, pp, pa, gc, invmu, win_start,
                                  win_len, offs, ks, cfg, tables, volume,
                                  two_dimensional)
    return virial_sweep_plain(frame, pp, pa, gc, invmu, win_start, win_len,
                              offs, ks, cfg, tables, volume=volume,
                              two_dimensional=two_dimensional)


def virial_t(frame: SortedFrame, fields: dict, grid: CellGrid, ks: KernelSet,
             tables: TypeTables, *, volume: float, two_dimensional: bool,
             cfg: WindowConfig, windows=None):
    """Virial stress at every particle (the JAX ``virial_pallas_t``):
    ``(virial_stress [9, N] row-major components, virial_pressure [N])`` in
    sorted order.  ``fields`` is the dict of :func:`phase1_fields_t` for the
    same frame."""
    win_start, win_len = windows if windows is not None else compute_windows(
        frame, grid, cfg)
    offs, _ = row_offsets(grid)
    gc = fields["gravity_center"]
    if cfg.surface_tension:
        gc = gc.contiguous()
    out = virial_sweep(
        frame, fields["pressure_p"], fields["pressure_a"], gc,
        inverse_viscosity(fields["mu"]), win_start, win_len, offs, ks, cfg,
        tables, volume=volume, two_dimensional=two_dimensional)
    stress = out / volume
    d = 2.0 if two_dimensional else 3.0
    tr = stress[0] + stress[4]
    if not two_dimensional:
        tr = tr + stress[8]
    return stress, -tr / d
