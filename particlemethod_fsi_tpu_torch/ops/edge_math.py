"""Per-edge physics formulas shared by the two candidate engines.

Counterpart of ``particlemethod_fsi_tpu/ops/edge_math.py``, all of it.  The
``packed`` engine (``ops/packed_engine``) and the ``gather`` engine (the
solver's ``_fluid_phase`` over ``ops/neighbors.build_neighbor_list``) gather
their edge operands their own way and evaluate the same formulas here, as in
the JAX package (src/main.cpp:2141-2522).

Edge quantities keep the JAX layout: scalars per edge ``[R, M]`` (the edge
axis last), vectors per edge ``[3, R, M]`` and per receiver ``[3, R]`` (the
component axis first).  In the JAX package that is a TPU tiling rule; here
it only keeps each vector component a contiguous ``[R, M]`` block, so that a
component is one elementwise op.

``valid`` masks padded and out-of-radius edges; every formula is written so
that masked edges contribute exactly zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from particlemethod_fsi_tpu_torch.ops.smoothing import KernelSet


class EdgeGeometry(NamedTuple):
    """Minimum-image edge geometry, component-major."""

    xij: torch.Tensor  # [3, R, M] x_j - x_i
    rij2: torch.Tensor  # [R, M]
    rij: torch.Tensor  # [R, M], 1 where invalid (division-safe)
    eij: torch.Tensor  # [3, R, M] unit vector, 0 where invalid
    valid: torch.Tensor  # [R, M] bool


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def make_geometry(xij: torch.Tensor, valid: torch.Tensor) -> EdgeGeometry:
    """xij: [3, R, M] raw (already min-imaged) separations."""
    zero = _zero(xij)
    xij = torch.where(valid[None], xij, zero)
    rij2 = torch.sum(xij * xij, dim=0)
    ok = valid & (rij2 > 0)
    rij = torch.sqrt(torch.where(ok, rij2, torch.ones_like(rij2)))
    eij = torch.where(ok[None], xij / rij[None], zero)
    return EdgeGeometry(xij=xij, rij2=rij2, rij=rij, eij=eij, valid=valid)


def _within(g: EdgeGeometry, radius: float, *, strict: bool) -> torch.Tensor:
    """The reference's call-site radius guards: `radius^2 - rij2 >= 0` for
    density sums, `> 0` for force sums (e.g. src/main.cpp:2162 vs 2243)."""
    d = radius * radius - g.rij2
    return g.valid & ((d > 0) if strict else (d >= 0))


# --------------------------------------------------------------------------
# phase 1: densities / field sums (calculateDensityA/GravityCenter/DensityP/
# DivergenceP, src/main.cpp:2141-2379)
# --------------------------------------------------------------------------


def phase1_sums(g: EdgeGeometry, ks: KernelSet, *, vel_i, vel_j, ratio_ij):
    """Edge reductions for all four density-type fields in one pass.

    vel_i: [3, R] receiver velocities; vel_j: [3, R, M].
    Returns (density_a [R], gravity_center [3, R], wp_sum [R],
    divergence [R]).  Receiver-side masking (structure receivers get zero
    density_a / gravity_center) is applied by the caller.
    """
    zero = _zero(g.rij)
    m_a = _within(g, ks.radius_a, strict=False)
    density_a = torch.sum(torch.where(m_a, ratio_ij * ks.wa(g.rij), zero),
                          dim=-1)

    m_g = _within(g, ks.radius_g, strict=False)
    w_gc = torch.where(m_g, ratio_ij * ks.wg(g.rij) / ks.r2g * ks.radius_g,
                       zero)
    gravity_center = torch.sum(g.xij * w_gc[None], dim=-1)  # [3, R]

    m_p = _within(g, ks.radius_p, strict=False)
    wp_sum = torch.sum(torch.where(m_p, ks.wp(g.rij), zero), dim=-1)

    uij = vel_j - vel_i[:, :, None]  # [3, R, M]
    udote = torch.sum(uij * g.eij, dim=0)  # [R, M]
    divergence = -torch.sum(torch.where(m_p, udote * ks.dwpdr(g.rij), zero),
                            dim=-1)
    return density_a, gravity_center, wp_sum, divergence


# --------------------------------------------------------------------------
# phase 2: pairwise forces (src/main.cpp:2212-2522 + 2427-2473)
# --------------------------------------------------------------------------


def phase2_force(
    g: EdgeGeometry,
    ks: KernelSet,
    *,
    volume: float,
    two_dimensional: bool,
    receiver_is_structure,  # [R] bool
    sender_is_structure,  # [R, M] bool
    pp_i, pp_j,  # [R] / [R, M]
    pa_i, pa_j,
    gc_i, gc_j,  # [3, R] / [3, R, M]
    mu_i, mu_j,
    vel_i, vel_j,  # [3, R] / [3, R, M]
    ratio_ij, ratio_ji,  # [R, M]
    cof_a_i,  # [R] CofA[prop_i]
):
    """Total per-receiver pairwise force [3, R]: pressureP + pressureA +
    diffuse interface + viscosity on non-structure receivers, plus the FSI
    interface load on structure receivers.  One fused edge pass."""
    zero = _zero(g.rij)
    rs = receiver_is_structure[:, None]  # [R, 1]

    # pressureP force (calculatePressureP 2nd loop, :2394-2424)
    m_p = _within(g, ks.radius_p, strict=True)
    coeff_pp = (pp_i[:, None] + pp_j) * ks.dwpdr(g.rij) * volume
    f_pp = torch.where(m_p & ~rs, coeff_pp, zero)

    # FSI interface load (calculateInterfaceForce, :2439-2472): structure
    # receivers over NON-structure senders, same (Pi+Pj) grad wp V kernel
    f_if = torch.where(m_p & rs & ~sender_is_structure, coeff_pp, zero)

    # pressureA force (:2225-2258)
    m_a = _within(g, ks.radius_a, strict=True)
    coeff_pa = ((pa_i[:, None] * ratio_ij + pa_j * ratio_ji)
                * ks.dwadr(g.rij) * volume)
    f_pa = torch.where(m_a & ~rs, coeff_pa, zero)

    # viscosity (:2478-2522)
    m_v = _within(g, ks.radius_v, strict=True)
    c_v = 8.0 if two_dimensional else 10.0
    uij = vel_j - vel_i[:, :, None]
    udote = torch.sum(uij * g.eij, dim=0)
    mu_den = mu_i[:, None] + mu_j
    pos_den = mu_den > 0
    mu_h = torch.where(
        pos_den, 2.0 * mu_i[:, None] * mu_j
        / torch.where(pos_den, mu_den, torch.ones_like(mu_den)), zero)
    coeff_v = c_v * mu_h * udote * (-ks.dwvdr(g.rij)) / g.rij * volume
    f_v = torch.where(m_v & ~rs, coeff_v, zero)

    # radial contributions accumulate on eij
    radial = (f_pp + f_if + f_pa + f_v)[None] * g.eij  # [3, R, M]

    # diffuse interface, two terms (:2261-2312); note both a_i and a_j use
    # CofA[prop_i] in the reference (:2270, :2275)
    m_g = _within(g, ks.radius_g, strict=True)
    a_i = (cof_a_i * ks.cof_k * ks.cof_k)[:, None]  # [R, 1]
    scale = 1.0 / ks.r2g * ks.radius_g * (volume / ks.spacing)
    w_g = ks.wg(g.rij)
    wij = ratio_ij * w_g
    wji = ratio_ji * w_g
    gc_diff_w = gc_j * wji[None] - gc_i[:, :, None] * wij[None]  # [3, R, M]
    term1 = a_i[None] * gc_diff_w * scale
    dw_g = ks.dwgdr(g.rij)
    dwij = ratio_ij * dw_g
    dwji = ratio_ji * dw_g
    gc_diff_dw = gc_j * dwji[None] - gc_i[:, :, None] * dwij[None]
    gr = torch.sum(a_i[None] * gc_diff_dw * g.xij, dim=0)  # [R, M]
    term2 = gr[None] * g.eij * scale
    f_di = -torch.where((m_g & ~rs)[None], term1 + term2, zero)

    return torch.sum(radial + f_di, dim=-1)  # [3, R]
