"""Per-type property tables and role predicates of the fluid ops.

Counterpart of ``particlemethod_fsi_tpu/ops/fluid.py``, all of it:
:class:`TypeTables`, :func:`is_structure`, the gather engine's
:class:`PairContext` / :func:`make_pair_context`, and the per-particle
coefficient and EOS updates (:func:`physical_coefficients`,
:func:`pressure_p`, :func:`pressure_a`) that the gather engine applies
between its two phases.  The window sweeps and the packed engine apply the
same EOS in their own phase-1 tails, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from particlemethod_fsi_tpu_torch.config import (
    STRUCTURE_BEGIN, STRUCTURE_END, TYPE_COUNT)
from particlemethod_fsi_tpu_torch.ops.neighbors import NeighborList, min_image
from particlemethod_fsi_tpu_torch.ops.smoothing import KernelSet


class TypeTables(NamedTuple):
    """Per-type property tables as tensors (src/main.cpp:140-148,180-181)."""

    density: torch.Tensor  # [6]
    bulk_modulus: torch.Tensor
    bulk_viscosity: torch.Tensor
    shear_viscosity: torch.Tensor
    young_modulus: torch.Tensor
    poisson_ratio: torch.Tensor
    cof_a: torch.Tensor  # [6] calibrated surface-tension coefficient
    interaction_ratio: torch.Tensor  # [6,6]
    # float64 host copies (row-major 36 / 6 Python floats) of the two tables
    # the CUDA kernels take as launch parameters, so that a launch never
    # reads a device tensor back
    interaction_ratio_host: tuple
    cof_a_host: tuple

    @classmethod
    def from_config(cls, cfg, kernels: KernelSet, dtype: torch.dtype,
                    device="cpu"):
        def f(x):
            return torch.tensor(x, dtype=torch.float64).to(
                device=device, dtype=dtype)

        return cls(
            density=f(cfg.density),
            bulk_modulus=f(cfg.bulk_modulus),
            bulk_viscosity=f(cfg.bulk_viscosity),
            shear_viscosity=f(cfg.shear_viscosity),
            young_modulus=f(cfg.young_modulus),
            poisson_ratio=f(cfg.poisson_ratio),
            cof_a=f(kernels.cof_a),
            interaction_ratio=f(cfg.interaction_ratio),
            interaction_ratio_host=tuple(
                float(r) for row in cfg.interaction_ratio for r in row),
            cof_a_host=tuple(float(c) for c in kernels.cof_a),
        )


def is_structure(prop):
    return (prop >= STRUCTURE_BEGIN) & (prop < STRUCTURE_END)


class PairContext(NamedTuple):
    """Shared per-edge geometry for one neighbor-list phase."""

    j: torch.Tensor  # [N,K] neighbor indices (0 where invalid)
    mask: torch.Tensor  # [N,K]
    xij: torch.Tensor  # [N,K,3] min-image x_j - x_i
    rij2: torch.Tensor  # [N,K]
    rij: torch.Tensor  # [N,K] (1 where invalid -- safe for division)
    eij: torch.Tensor  # [N,K,3] unit vector (0 where invalid)
    prop_i: torch.Tensor  # [N] (clipped to valid range)
    prop_j: torch.Tensor  # [N,K]
    ratio_ij: torch.Tensor  # [N,K] InteractionRatio[prop_i][prop_j]
    ratio_ji: torch.Tensor  # [N,K] InteractionRatio[prop_j][prop_i]


def _type_index(prop: torch.Tensor) -> torch.Tensor:
    return torch.clamp(prop, 0, TYPE_COUNT - 1).long()


def make_pair_context(pos: torch.Tensor, prop: torch.Tensor,
                      nbr: NeighborList, domain_width,
                      tables: TypeTables) -> PairContext:
    j = nbr.idx
    mask = nbr.mask
    xij = min_image(pos[j] - pos[:, None, :], domain_width)
    xij = torch.where(mask[..., None], xij,
                      torch.zeros((), dtype=xij.dtype, device=xij.device))
    rij2 = torch.sum(xij * xij, dim=-1)
    rij = torch.sqrt(torch.where(mask & (rij2 > 0), rij2,
                                 torch.ones_like(rij2)))
    eij = xij / rij[..., None]
    prop_i = _type_index(prop)
    prop_j = prop_i[j]
    ratio_ij = tables.interaction_ratio[prop_i[:, None], prop_j]
    ratio_ji = tables.interaction_ratio[prop_j, prop_i[:, None]]
    return PairContext(
        j=j, mask=mask, xij=xij, rij2=rij2, rij=rij, eij=eij,
        prop_i=prop_i, prop_j=prop_j, ratio_ij=ratio_ij, ratio_ji=ratio_ji,
    )


def physical_coefficients(prop, vol_strain, tables: TypeTables):
    """Per-particle kappa (with unilateral clamp), lambda, mu
    (calculatePhysicalCoefficients, src/main.cpp:2099-2137)."""
    p = _type_index(prop)
    kappa = torch.where(vol_strain < 0.0, torch.zeros_like(vol_strain),
                        tables.bulk_modulus[p])
    return kappa, tables.bulk_viscosity[p], tables.shear_viscosity[p]


def pressure_p(vol_strain, divergence, kappa, lam):
    """Base pressure EOS: P = -Lambda*div + [volstrain>0] kappa*volstrain
    (calculatePressureP first loop, src/main.cpp:2387-2392; also duplicated in
    calculateInterfaceForce, :2432-2437)."""
    return -lam * divergence + torch.where(
        vol_strain > 0.0, kappa * vol_strain, torch.zeros_like(vol_strain))


def pressure_a(density_a_arr, ks: KernelSet, prop, tables: TypeTables):
    """Attractive pressure, clamped to attraction only
    (calculatePressureA first loop, src/main.cpp:2218-2223)."""
    pa = tables.cof_a[_type_index(prop)] * (density_a_arr - ks.n0a) / ks.spacing
    return torch.where(density_a_arr >= ks.n0a, torch.zeros_like(pa), pa)
