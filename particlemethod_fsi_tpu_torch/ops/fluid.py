"""Per-type property tables and role predicates of the fluid ops.

Counterpart of ``particlemethod_fsi_tpu/ops/fluid.py``.  Ported:
:class:`TypeTables` and :func:`is_structure`.  The per-particle EOS lives in
the tail of :func:`particlemethod_fsi_tpu_torch.ops.windows_t.phase1_fields_t`
(as in the JAX window backend); the gathered ``PairContext`` of the portable
gather engine is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from particlemethod_fsi_tpu_torch.config import STRUCTURE_BEGIN, STRUCTURE_END
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
