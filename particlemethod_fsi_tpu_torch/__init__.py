"""PyTorch/CUDA port of the particle-method FSI solver, for an NVIDIA H100.

A second package beside ``particlemethod_fsi_tpu`` (the JAX package, which
stays the reference) with the same layout, so that the counterpart of a
module is found under the same name; every module's docstring names it.
This package imports ``torch`` and never ``jax`` nor anything of the JAX
package.  Ported so far: the one-device path of the coupled 2-D step on both
window sweeps -- the field-major ``pallas_t`` (C8 frame reuse) and the
row-major ``pallas`` (a fresh frame every step; also taken by frames of
2^24 cells or more) -- with sorted frame, window tables, EOS, elastic solid
and divergence-guarded chunk; phase 1, phase 2 and the virial of each
backend as hand-written CUDA kernels under ``csrc/``; the output-time
diagnostics; the file formats, the generator and the command line
(``python -m particlemethod_fsi_tpu_torch.cli``); the bench scene; the
multi-device all-gather and 1-D slab halo modes over ``torch.distributed``
(``parallel/``, ``--mesh``); and the packed-bf16 throughput probe
(``tools/bf16_microbench.py``).  Entry points
run on the GPU unless the caller passes ``device="cpu"`` (``--device cpu`` on
the command line).
"""

from particlemethod_fsi_tpu_torch.config import (
    CaseConfig,
    CompatFlags,
    NumericsConfig,
    SceneConfig,
    WallMotion,
)
from particlemethod_fsi_tpu_torch.solver import Simulation
from particlemethod_fsi_tpu_torch.state import ParticleState, Segments

__version__ = "0.1.0"

__all__ = [
    "CaseConfig",
    "CompatFlags",
    "NumericsConfig",
    "SceneConfig",
    "WallMotion",
    "ParticleState",
    "Segments",
    "Simulation",
]
