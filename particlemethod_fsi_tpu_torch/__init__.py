"""PyTorch/CUDA port of the particle-method FSI solver, for an NVIDIA H100.

A second package beside ``particlemethod_fsi_tpu`` (the JAX package, which
stays the reference) with the same layout, so that the counterpart of a
module is found under the same name; every module's docstring names it.
This package imports ``torch`` and never ``jax`` nor anything of the JAX
package.  Ported so far: the one-device window-sweep path of the coupled
2-D step (sorted frame, window tables, phase-1 and phase-2 sweeps as
hand-written CUDA kernels under ``csrc/``, EOS, elastic solid, C8 frame
reuse, divergence-guarded chunk), the output-time diagnostics with the
virial sweep (a third CUDA kernel), the file formats, the generator and the
command line (``python -m particlemethod_fsi_tpu_torch.cli``), and the bench
scene.  Entry points run on the GPU unless the caller passes
``device="cpu"`` (``--device cpu`` on the command line).
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
