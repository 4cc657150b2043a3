"""Host-side particle snapshot container.

Counterpart of ``particlemethod_fsi_tpu/io/grid_file.py``.  Only the
:class:`GridData` container is here; reading and writing ``.grid`` / ``.prof``
files is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GridData:
    """Host-side particle snapshot (numpy, float64)."""

    time: float
    spacing: float
    domain_min: np.ndarray  # [3]
    domain_max: np.ndarray  # [3]
    prop: np.ndarray  # [N] int32
    position: np.ndarray  # [N,3]
    initial_position: np.ndarray  # [N,3]
    velocity: np.ndarray  # [N,3]

    @property
    def n(self) -> int:
        return int(self.prop.shape[0])

    def particle_volume(self, two_dimensional: bool) -> float:
        """ParticleVolume = spacing^d (src/main.cpp:805-809)."""
        d = 2 if two_dimensional else 3
        return float(self.spacing) ** d
