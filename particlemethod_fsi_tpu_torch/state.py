"""Particle state as a tuple of torch tensors.

Counterpart of ``particlemethod_fsi_tpu/state.py``.  The dynamic simulation
state is one :class:`ParticleState` of fixed-shape tensors on one device,
padded to ``n_pad`` slots (a multiple of 256, as in the JAX package, so that
frames and window tables have the same shapes in both); padding slots carry
``prop = -1`` and are masked out of every op.  Role segmentation (fluid /
structure / wall, src/main.cpp:68-74, 909-944) is boolean masks over the
property id, so particle order never matters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from particlemethod_fsi_tpu_torch.config import (
    FLUID_BEGIN,
    FLUID_END,
    STRUCTURE_BEGIN,
    STRUCTURE_END,
    TYPE_COUNT,
    WALL_BEGIN,
    WALL_END,
)

PAD_PROP = -1  # property id of padding slots


class ParticleState(NamedTuple):
    """Dynamic per-step state.  All tensors padded to [n_pad(,3)]."""

    prop: torch.Tensor  # [N] int32, PAD_PROP on padding
    pos: torch.Tensor  # [N,3]
    pos0: torch.Tensor  # [N,3] initial (reference-configuration) positions
    vel: torch.Tensor  # [N,3]
    wall_center: torch.Tensor  # [TYPE_COUNT,3] rigid-wall centers
    time: torch.Tensor  # scalar
    # ghost-strip capacity overflow, max-accumulated over a chunk's steps
    ghost_overflow: torch.Tensor  # scalar int32

    @property
    def n_pad(self) -> int:
        return self.prop.shape[0]

    def replace(self, **kw) -> "ParticleState":
        return self._replace(**kw)


class Segments:
    """Role masks computed from the property array (numpy or tensor)."""

    def __init__(self, prop):
        self.valid = prop >= 0
        self.fluid = (prop >= FLUID_BEGIN) & (prop < FLUID_END)
        self.structure = (prop >= STRUCTURE_BEGIN) & (prop < STRUCTURE_END)
        self.wall = (prop >= WALL_BEGIN) & (prop < WALL_END)


def default_pad(n: int, multiple: int = 256) -> int:
    """Round particle count up to a multiple of 256 (at least one)."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def make_state(
    prop: np.ndarray,
    position: np.ndarray,
    initial_position: np.ndarray,
    velocity: np.ndarray,
    *,
    time: float = 0.0,
    wall_center: Optional[np.ndarray] = None,
    n_pad: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> ParticleState:
    n = prop.shape[0]
    n_pad = default_pad(n) if n_pad is None else n_pad
    if n_pad < n:
        raise ValueError(f"n_pad={n_pad} < particle count {n}")

    def pad_vec(a):
        out = np.zeros((n_pad, 3), dtype=np.float64)
        out[:n] = a
        return torch.as_tensor(out).to(device=device, dtype=dtype)

    prop_p = np.full((n_pad,), PAD_PROP, dtype=np.int32)
    prop_p[:n] = prop
    wc = np.zeros((TYPE_COUNT, 3)) if wall_center is None else np.asarray(wall_center)
    return ParticleState(
        prop=torch.as_tensor(prop_p).to(device),
        pos=pad_vec(position),
        pos0=pad_vec(initial_position),
        vel=pad_vec(velocity),
        wall_center=torch.as_tensor(wc).to(device=device, dtype=dtype),
        time=torch.tensor(time, dtype=dtype, device=device),
        ghost_overflow=torch.zeros((), dtype=torch.int32, device=device),
    )


def to_numpy(state: ParticleState, n: Optional[int] = None) -> dict:
    """Device -> host, trimmed to the live particle count."""
    out = {k: getattr(state, k).detach().cpu().numpy()
           for k in ("prop", "pos", "pos0", "vel", "wall_center")}
    out["time"] = float(state.time)
    if n is not None:
        for k in ("prop", "pos", "pos0", "vel"):
            out[k] = out[k][:n]
    return out
