"""Rigid-wall kinematics tables and the periodic boundary.

Counterpart of ``particlemethod_fsi_tpu/ops/walls.py``.  Ported:
:func:`wall_rotation_matrices`, :func:`wall_tables` (enough for the solver's
static-wall test), :func:`periodic_wrap` and :func:`turek_inlet_velocity`.
Prescribed wall motion (``apply_wall_motion``, with the ``Rolling`` variant)
and the Bar first-mode velocity profile are not ported yet; the solver
raises for scenes that need them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from particlemethod_fsi_tpu_torch.config import TYPE_COUNT, CaseConfig, SceneConfig


def wall_rotation_matrices(cfg: CaseConfig) -> np.ndarray:
    """Per-type per-step rotation matrices (initializeWall,
    src/main.cpp:1374-1408), including the theta = |omega|^2 quirk."""
    out = np.zeros((TYPE_COUNT, 3, 3), dtype=np.float64)
    for t in range(TYPE_COUNT):
        w = np.asarray(cfg.walls[t].omega, dtype=np.float64)
        theta = abs(float(np.dot(w, w)))  # squared norm (src/main.cpp:1382)
        normal = w / theta if theta != 0.0 else np.zeros(3)
        half = theta * cfg.dt / 2.0
        q = np.array([*(normal * math.sin(half)), math.cos(half)])
        x, y, z, s = q
        out[t] = [
            [x * x - y * y - z * z + s * s, 2 * (x * y - z * s), 2 * (x * z + y * s)],
            [2 * (x * y + z * s), -x * x + y * y - z * z + s * s, 2 * (y * z - x * s)],
            [2 * (x * z - y * s), 2 * (y * z + x * s), -x * x - y * y + z * z + s * s],
        ]
    return out


def wall_tables(cfg: CaseConfig, dtype: torch.dtype, device="cpu"):
    """Static per-type wall kinematics tensors."""
    def f(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
            device=device, dtype=dtype)

    center0 = f([w.center for w in cfg.walls])
    velocity = f([w.velocity for w in cfg.walls])
    omega = f([w.omega for w in cfg.walls])
    rotation = f(wall_rotation_matrices(cfg))
    return center0, velocity, omega, rotation


def periodic_wrap(pos: torch.Tensor, domain_min, domain_width) -> torch.Tensor:
    """pos <- Mod(pos - min, W) + min, every particle/axis
    (calculatePeriodicBoundary, src/main.cpp:3322-3333)."""
    dmin = torch.as_tensor(domain_min, dtype=pos.dtype, device=pos.device)
    w = torch.as_tensor(domain_width, dtype=pos.dtype, device=pos.device)
    rel = pos - dmin
    return rel - w * torch.floor(rel / w) + dmin


def turek_inlet_velocity(pos, vel, prop, time, scene: SceneConfig):
    """Turek-Hron parabolic inlet re-imposed every step on fluid particles
    (src/main.cpp:419-438): 1.5x-peak profile at x <= 0.01, plain profile at
    x > 1.5 while t < turek_outlet_until."""
    fluid = (prop >= 0) & (prop < 2)
    h = scene.turek_ymax - scene.turek_ymin
    uy = pos[:, 1] - scene.turek_ymin
    u_inlet = (1.5 * 4.0 * scene.turek_umax / (h * h)) * uy * (h - uy)
    u_outlet = (4.0 * scene.turek_umax / (h * h)) * uy * (h - uy)
    zero = torch.zeros_like(u_inlet)
    inlet = fluid & (pos[:, 0] <= 0.01)
    outlet = fluid & (pos[:, 0] > 1.5) & (time < scene.turek_outlet_until)
    vel = torch.where(inlet[:, None], torch.stack([u_inlet, zero, zero], 1),
                      vel)
    return torch.where(outlet[:, None],
                       torch.stack([u_outlet, zero, zero], 1), vel)
