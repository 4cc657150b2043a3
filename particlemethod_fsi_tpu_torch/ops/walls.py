"""Rigid-wall kinematics, the periodic boundary and the scripted velocity
profiles.

Counterpart of ``particlemethod_fsi_tpu/ops/walls.py``, all of it:
:func:`wall_rotation_matrices`, :func:`wall_tables`,
:func:`apply_wall_motion` (prescribed rigid motion with the freeze, and the
harmonic ``Rolling`` variant), :func:`periodic_wrap`,
:func:`bar_initial_velocity` and :func:`turek_inlet_velocity`.  The
reference's quirks are kept as the JAX package keeps them: the per-step
rotation's ``theta = |omega|^2`` and the Rolling branch's ``dtheta`` from
two sines.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from particlemethod_fsi_tpu_torch.config import (
    TYPE_COUNT,
    WALL_BEGIN,
    WALL_END,
    CaseConfig,
    SceneConfig,
    bar_mode_shape,
)
from particlemethod_fsi_tpu_torch.ops.fluid import is_structure


def is_wall(prop):
    return (prop >= WALL_BEGIN) & (prop < WALL_END)


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


# steps that moved the walls (one an ``apply_wall_motion`` call, on any
# device and any path); a scene whose walls are static never calls it
launch_counts = {"wall_motion": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def apply_wall_motion(
    pos, vel, prop, wall_center, time, *, wall_velocity, wall_omega,
    wall_rotation, dt: float, scene: SceneConfig, freeze: bool,
):
    """Prescribed rigid wall motion for one step (calculateWall,
    src/main.cpp:3031-3071; the Rolling path :2974-3029).  ``time`` is the
    state's 0-d tensor.  Returns ``(pos, vel, new_wall_center)``; the
    centres advect every step, frozen or not (src/main.cpp:3066-3070).
    Counted in :data:`launch_counts`."""
    launch_counts["wall_motion"] += 1
    wmask = is_wall(prop)
    p = torch.clamp(prop, 0, TYPE_COUNT - 1).long()
    center = wall_center[p]
    r = pos - center
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]

    if scene.rolling is not None:
        # harmonic rocking about z through the wall centre
        # (src/main.cpp:2974-3019)
        max_angle = scene.rolling.max_angle_deg * math.pi / 180.0
        omega_t = 2.0 * math.pi / scene.rolling.period
        theta = max_angle * torch.sin(omega_t * time)
        theta_prev = max_angle * torch.sin(omega_t * (time - dt))
        dtheta = theta - theta_prev
        dtheta_dt = max_angle * omega_t * torch.cos(omega_t * time)
        c, s = torch.cos(dtheta), torch.sin(dtheta)
        r_rot = torch.stack([c * rx - s * ry, s * rx + c * ry, rz], dim=1)
        new_vel = torch.stack([-dtheta_dt * r_rot[:, 1],
                               dtheta_dt * r_rot[:, 0],
                               torch.zeros_like(r_rot[:, 2])], dim=1)
        new_pos = r_rot + center
        apply = wmask[:, None]
    else:
        wvel = wall_velocity[p]
        womg = wall_omega[p]
        # the per-type rotation as nine lane products
        rc = [wall_rotation[:, i, j][p] for i in range(3) for j in range(3)]
        r_rot = torch.stack([rc[0] * rx + rc[1] * ry + rc[2] * rz,
                             rc[3] * rx + rc[4] * ry + rc[5] * rz,
                             rc[6] * rx + rc[7] * ry + rc[8] * rz], dim=1)
        # omega x r, component by component as jnp.cross computes it
        new_vel = torch.stack([
            womg[:, 1] * r_rot[:, 2] - womg[:, 2] * r_rot[:, 1],
            womg[:, 2] * r_rot[:, 0] - womg[:, 0] * r_rot[:, 2],
            womg[:, 0] * r_rot[:, 1] - womg[:, 1] * r_rot[:, 0]],
            dim=1) + wvel
        new_pos = r_rot + center + wvel * dt
        apply = wmask[:, None]
        if freeze:
            apply = apply & (time < scene.wall_motion_end_time)

    pos = torch.where(apply, new_pos, pos)
    vel = torch.where(apply, new_vel, vel)
    return pos, vel, wall_center + wall_velocity * dt


def periodic_wrap(pos: torch.Tensor, domain_min, domain_width) -> torch.Tensor:
    """pos <- Mod(pos - min, W) + min, every particle/axis
    (calculatePeriodicBoundary, src/main.cpp:3322-3333)."""
    dmin = torch.as_tensor(domain_min, dtype=pos.dtype, device=pos.device)
    w = torch.as_tensor(domain_width, dtype=pos.dtype, device=pos.device)
    rel = pos - dmin
    return rel - w * torch.floor(rel / w) + dmin


def bar_initial_velocity(pos0, vel, prop, scene: SceneConfig, density_table):
    """Bar_Module first-bending-mode velocity profile
    (setInitialVelocityProfile, src/main.cpp:395-416): v_y =
    amplitude * c0 * f(x0) / f(L) on structure particles, with
    c0 = sqrt(K / rho)."""
    s = is_structure(prop)
    p = torch.clamp(prop, 0, TYPE_COUNT - 1).long()
    rho = density_table[p]
    c0 = torch.sqrt(scene.bar_bulk_modulus
                    / torch.where(rho > 0, rho, torch.ones_like(rho)))
    k = scene.bar_kl / scene.bar_length
    kx = k * pos0[:, 0]
    kl = scene.bar_kl
    term1 = (math.cos(kl) + math.cosh(kl)) * (torch.cosh(kx) - torch.cos(kx))
    term2 = (math.sin(kl) - math.sinh(kl)) * (torch.sinh(kx) - torch.sin(kx))
    fx = term1 + term2
    fl = bar_mode_shape(scene.bar_length, kl, scene.bar_length)
    vy = scene.bar_amplitude * c0 * fx / fl
    zero = torch.zeros_like(vy)
    return torch.where(s[:, None], torch.stack([zero, vy, zero], dim=1), vel)


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
