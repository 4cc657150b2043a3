"""The one traffic generator: a cell's mix file gives the parameters, the
seed draws the inputs.

Traffic comes in episodes: ``episode_steps`` steps from the same start
state, in chunks of ``chunk_steps`` (one output interval each).  Every seed
runs the same schedule on the same scene; it draws only a small smooth
perturbation of the fluid's initial velocities, a sum of ``modes``
divergence-free Fourier modes of the box with random wave vectors (up to
``max_wavenumber`` periods across each axis), directions and phases,
scaled so that no particle is pushed faster than ``perturbation_m_s``.
The mode parameters come from a CPU generator, so a seed gives the same
inputs on any device."""

from __future__ import annotations

import math

import numpy as np
import torch


def modes_field(seed: int, pos: torch.Tensor, width, dim: int, modes: int,
                max_wavenumber: int) -> torch.Tensor:
    """The seed's sum of divergence-free modes at ``pos`` ([N, 3], zero in
    z in 2-D), unscaled."""
    gen = torch.Generator().manual_seed(int(seed))
    waves = torch.randint(1, max_wavenumber + 1, (modes, dim), generator=gen)
    signs = torch.randint(0, 2, (modes, dim), generator=gen) * 2 - 1
    dirs = torch.randn((modes, dim), generator=gen, dtype=torch.float64)
    phases = torch.rand(modes, generator=gen, dtype=torch.float64)
    out = torch.zeros_like(pos)
    for m in range(modes):
        k = (waves[m] * signs[m]).double().numpy() * 2 * math.pi / np.asarray(
            width[:dim])
        e = dirs[m].numpy()
        e = e - k * (e @ k) / (k @ k)  # across the wave: no divergence
        e = e / np.linalg.norm(e)
        arg = pos[:, :dim] @ torch.as_tensor(k, dtype=pos.dtype,
                                             device=pos.device)
        amp = torch.sin(arg + 2 * math.pi * float(phases[m]))
        out[:, :dim] += amp[:, None] * torch.as_tensor(
            e, dtype=pos.dtype, device=pos.device)
    return out


def perturbation(seed: int, pos: torch.Tensor, fluid: torch.Tensor,
                 width, dim: int, amplitude: float, modes: int,
                 max_wavenumber: int) -> torch.Tensor:
    """The seed's velocity perturbation ([N, 3], float64, zero off the
    fluid and in z in 2-D): the modes on the fluid, scaled so that the
    fastest particle moves at ``amplitude``."""
    out = modes_field(seed, pos, width, dim, modes, max_wavenumber)
    out = torch.where(fluid[:, None], out, torch.zeros_like(out))
    peak = float(out.norm(dim=1).max())
    return out * (amplitude / peak) if peak > 0 else out


def start_state(scene: dict, mix: dict, seed: int, dim: int, width,
                device) -> tuple:
    """The seed's start state: positions and velocities ([N, 3], float64,
    on ``device``)."""
    pos = torch.as_tensor(scene["pos"], dtype=torch.float64, device=device)
    vel = torch.as_tensor(scene["vel"], dtype=torch.float64, device=device)
    prop = torch.as_tensor(scene["prop"], device=device)
    fluid = (prop >= 0) & (prop < 2)
    vel = vel + perturbation(seed, pos, fluid, width, dim,
                             mix["perturbation_m_s"], mix["modes"],
                             mix["max_wavenumber"])
    return pos, vel


def chunks_per_episode(mix: dict) -> int:
    if mix["episode_steps"] % mix["chunk_steps"]:
        raise ValueError("episode_steps is not a whole number of chunks")
    return mix["episode_steps"] // mix["chunk_steps"]
