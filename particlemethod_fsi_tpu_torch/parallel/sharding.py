"""Multi-device all-gather mode: receiver-parallel decomposition over a ring
of ranks.

Counterpart of ``particlemethod_fsi_tpu/parallel/sharding.py``
(``make_mesh``, ``make_mesh_grid``, ``shard_state``, ``make_sharded_step``,
``make_sharded_runner``; ``make_mesh_grid`` serves the 2-axis halo mode).  Each rank holds a contiguous block of ``n_pad / ranks``
slots of every particle array; the wall state and the time are replicated.
A step:

* the elementwise pre-steps on the rank's own rows;
* an all-gather of positions, velocities and types, and the sorted frame of
  every particle, built alike on every rank;
* phase 1 of the packed engine for this rank's block of sorted receivers
  (their candidates padded to the widest over all ranks, so that each
  receiver's sums are those of one device bit for bit), an all-gather of
  the fields phase 2 reads from senders, phase 2 for the same receivers;
* an all-gather of the forces, the unsort, the kick and drift of own rows;
* the elastic substeps on the all-gathered positions and velocities, every
  rank keeping its block.

Every backend runs the packed engine here, as in the JAX package: no window
kernel lies on this path.
"""

from __future__ import annotations

import torch

from particlemethod_fsi_tpu_torch.ops import packed_engine as pk
from particlemethod_fsi_tpu_torch.ops import solid as sl
from particlemethod_fsi_tpu_torch.ops import walls as wl
from particlemethod_fsi_tpu_torch.parallel.comm import Comm
from particlemethod_fsi_tpu_torch.state import ParticleState, Segments


def make_mesh(comm: Comm) -> tuple[int]:
    """The 1-D mesh shape of the ranks (``make_mesh`` builds a ``("dp",)``
    device mesh there; here the ranks are the mesh)."""
    return (comm.size,)


def make_mesh_grid(comm: Comm, nx: int, ny: int) -> Comm:
    """The ranks as the 2-axis mesh of the ``nx`` x ``ny`` rectangle halo
    (``parallel/halo.py``): rank ``ix * ny + iy`` owns rectangle ``(ix,
    iy)`` and exchanges over a ring along each axis: a Comm of the same
    ranks and process group, its counters at zero.  Raises as the JAX
    ``make_mesh_grid`` does where the mesh needs more devices than there
    are ranks; every rank holds a region, so a mesh of fewer raises too."""
    if nx * ny > comm.size:
        raise ValueError(f"mesh {nx}x{ny} needs {nx * ny} devices, "
                         f"have {comm.size}")
    if nx * ny < comm.size:
        raise ValueError(f"mesh {nx}x{ny} holds {nx * ny} of {comm.size} "
                         "ranks; every rank must own a region")
    return Comm(comm.rank, comm.size, comm.device, comm.transport,
                comm.group, (nx, ny))


def _block(sim, comm: Comm) -> tuple[int, int]:
    if sim.n_pad % comm.size:
        raise ValueError(f"n_pad={sim.n_pad} not divisible by {comm.size} "
                         "devices")
    nr = sim.n_pad // comm.size
    return comm.rank * nr, nr


def shard_state(sim, comm: Comm, state: ParticleState) -> ParticleState:
    """This rank's block of a slot-ordered state's particle arrays; the
    scalars and the wall state stay whole."""
    start, nr = _block(sim, comm)
    sl_ = slice(start, start + nr)
    return state.replace(prop=state.prop[sl_], pos=state.pos[sl_],
                         pos0=state.pos0[sl_], vel=state.vel[sl_])


def gather_state(comm: Comm, state: ParticleState) -> ParticleState:
    """The slot-ordered state of every rank's block (an all-gather)."""
    prop, pos, pos0, vel = comm.all_gather(state.prop, state.pos,
                                           state.pos0, state.vel)
    return state.replace(prop=prop, pos=pos, pos0=pos0, vel=vel)


def make_sharded_step(sim, comm: Comm):
    """The all-gather step of this rank for a configured Simulation:
    ``step(state) -> state`` over the rank's block of slots (``n_pad`` must
    divide evenly)."""
    cfg = sim.cfg
    start, nr = _block(sim, comm)
    dt = cfg.dt
    grid, cap = sim.cell_grid, sim.cell_capacity

    def agree(width: int) -> int:
        return int(comm.max(torch.tensor([width], device=comm.device)).item())

    def step(state: ParticleState) -> ParticleState:
        prop, pos, vel = state.prop, state.pos, state.vel
        wall_center = state.wall_center
        # --- local elementwise pre-steps (profile, walls, wrap) ---------
        if cfg.scene.velocity_profile == "turek_inlet":
            vel = wl.turek_inlet_velocity(pos, vel, prop, state.time,
                                          cfg.scene)
        if not sim._walls_static:
            pos, vel, wall_center = wl.apply_wall_motion(
                pos, vel, prop, wall_center, state.time,
                wall_velocity=sim.wall_velocity, wall_omega=sim.wall_omega,
                wall_rotation=sim.wall_rotation, dt=dt, scene=cfg.scene,
                freeze=cfg.compat.freeze_wall_motion)
        pos = wl.periodic_wrap(pos, sim._dmin_t, sim._width_t)

        # --- gather senders, bin replicated -----------------------------
        g_pos, g_vel, g_prop = comm.all_gather(pos, vel, prop)
        frame = pk.sort_frame(g_pos, g_vel, g_prop, grid,
                              with_cell_start=True)

        # --- phase 1 on this rank's sorted receivers --------------------
        views = pk.frame_views(frame, grid, cap, start=start, count=nr,
                               agree=agree)
        parts = [pk.phase1_fields(frame, rv, grid, sim.kernels, sim.tables,
                                  cap=cap) for rv in views]
        f1 = {k: torch.cat([p[k] for p in parts]) if parts[0][k].dim()
              else parts[0][k] for k in parts[0]}

        # --- share the phase-1 fields phase 2 reads from senders --------
        names = ("pressure_p", "pressure_a", "gravity_center", "mu")
        sender = dict(zip(names, comm.all_gather(*(f1[k] for k in names))))

        # --- phase 2 forces for the local receivers ---------------------
        out, at = [], 0
        for rv in views:
            n = rv.pos.shape[0]
            mine = {k: v[at:at + n] for k, v in f1.items() if v.dim()}
            out.append(pk.phase2_forces(
                frame, rv, sender, mine, grid, sim.kernels, sim.tables,
                volume=sim.volume, two_dimensional=cfg.two_dimensional,
                cap=cap))
            at += n
        force_local = torch.cat(out)
        # gravity on fluid + structure (src/main.cpp:2917-2935)
        rprop = frame.prop[start:start + nr]
        seg = Segments(rprop)
        mass_r = sim.tables.density[torch.clamp(rprop, 0, 5).long()] \
            * sim.volume
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
        force_local = force_local + torch.where(
            (seg.fluid | seg.structure)[:, None],
            mass_r[:, None] * sim._grav_t, zero)

        # --- un-sort forces to slot order -------------------------------
        (g_force,) = comm.all_gather(force_local)
        (force_orig,) = pk.unsort(frame, g_force)
        force = force_orig[start:start + nr]

        # --- integrate locally (src/main.cpp:2938-2955, 1892-1906) ------
        seg = Segments(prop)
        fs = seg.fluid | seg.structure
        mass = sim.tables.density[torch.clamp(prop, 0, 5).long()] * sim.volume
        accel = force / torch.where(mass > 0, mass,
                                    torch.ones_like(mass))[:, None]
        vel = torch.where(fs[:, None], vel + accel * dt, vel)
        pos = torch.where(seg.fluid[:, None], pos + vel * dt, pos)

        # --- elastic substeps on the gathered state ---------------------
        if sim.has_structure and cfg.substeps > 0:
            g_pos, g_vel = comm.all_gather(pos, vel)
            g_pos, g_vel = sl.run_substeps(
                g_pos, g_vel, sim.solid, sim._width_t, cfg.elastic_dt,
                cfg.substeps,
                double_position_update=cfg.compat.double_substep_position_update)
            pos = g_pos[start:start + nr]
            vel = g_vel[start:start + nr]

        return state.replace(pos=pos, vel=vel, wall_center=wall_center,
                             time=state.time + dt)

    return step


def make_sharded_runner(sim, comm: Comm):
    """``run_chunk(state, n_steps)``: the all-gather step ``n_steps``
    times (the one-device ``Simulation.run_chunk`` analog)."""
    step = make_sharded_step(sim, comm)

    def run_chunk(state: ParticleState, n_steps: int) -> ParticleState:
        with torch.no_grad():
            for _ in range(n_steps):
                state = step(state)
        return state

    return run_chunk
