"""On the card: the elastic substep kernel (``csrc/solid_substep.cu``)
against the plain functions of ``ops/solid.py`` on the same card.

Solids: the Turek-Hron flag at the channel's 5 mm and 1 mm spacings (320 and
8,000 rows, clamped at the cylinder), the elastic gate of ``cases/gate3d``
(3-D, 2,240 rows, clamped at the floor) and the rocking tank's post at 1 mm
through a periodic depth of 20 layers (3-D, 10,000 rows, clamped at the
floor; every row's neighbours reach across the depth's seam), each built from
its structure rows alone (the initial neighbour lists are structure to
structure, so the solid is the full scene's) and bent so that F != I, with a
seeded velocity field.  Every solid has padding rows past its last valid row.

The bound: the float64 plain path is the reference; for each component of
positions and velocities, the float32 kernel's widest distance from it is at
most twice the float32 plain path's, plus 1e-6 of the component's largest
magnitude.  The float64 kernel sits within 1e-9 of the scale (summation
order and fused multiply-adds only).

Needs a CUDA device (the kernel exists only there); every test skips
without one.  Run on the card with
``python -m pytest tests/test_torch_solid_kernel.py -q``."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from particlemethod_fsi_tpu_torch.config import SCENES
from particlemethod_fsi_tpu_torch.generator import (
    BoidScene, Primitive, generate_grid, parse_boid_file)
from particlemethod_fsi_tpu_torch.io.data_file import parse_data_file
from particlemethod_fsi_tpu_torch.models.turek import turek_config, turek_grid
from particlemethod_fsi_tpu_torch.ops import solid as sl
from particlemethod_fsi_tpu_torch.solver import Simulation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE3D = os.path.join(REPO, "cases", "gate3d")
ROLLING = os.path.join(REPO, "cases", "rolling")
SOLIDS = ("turek-5mm", "turek-1mm", "gate3d", "post3d-seam")
STEPS, SUBSTEPS = 50, 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the solid kernel runs only there")
    return torch.device("cuda")


def _structure_only(grid):
    keep = (grid.prop >= 2) & (grid.prop < 4)
    return dataclasses.replace(
        grid, prop=grid.prop[keep], position=grid.position[keep],
        initial_position=grid.initial_position[keep],
        velocity=grid.velocity[keep])


def _scene(name):
    """``(cfg, grid)``: the solid's configuration and its structure rows."""
    if name.startswith("turek"):
        l0 = 5e-3 if name == "turek-5mm" else 1e-3
        cfg = turek_config(l0, dtype="float64")
        return cfg, _structure_only(turek_grid(l0))
    if name == "post3d-seam":
        l0, depth = 1e-3, 0.02
        grid = generate_grid(BoidScene(
            particle_distance=l0, lower_domain=(-0.02, -0.02, 0.0),
            upper_domain=(0.22, 0.22, depth), primitives=[Primitive(
                "Cuboid", spacing=l0, type=2, lower=(0.1, 0.0, 0.0),
                upper=(0.11, 0.05, depth))]))
        cfg = parse_data_file(os.path.join(ROLLING, "rolling.data")).replace(
            scene=SCENES["rolling"], two_dimensional=False, dt=4e-5,
            elastic_dt=2e-5)
        return cfg.replace(numerics=dataclasses.replace(
            cfg.numerics, dtype="float64")), grid
    boid = parse_boid_file(os.path.join(GATE3D, "gate3d.boid"))
    gate = [p for p in boid.primitives if p.type == 2]
    grid = generate_grid(BoidScene(
        particle_distance=boid.particle_distance,
        lower_domain=boid.lower_domain, upper_domain=boid.upper_domain,
        primitives=gate))
    cfg = parse_data_file(os.path.join(GATE3D, "gate3d.data")).replace(
        scene=SCENES["dam"], two_dimensional=False)
    return cfg.replace(numerics=dataclasses.replace(
        cfg.numerics, dtype="float64")), grid


_SIMS = {}


def _sim(name):
    """The scene's float64 Simulation on the CPU (set-up only: the solid)."""
    if name not in _SIMS:
        cfg, grid = _scene(name)
        _SIMS[name] = Simulation(cfg, grid, device="cpu")
    return _SIMS[name]


def _moved(solid, dtype, device):
    """The solid's tensors on ``device``, its floating ones as ``dtype``."""
    return solid._replace(**{
        k: v.to(device=device,
                dtype=dtype if v.is_floating_point() else v.dtype)
        for k, v in solid._asdict().items() if isinstance(v, torch.Tensor)})


def _bent(sim):
    """Subset-space ``(pos, vel)`` (float64, CPU): the solid bent along its
    clamp axis, quadratically in the distance from the clamp, and a seeded
    velocity field on the free rows' first sd components."""
    s = sim.solid
    sd = s.xij0.shape[-1]
    axis = sim.cfg.scene.clamp_axis
    across = 1 - axis  # x <-> y: the other in-plane axis
    pos0 = s.sub_pos0.numpy()
    valid = s.s_valid.numpy()
    along = pos0[:, axis] - pos0[valid, axis].min()
    length = float(along[valid].max())
    pos = pos0.copy()
    pos[valid, across] += 0.02 * along[valid] ** 2 / length
    rng = np.random.default_rng(11)
    vel = np.zeros_like(pos)
    vel[valid, :sd] = rng.normal(scale=0.01, size=(int(valid.sum()), sd))
    # padding rows hold the last slot's state, as the gather leaves them
    pos[~valid] = pos[valid][-1]
    vel[~valid] = vel[valid][-1]
    return torch.as_tensor(pos), torch.as_tensor(vel)


def _plain(pos, vel, solid, width, n, double_update, dt):
    for _ in range(n):
        pos, vel, _, _ = sl.substep_subset(
            pos, vel, solid, width, dt, double_position_update=double_update)
    return pos, vel


@pytest.mark.card
@pytest.mark.parametrize("double_update", [True, False])
@pytest.mark.parametrize("name", SOLIDS)
def test_kernel_within_twice_the_plain_float32_distance(cuda, name,
                                                        double_update):
    sim = _sim(name)
    s64 = _moved(sim.solid, torch.float64, cuda)
    s32 = _moved(sim.solid, torch.float32, cuda)
    w64 = torch.as_tensor(sim.domain_width, dtype=torch.float64, device=cuda)
    w32 = w64.float()
    dt = sim.cfg.elastic_dt
    pos, vel = (t.to(cuda) for t in _bent(sim))
    assert bool(s64.clamp.any()) and s64.s_pad > s64.n_struct
    valid = s64.s_valid
    for n_sub in (1, STEPS * SUBSTEPS):
        ref = _plain(pos, vel, s64, w64, n_sub, double_update, dt)
        p32 = _plain(pos.float(), vel.float(), s32, w32, n_sub, double_update,
                     dt)
        steps, per = (1, 1) if n_sub == 1 else (STEPS, SUBSTEPS)
        k64 = pos, vel
        k32 = pos.float(), vel.float()
        for _ in range(steps):
            k64 = sl.substeps_subset(*k64, s64, w64, dt, per,
                                     double_position_update=double_update)
            k32 = sl.substeps_subset(*k32, s32, w32, dt, per,
                                     double_position_update=double_update)
        for what, r, p, k, kk in zip(("pos", "vel"), ref, p32, k32, k64):
            r, p, k, kk = (t[valid].double() for t in (r, p, k, kk))
            for c in range(3):
                scale = float(r[:, c].abs().max())
                plain_gap = float((p[:, c] - r[:, c]).abs().max())
                gap = float((k[:, c] - r[:, c]).abs().max())
                assert gap <= 2 * plain_gap + 1e-6 * scale, (
                    f"{name} {what}[{c}] after {n_sub}: kernel {gap:.3e}, "
                    f"plain float32 {plain_gap:.3e}, scale {scale:.3e}")
                gap64 = float((kk[:, c] - r[:, c]).abs().max())
                assert gap64 <= 1e-9 * scale, (
                    f"{name} {what}[{c}] float64 after {n_sub}: {gap64:.3e}")
        # the clamp held, and the solid moved
        cl = s64.clamp
        assert torch.equal(k32[0][cl], s32.sub_pos0[cl])
        assert not k32[1][cl].any()
        assert float((k32[1][valid] - vel.float()[valid]).abs().max()) > 0


@pytest.mark.card
@pytest.mark.parametrize("name", SOLIDS)
def test_two_launches_bit_equal_and_counted(cuda, name):
    sim = _sim(name)
    s32 = _moved(sim.solid, torch.float32, cuda)
    w32 = torch.as_tensor(sim.domain_width, dtype=torch.float32, device=cuda)
    pos, vel = (t.to(cuda).float() for t in _bent(sim))
    sl.reset_launch_counts()
    a = sl.substeps_subset(pos, vel, s32, w32, sim.cfg.elastic_dt, SUBSTEPS,
                           double_position_update=True)
    b = sl.substeps_subset(pos, vel, s32, w32, sim.cfg.elastic_dt, SUBSTEPS,
                           double_position_update=True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert sl.launch_counts["solid_substep"] == 2 * SUBSTEPS
    # the inputs are left intact
    assert torch.equal(pos, _bent(sim)[0].to(cuda).float())


@pytest.mark.card
@pytest.mark.parametrize("name", SOLIDS)
def test_kick_at_rest_is_rounding(cuda, name):
    """u = 0, so E, P and the kick are zero but for rounding: over one
    substep from rest the float32 kernel's velocity change lies no farther
    from the float64 plain path's (~1e-15) than twice the float32 plain
    path's, plus 1e-6 of the bent solid's kick; the plain float32 change is
    itself under 1e-4 of that kick."""
    sim = _sim(name)
    s64 = _moved(sim.solid, torch.float64, cuda)
    s32 = _moved(sim.solid, torch.float32, cuda)
    w64 = torch.as_tensor(sim.domain_width, dtype=torch.float64, device=cuda)
    w32 = w64.float()
    dt = sim.cfg.elastic_dt
    valid = s64.s_valid

    def kick(pos, solid, width, run):
        vel = torch.zeros_like(pos)
        return run(pos, vel, solid, width)[1][valid].double()

    def plain(pos, vel, solid, width):
        return _plain(pos, vel, solid, width, 1, True, dt)

    def kernel(pos, vel, solid, width):
        return sl.substeps_subset(pos, vel, solid, width, dt, 1,
                                  double_position_update=True)

    ref = kick(s64.sub_pos0.clone(), s64, w64, plain)
    p32 = kick(s32.sub_pos0.clone(), s32, w32, plain)
    k32 = kick(s32.sub_pos0.clone(), s32, w32, kernel)
    bent = kick(_bent(sim)[0].to(cuda), s64, w64, plain)
    scale = float(bent.abs().max())
    plain_gap = float((p32 - ref).abs().max())
    gap = float((k32 - ref).abs().max())
    assert bool(torch.isfinite(k32).all())
    assert plain_gap <= 1e-4 * scale
    assert gap <= 2 * plain_gap + 1e-6 * scale, (
        f"{name}: kernel {gap:.3e}, plain float32 {plain_gap:.3e}, bent "
        f"kick {scale:.3e}")


@pytest.mark.card
@pytest.mark.parametrize("name", ("turek-5mm", "gate3d"))
def test_no_substep_returns_copies(cuda, name):
    """``substeps`` 0 launches nothing and returns the inputs' values in
    new tensors, as the plain loop leaves them."""
    sim = _sim(name)
    s32 = _moved(sim.solid, torch.float32, cuda)
    w32 = torch.as_tensor(sim.domain_width, dtype=torch.float32, device=cuda)
    pos, vel = (t.to(cuda).float() for t in _bent(sim))
    sl.reset_launch_counts()
    got = sl.substeps_subset(pos, vel, s32, w32, sim.cfg.elastic_dt, 0,
                             double_position_update=True)
    torch.cuda.synchronize()
    assert sl.launch_counts["solid_substep"] == 0
    for a, b in zip(got, (pos, vel)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


@pytest.mark.card
def test_channel_step_counts_and_launches(cuda):
    """The 44k channel on the card: each step runs ``substeps`` kernel
    calls; on the 1 mm flag one ``run_substeps`` (a step's solid) makes at
    most 16 device kernel launches, gather and scatter included."""
    from particlemethod_fsi_tpu_torch.models.turek import build_turek

    chan = build_turek(5e-3)
    sl.reset_launch_counts()
    state = chan.run_chunk(chan.state0, 2)
    torch.cuda.synchronize()
    assert sl.launch_counts["solid_substep"] == 2 * chan.cfg.substeps == 10
    assert bool(torch.isfinite(state.pos).all())

    sim = _sim("turek-1mm")
    s32 = _moved(sim.solid, torch.float32, cuda)
    w32 = torch.as_tensor(sim.domain_width, dtype=torch.float32, device=cuda)
    full_pos = torch.zeros((sim.n_pad, 3), device=cuda)
    full_vel = torch.zeros_like(full_pos)
    sub_pos, sub_vel = (t.to(cuda).float() for t in _bent(sim))
    full_pos[s32.gather_idx] = sub_pos
    full_vel[s32.gather_idx] = sub_vel

    def run():
        return sl.run_substeps(full_pos, full_vel, s32, w32,
                               sim.cfg.elastic_dt, SUBSTEPS,
                               double_position_update=True)

    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    names = sorted({e.name for e in kernels})
    print(f"solid launches a step (turek 1 mm flag): {len(kernels)}: {names}")
    assert 2 * SUBSTEPS <= len(kernels) <= 16, names
    assert sum("solid_" in e.name for e in kernels) == 2 * SUBSTEPS
