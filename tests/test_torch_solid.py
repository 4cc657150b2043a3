"""PyTorch port vs JAX package: the elastic solid pipeline -- static
precomputation equal, F = I at rest, and one ``run_substeps`` on a bent bar."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cases import L0, dam_like_config, mini_bar, mini_fsi
from test_torch_common import WINDOW_KW, fields_np, port_cfg, port_grid
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu.ops import solid as jsl
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu_torch import convert
from particlemethod_fsi_tpu_torch.ops import solid as sl
from particlemethod_fsi_tpu_torch.solver import Simulation

# the "bar" scene's clamp (x0 < L0) without its initial velocity profile,
# which the port does not have yet
BAR_SCENE = dataclasses.replace(SCENES["bar"], velocity_profile=None)


def _bar_sims():
    grid = mini_bar()
    cfg = dam_like_config(**WINDOW_KW).replace(
        scene=BAR_SCENE, gravity=(0.0, 0.0, 0.0))
    return (grid, JaxSimulation(cfg, grid),
            Simulation(port_cfg(cfg), port_grid(grid), device="cpu"))


def _bent(grid, n_pad):
    """The bar bent into a parabola, with a seeded velocity field."""
    rng = np.random.default_rng(5)
    pos = np.zeros((n_pad, 3))
    pos[: grid.n] = grid.position
    x = pos[: grid.n, 0]
    pos[: grid.n, 1] += 0.8 * x * x / (20 * L0)
    pos[: grid.n, 0] -= 0.02 * x
    vel = np.zeros((n_pad, 3))
    vel[: grid.n, :2] = rng.normal(scale=0.05, size=(grid.n, 2))
    return pos, vel


@pytest.mark.parametrize("scene", ["mini_bar", "mini_fsi"])
def test_build_solid_static_equal(scene):
    if scene == "mini_bar":
        _, jsim, psim = _bar_sims()
    else:
        grid = mini_fsi()
        cfg = dam_like_config(**WINDOW_KW)
        jsim = JaxSimulation(cfg, grid)
        psim = Simulation(port_cfg(cfg), port_grid(grid), device="cpu")
    want = fields_np(jsim.solid)
    assert psim.solid.n_struct == int(want["s_valid"].sum()) > 0
    for k, v in want.items():
        got = getattr(psim.solid, k).numpy()
        np.testing.assert_array_equal(got, v, err_msg=k)
    # the two fields the port adds
    np.testing.assert_array_equal(
        psim.solid.gather_idx.numpy(),
        np.minimum(want["s_idx"], psim.n_pad - 1))
    # and the carried-across form is the same object
    conv = convert.solid_static_from_numpy(want, dtype=torch.float64)
    for a, b in zip(conv, psim.solid):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)


def test_deformation_gradient_is_identity_at_rest():
    grid, _, psim = _bar_sims()
    solid = psim.solid
    sub_pos = psim.state0.pos[solid.gather_idx]
    f = sl.deformation_gradient_subset(sub_pos, solid, psim.domain_width)
    eye = torch.eye(2, dtype=torch.float64)
    valid = solid.s_valid
    assert float((f[valid] - eye).abs().max()) <= 1e-14
    strain, stress = sl.stvk_stress(f, solid.lam, solid.mu)
    assert float(strain[valid].abs().max()) <= 1e-14
    # float32 too: the contractions take no reduced-precision path
    s32 = convert.solid_static_from_numpy(
        {k: v.numpy() if isinstance(v, torch.Tensor) else v
         for k, v in solid._asdict().items()}, dtype=torch.float32)
    f32 = sl.deformation_gradient_subset(
        sub_pos.float(), s32, psim.domain_width)
    assert float((f32[valid] - eye.float()).abs().max()) <= 2e-6


@pytest.mark.parametrize("double_update", [True, False])
def test_run_substeps_matches_jax_on_bent_bar(double_update):
    grid, jsim, psim = _bar_sims()
    pos, vel = _bent(grid, psim.n_pad)
    jpos, jvel = jsl.run_substeps(
        jnp.asarray(pos), jnp.asarray(vel), jsim.solid, jsim.domain_width,
        1e-5, 3, double_position_update=double_update)
    tpos, tvel = torch.as_tensor(pos.copy()), torch.as_tensor(vel.copy())
    ppos, pvel = sl.run_substeps(
        tpos, tvel, psim.solid, psim.domain_width, 1e-5, 3,
        double_position_update=double_update)
    # inputs left intact
    assert np.array_equal(tpos.numpy(), pos) and np.array_equal(tvel.numpy(), vel)
    # sums over the K0 neighbours are taken in another order, nothing else
    np.testing.assert_allclose(ppos.numpy(), np.asarray(jpos), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(pvel.numpy(), np.asarray(jvel), rtol=1e-12,
                               atol=1e-12 * float(np.abs(np.asarray(jvel)).max()))
    # the bar really moved and the clamp held
    assert float(np.abs(np.asarray(jvel) - vel).max()) > 1e-3
    clamped = (grid.initial_position[:, 0] < L0)
    assert clamped.any()
    np.testing.assert_array_equal(ppos.numpy()[: grid.n][clamped],
                                  grid.initial_position[clamped])


def _plain_substeps(sub_pos, sub_vel, solid, width, dt, n, double_update):
    """The substep loop as the plain functions run it."""
    for _ in range(n):
        sub_pos, sub_vel, _, _ = sl.substep_subset(
            sub_pos, sub_vel, solid, width, dt,
            double_position_update=double_update)
    return sub_pos, sub_vel


def test_compacted_neighbour_tables_hold_the_valid_slots():
    """Each row's valid slots, in slot order, as a prefix of the kernel's
    slot-major tables; zeros past the count."""
    _, _, psim = _bar_sims()
    s = psim.solid
    mask = s.mask0.numpy()
    count = s.count0_c.numpy()
    np.testing.assert_array_equal(count, mask.sum(axis=1))
    kc = s.nbr0_c.shape[0]
    assert kc == max(1, int(count.max())) < s.nbr0.shape[1]
    for i in range(s.s_pad):
        slots = np.nonzero(mask[i])[0]
        n = slots.size
        np.testing.assert_array_equal(s.nbr0_c[:n, i].numpy(),
                                      s.nbr0[i, slots].numpy())
        np.testing.assert_array_equal(s.wij0_c[:n, i].numpy(),
                                      s.wij0[i, slots].numpy())
        np.testing.assert_array_equal(s.xij0_c[:n, :, i].numpy(),
                                      s.xij0[i, slots].numpy())
        assert not s.nbr0_c[n:, i].any() and not s.wij0_c[n:, i].any()
        assert not s.xij0_c[n:, :, i].any()


def test_compaction_refuses_slots_that_are_not_a_prefix():
    """The set-up's lists (and the JAX package's) fill each row from its
    first slot; a row with a gap is refused, not reordered."""
    nbr = np.arange(6).reshape(2, 3)
    xij, wij = np.ones((2, 3, 2)), np.ones((2, 3))
    sl.compact_neighbors(nbr, np.array([[1, 1, 0], [1, 0, 0]], bool), xij, wij)
    with pytest.raises(ValueError, match="prefix"):
        sl.compact_neighbors(nbr, np.array([[1, 0, 1], [1, 0, 0]], bool),
                             xij, wij)


@pytest.mark.parametrize("double_update", [True, False])
def test_cpu_substeps_take_the_plain_functions(double_update):
    """On CPU tensors both entry points give, bit for bit, what the plain
    functions give, and no kernel launch is counted."""
    grid, _, psim = _bar_sims()
    pos, vel = (torch.as_tensor(a) for a in _bent(grid, psim.n_pad))
    s, w = psim.solid, psim._width_t
    sl.reset_launch_counts()
    want_s = _plain_substeps(pos[s.gather_idx], vel[s.gather_idx], s, w,
                             1e-5, 4, double_update)
    got_s = sl.substeps_subset(pos[s.gather_idx], vel[s.gather_idx], s, w,
                               1e-5, 4, double_position_update=double_update)
    for a, b in zip(got_s, want_s):
        assert torch.equal(a, b)
    rows = s.gather_idx[:s.n_struct]
    want = (pos.index_copy(0, rows, want_s[0][:s.n_struct]),
            vel.index_copy(0, rows, want_s[1][:s.n_struct]))
    got = sl.run_substeps(pos, vel, s, w, 1e-5, 4,
                          double_position_update=double_update)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert sl.launch_counts == {"solid_substep": 0}


def test_no_substep_returns_copies_on_either_device(monkeypatch):
    """``substeps`` 0 (a data file whose ElasticDt exceeds twice its Dt)
    leaves the state as the plain loop leaves it, in new tensors: on CPU
    tensors and on a tensor reporting ``is_cuda``, which never reaches the
    kernel's wrapper."""
    grid, _, psim = _bar_sims()
    pos, vel = (torch.as_tensor(a) for a in _bent(grid, psim.n_pad))
    s, w = psim.solid, psim._width_t

    def boom(*a, **k):
        raise AssertionError("a substep ran")

    for name in ("substep_subset", "_substeps_cuda"):
        monkeypatch.setattr(sl, name, boom)

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    sl.reset_launch_counts()
    for p, v in ((pos, vel), (pos.as_subclass(FakeCuda),
                              vel.as_subclass(FakeCuda))):
        sub = (p[s.gather_idx], v[s.gather_idx])
        got = sl.substeps_subset(*sub, s, w, 1e-5, 0,
                                 double_position_update=True)
        for a, b in zip(got, sub):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        got = sl.run_substeps(p, v, s, w, 1e-5, 0,
                              double_position_update=True)
        for a, b in zip(got, (pos, vel)):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert sl.launch_counts["solid_substep"] == 0


def test_cpu_halo_structure_step_takes_the_plain_functions(monkeypatch):
    """The halo's replicated structure step (one rank, in process) is bit
    for bit the step with the plain substep loop in its place, and counts
    no kernel launch."""
    from particlemethod_fsi_tpu_torch.parallel import halo
    from particlemethod_fsi_tpu_torch.parallel.comm import Comm

    grid = mini_fsi()
    cfg = dam_like_config(**WINDOW_KW).replace(
        scene=SCENES["dam"], young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))
    psim = Simulation(port_cfg(cfg), port_grid(grid), device="cpu")
    comm = Comm.local()

    def two_steps():
        hstep = halo.make_halo_step(psim, comm)
        state = halo.partition_state(psim, comm, hstep.hcfg)
        for _ in range(2):
            state, over = hstep.step(state)
            assert over == 0
        return state

    sl.reset_launch_counts()
    got = two_steps()
    assert sl.launch_counts == {"solid_substep": 0}

    def plain(sub_pos, sub_vel, solid, width, dt, n, *,
              double_position_update, spans=None):
        return _plain_substeps(sub_pos, sub_vel, solid, width, dt, n,
                               double_position_update)

    monkeypatch.setattr(sl, "substeps_subset", plain)
    want = two_steps()
    assert float((got.s_vel - psim.state0.vel[psim.solid.gather_idx])
                 .abs().max()) > 0
    for k in ("s_pos", "s_vel", "pos", "vel"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_cuda_tensor_never_takes_the_plain_substep(monkeypatch):
    """A tensor that reports ``is_cuda`` goes to the kernel's wrapper, which
    raises here (no card, no nvcc), and never reaches a plain function."""

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def boom(*a, **k):
        raise AssertionError("plain substep called for a CUDA tensor")

    for name in ("substep_subset", "deformation_gradient_subset",
                 "stvk_stress", "stress_velocity_kick"):
        monkeypatch.setattr(sl, name, boom)
    grid, _, psim = _bar_sims()
    pos, vel = (torch.as_tensor(a).as_subclass(FakeCuda)
                for a in _bent(grid, psim.n_pad))
    assert pos.is_cuda and pos[psim.solid.gather_idx].is_cuda
    s = psim.solid
    for call in (
        lambda: sl.run_substeps(pos, vel, s, psim._width_t, 1e-5, 2,
                                double_position_update=True),
        lambda: sl.substeps_subset(pos[s.gather_idx], vel[s.gather_idx], s,
                                   psim._width_t, 1e-5, 2,
                                   double_position_update=True),
    ):
        with pytest.raises(Exception) as e:
            call()
        assert not isinstance(e.value, AssertionError)
    assert sl.launch_counts["solid_substep"] == 0
