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
