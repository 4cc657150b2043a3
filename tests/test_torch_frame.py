"""PyTorch port vs JAX package: the cell-sorted frame and the window tables
must be EQUAL (integer tables; the payload is a pure gather), on the mini
cases and on the bench scene, at the start and after a few steps."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cases import dam_like_config, mini_dam, mini_fsi
from test_torch_common import WINDOW_KW, bench_sims, port_cfg, port_grid, port_state
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu.ops import pallas_pairwise as jpw
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu_torch.ops import packed_engine as pk
from particlemethod_fsi_tpu_torch.ops import windows as pw
from particlemethod_fsi_tpu_torch.solver import Simulation


def _mini(grid_fn):
    grid = grid_fn()
    base = dict(scene=SCENES["dam"],
                young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))
    cfg = dam_like_config(**WINDOW_KW).replace(**base)
    return (JaxSimulation(cfg, grid),
            Simulation(port_cfg(cfg), port_grid(grid), device="cpu"))


def _sims(name):
    if name == "mini_dam":
        return _mini(mini_dam)
    if name == "mini_fsi":
        return _mini(mini_fsi)
    return bench_sims(24)


@pytest.mark.parametrize("steps", [0, 4])
@pytest.mark.parametrize("scene", ["mini_dam", "mini_fsi", "bench24"])
def test_frame_and_windows_equal(scene, steps):
    jsim, psim = _sims(scene)
    js = jsim.state0
    for _ in range(steps):
        js = jsim.step(js)
    ps = port_state(js)

    jframe = jsim._pallas_frame(js.pos, js.vel, js.prop)
    jws, jwl = jpw.compute_windows(jframe, jsim._frame_grid, jsim._pcfg)

    assert dataclasses.asdict(jsim._frame_grid) == dataclasses.asdict(psim._frame_grid)
    assert jsim._pcfg._asdict() == psim._pcfg._asdict()
    pframe = pk.sort_frame(ps.pos, ps.vel, ps.prop, psim._frame_grid)
    pws, pwl = pw.compute_windows(pframe, psim._frame_grid, psim._pcfg)

    np.testing.assert_array_equal(pframe.key.numpy(), np.asarray(jframe.key))
    np.testing.assert_array_equal(pframe.orig.numpy(), np.asarray(jframe.orig))
    np.testing.assert_array_equal(pframe.prop.numpy(), np.asarray(jframe.prop))
    np.testing.assert_array_equal(pframe.pos.numpy(), np.asarray(jframe.pos))
    np.testing.assert_array_equal(pframe.vel.numpy(), np.asarray(jframe.vel))
    assert pframe.key.dtype == torch.int32
    np.testing.assert_array_equal(pws.numpy(), np.asarray(jws))
    np.testing.assert_array_equal(pwl.numpy(), np.asarray(jwl))
    assert pws.dtype == torch.int32 and pwl.dtype == torch.int32
    assert int(pwl.max()) > 0


@pytest.mark.parametrize("scene", ["mini_fsi", "bench24"])
def test_unsort_round_trip(scene):
    _, psim = _sims(scene)
    s = psim.state0
    frame = pk.sort_frame(s.pos, s.vel, s.prop, psim._frame_grid)
    # orig is a permutation of the slots
    assert torch.equal(torch.sort(frame.orig).values,
                       torch.arange(psim.n_pad))
    pos, prop = pk.unsort(frame, frame.pos, frame.prop)
    assert torch.equal(pos, s.pos) and torch.equal(prop, s.prop)
    with pytest.raises(ValueError):
        pk.unsort(frame, frame.pos[:-1])


def test_bench_scene_is_the_jax_bench_scene():
    """The port's bench case is bench.py's: same grid, same configuration."""
    import bench
    from particlemethod_fsi_tpu_torch.models import bench_config, bench_grid

    jsim = bench.build_case(24, backend="pallas_t")
    pgrid = bench_grid(24)
    assert dataclasses.asdict(jsim.cfg) == dataclasses.asdict(bench_config())
    assert pgrid.n == jsim.n == 880
    jpos = np.asarray(jnp.asarray(pgrid.position, dtype=jsim.dtype))
    np.testing.assert_array_equal(np.asarray(jsim.state0.pos)[: pgrid.n], jpos)
    np.testing.assert_array_equal(np.asarray(jsim.state0.prop)[: pgrid.n],
                                  pgrid.prop)
