"""PyTorch port vs JAX package: the ``gather`` engine (the padded neighbour
matrix of ``ops/neighbors.build_neighbor_list``, ``ops/fluid.PairContext``,
the per-edge formulas of ``ops/edge_math`` and the EOS helpers), and both
candidate engines through ten steps, float64 on the CPU.

Neighbour lists are held equal exactly (indices, mask, counts, the fullest
cell), also where ``max_neighbors`` truncates (the kept neighbours are the
first in the cell-scan order) and where ``cell_capacity`` drops particles
from the cell table.  Per-edge and per-particle fields: rtol 1e-12 with
atol 1e-13 of the row scale.  Steps: port ``gather`` against port
``packed`` at the bars of the JAX package's own engine parity
(``tests/test_backends.py``: pos rtol 1e-12 / atol 1e-16, vel rtol 1e-10 /
atol 1e-15), and each against its JAX engine (velocities at the slice's
bar, see the test)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from cases import config_3d, dam_like_config, mini_dam, mini_dam_3d, mini_fsi
from test_torch_common import (
    F64,
    close_to_scale,
    fields_np,
    jitter,
    port_cfg,
    port_grid,
)
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu.ops import edge_math as jem
from particlemethod_fsi_tpu.ops import fluid as jfl
from particlemethod_fsi_tpu.ops import neighbors as jnb
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
from particlemethod_fsi_tpu_torch import convert
from particlemethod_fsi_tpu_torch.ops import edge_math as em
from particlemethod_fsi_tpu_torch.ops import fluid as fl
from particlemethod_fsi_tpu_torch.ops import neighbors as nb
from particlemethod_fsi_tpu_torch.solver import Simulation
from particlemethod_fsi_tpu_torch.state import to_numpy

_IR = [[1.0] * 6 for _ in range(6)]
_IR[1][2] = 0.5
_IR[2][1] = 0.8
_COUPLED = dict(scene=SCENES["dam"],
                young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))


def _jax_sim(case):
    if case == "mini_dam":
        return JaxSimulation(dam_like_config(backend="gather"), mini_dam())
    if case == "3d":
        return JaxSimulation(config_3d(backend="gather"),
                             jitter(mini_dam_3d(), 41))
    cfg = dam_like_config(backend="gather").replace(
        **_COUPLED, surface_tension=(0.05, 0.05, 0.05, 0.0, 0.05, 0.0),
        interaction_ratio=tuple(tuple(r) for r in _IR))
    return JaxSimulation(cfg, jitter(mini_fsi(), 42))


@functools.lru_cache(maxsize=None)
def _case(case):
    jsim = _jax_sim(case)
    s = jsim.state0
    return jsim, (s.pos, s.vel, s.prop)


def _port_grid(jsim):
    return convert.cell_grid_from_dict(dataclasses.asdict(jsim.cell_grid))


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _jax_nbr(jsim, pos, prop, k, cap):
    return jnb.build_neighbor_list(pos, prop >= 0, jsim.cell_grid,
                                   max_neighbors=k, cell_capacity=cap)


@pytest.mark.parametrize("limit", ["default", "truncating", "capacity_8"])
@pytest.mark.parametrize("case", ["mini_dam", "jitter", "3d"])
def test_neighbor_list_equals_jax(case, limit):
    jsim, (pos, _, prop) = _case(case)
    k = jsim.cfg.numerics.max_neighbors
    cap = jsim.cell_capacity
    if limit == "truncating":
        k = 8
    elif limit == "capacity_8":
        cap = 8
    want = _jax_nbr(jsim, pos, prop, k, cap)
    got = nb.build_neighbor_list(_t(pos), _t(prop) >= 0, _port_grid(jsim),
                                 max_neighbors=k, cell_capacity=cap)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert int(got.cell_overflow) == int(want.cell_overflow)
    count = np.asarray(want.count)
    if limit == "truncating":
        # trap: with count > K the first K in cell-scan order are kept
        assert (count > k).sum() > 10
    else:
        assert count.max() <= k
    if limit == "capacity_8":
        assert int(want.cell_overflow) > cap  # cells lost rows
        full = _jax_nbr(jsim, pos, prop, k, jsim.cell_capacity)
        assert (np.asarray(full.count) > count).any()


@pytest.mark.parametrize("case", ["jitter", "3d"])
def test_pair_context_edges_and_eos_match_jax(case):
    """``make_pair_context``, ``edge_math.phase1_sums`` / ``phase2_force``
    on its geometry and the EOS helpers between them, as the gather
    engine's ``_fluid_phase`` chains them."""
    jsim, (pos, vel, prop) = _case(case)
    ks, jt = jsim.kernels, jsim.tables
    tables = convert.type_tables_from_numpy(fields_np(jt), dtype=F64)
    jn = _jax_nbr(jsim, pos, prop, jsim.cfg.numerics.max_neighbors,
                  jsim.cell_capacity)
    nbr = convert.neighbor_list_from_numpy(
        {f.name: np.asarray(getattr(jn, f.name))
         for f in dataclasses.fields(jn)})
    jctx = jfl.make_pair_context(pos, prop, jn, jsim.domain_width, jt)
    ctx = fl.make_pair_context(_t(pos), _t(prop), nbr, jsim.domain_width,
                               tables)
    for k in ("j", "mask", "prop_i", "prop_j", "ratio_ij", "ratio_ji"):
        np.testing.assert_array_equal(getattr(ctx, k).numpy(),
                                      np.asarray(getattr(jctx, k)), err_msg=k)
    for k in ("xij", "rij2", "rij", "eij"):
        close_to_scale(k, getattr(ctx, k), getattr(jctx, k))

    def chain(m, f, ctx, vel, prop, tables):
        """_fluid_phase's edge and EOS steps, in the package ``m``."""
        mv = (lambda a: jax.numpy.moveaxis(a, -1, 0)) if m is jem else (
            lambda a: torch.movedim(a, -1, 0))
        geom = m.EdgeGeometry(xij=mv(ctx.xij), rij2=ctx.rij2, rij=ctx.rij,
                              eij=mv(ctx.eij), valid=ctx.mask)
        j = ctx.j
        da, gc_c, wp, dvg = m.phase1_sums(geom, ks, vel_i=vel.T,
                                          vel_j=mv(vel[j]),
                                          ratio_ij=ctx.ratio_ij)
        vs = wp - ks.n0p
        kappa, lam, mu = f.physical_coefficients(prop, vs, tables)
        pp = f.pressure_p(vs, dvg, kappa, lam)
        pa = f.pressure_a(da, ks, prop, tables)
        gc = gc_c.T
        force = m.phase2_force(
            geom, ks, volume=jsim.volume,
            two_dimensional=jsim.cfg.two_dimensional,
            receiver_is_structure=f.is_structure(prop),
            sender_is_structure=f.is_structure(ctx.prop_j),
            pp_i=pp, pp_j=pp[j], pa_i=pa, pa_j=pa[j], gc_i=gc.T,
            gc_j=mv(gc[j]), mu_i=mu, mu_j=mu[j], vel_i=vel.T,
            vel_j=mv(vel[j]), ratio_ij=ctx.ratio_ij, ratio_ji=ctx.ratio_ji,
            cof_a_i=tables.cof_a[ctx.prop_i])
        return dict(density_a=da, gravity_center=gc_c, vol_strain=vs,
                    divergence=dvg, kappa=kappa, mu=mu, pressure_p=pp,
                    pressure_a=pa, force=force)

    want = chain(jem, jfl, jctx, vel, prop, jt)
    got = chain(em, fl, ctx, _t(vel), _t(prop), tables)
    n0 = dict(vol_strain=ks.n0p, pressure_p=float(np.max(np.asarray(
        jt.bulk_modulus))) * ks.n0p, force=float(np.abs(
            np.asarray(want["force"])).max()) * 10)
    for k in want:
        scale = float(np.abs(np.asarray(want[k])).max()) + n0.get(k, 0.0)
        close_to_scale(k, got[k], want[k], scale)
    live = ("divergence", "force") + (
        ("pressure_a", "gravity_center") if case == "jitter" else ())
    for k in live:
        assert float(np.abs(np.asarray(want[k])).max()) > 0, k


def test_radius_guards_take_density_sums_at_the_radius_and_forces_inside():
    """``_within``: `>= 0` for the phase-1 sums, `> 0` for the forces (an
    edge at exactly the radius counts in the sums only), as in JAX."""
    jsim, _ = _case("jitter")
    ks = jsim.kernels
    r = ks.radius_p
    xij = np.zeros((3, 1, 3))
    xij[0, 0] = (r, 0.5 * r, 0.0)  # at the radius, inside, and a pad
    valid = np.array([[True, True, False]])
    jg = jem.make_geometry(jax.numpy.asarray(xij), jax.numpy.asarray(valid))
    g = em.make_geometry(torch.tensor(xij), torch.tensor(valid))
    for k in jem.EdgeGeometry._fields:
        np.testing.assert_array_equal(getattr(g, k).numpy(),
                                      np.asarray(getattr(jg, k)), err_msg=k)
    for strict in (False, True):
        np.testing.assert_array_equal(
            em._within(g, r, strict=strict).numpy(),
            np.asarray(jem._within(jg, r, strict=strict)))
    assert em._within(g, r, strict=False).tolist() == [[True, True, False]]
    assert em._within(g, r, strict=True).tolist() == [[False, True, False]]


# ---------------------------------------------------------------------------
# ten steps on each engine (the analogs of tests/test_backends.py)
# ---------------------------------------------------------------------------

SCENES_10 = {
    # test_backends.py:21, :31, :40 (the last at cell capacity 8, 5 steps)
    "fluid": (mini_dam, {}, {}, 10),
    "coupled": (mini_fsi, _COUPLED, {}, 10),
    "capacity": (mini_dam, {}, {"cell_capacity": 8}, 5),
}


@functools.lru_cache(maxsize=None)
def _jax_steps(scene, backend):
    make, base, nkw, steps = SCENES_10[scene]
    cfg = dam_like_config(backend=backend, **nkw).replace(**base)
    grid = make()
    jsim = JaxSimulation(cfg, grid)
    s = jsim.state0
    for _ in range(steps):
        s = jsim.step(s)
    return cfg, grid, jax_to_numpy(s, grid.n)


def _port_steps(cfg, grid, steps):
    sim = Simulation(port_cfg(cfg), port_grid(grid), device="cpu")
    out = sim.run_chunk(sim.state0, steps)
    assert sim.rebuilds == steps and sim._ghosts is None
    assert not sim._pad_planes and not sim._margin_cached
    return sim, to_numpy(out, grid.n)


@pytest.mark.parametrize("scene", list(SCENES_10))
def test_engines_agree_and_match_jax(scene):
    """Port ``gather`` against port ``packed`` at the JAX package's bars
    between the two engines; each against its JAX engine at those bars for
    positions and at the slice's bar for velocities (rtol 1e-9 / atol 1e-13,
    ``tests/test_torch_slice.py``): the port sums in another order than
    XLA, and the coupled scene's stiff structure rows carry that rounding
    to 2.4e-15 m/s on velocities of 1e-10."""
    steps = SCENES_10[scene][3]
    got = {}
    for backend in ("gather", "packed"):
        cfg, grid, want = _jax_steps(scene, backend)
        sim, got[backend] = _port_steps(cfg, grid, steps)
        assert sim._backend == backend
        assert sim.cell_capacity == (cfg.numerics.cell_capacity or 16)
        np.testing.assert_allclose(got[backend]["pos"], want["pos"],
                                   rtol=1e-12, atol=1e-16)
        np.testing.assert_allclose(got[backend]["vel"], want["vel"],
                                   rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(got["gather"]["pos"], got["packed"]["pos"],
                               rtol=1e-12, atol=1e-16)
    if scene != "capacity":
        np.testing.assert_allclose(got["gather"]["vel"], got["packed"]["vel"],
                                   rtol=1e-10, atol=1e-15)
    # the scene moved
    assert float(np.abs(got["packed"]["pos"] - grid.position).max()) > 1e-9
