"""PyTorch port vs JAX package: the halo mode over a 2-axis mesh of
rectangles (``parallel/halo.py`` with ``sharding.make_mesh_grid``), float64
on the CPU.

The port runs as gloo ranks (``parallel/launch.spawn``, one process a rank;
each mesh shape is one spawn that drives every case of it through
``launch.run_jobs``): 2x2, 2x4 and 1x2 (an x axis of one rank: its ring is a
local copy).  The JAX package runs on its virtual 8-device mesh
(``tests/conftest.py``).  Cases, from ``tests/test_halo2d.py``:
``mini_dam`` on both local engines (``packed``; ``pallas_t``: kernels 1-2
on each rank's frame, extended by a ghost layer on each x and y side),
coupled ``mini_fsi``, the C8 frame reuse at margin 0.5 for 20 steps, the
y-periodic channel on the window sweep (the y wrap rides the y ring's
shifted ghost layer), the per-column conditional y planes on an L-shaped
density (at 2x2: ``ny == 2`` makes them conditional), and the migration
overflow at ``migration_cap=1`` (counted, deferred) with the regrow after
it.  In process, without ranks: the split planes, the default and
occupancy-sized configurations and the partition's layout equal to the JAX
package's at 1x2, 2x2, 2x4 and 4x2, and the rings' peers.

Tolerances are the JAX tests' own (``tests/test_halo.py:83-85``): types
equal, positions within rtol 1e-10 and atol 1e-14, velocities within rtol
1e-8 and atol 1e-13; rows matched by original slot id (``oid``), against
the JAX halo and against the port's one-device path."""

import dataclasses

import numpy as np
import pytest
import torch

from cases import L0, dam_like_config, mini_dam, mini_fsi
from test_torch_common import jitter, port_cfg, port_grid
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu.generator import BoidScene, Primitive, generate_grid
from particlemethod_fsi_tpu.parallel import halo as jhalo
from particlemethod_fsi_tpu.parallel.sharding import (
    make_mesh_grid as jax_mesh_grid,
)
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu_torch import convert
from particlemethod_fsi_tpu_torch.parallel import halo, launch
from particlemethod_fsi_tpu_torch.parallel.comm import Comm
from particlemethod_fsi_tpu_torch.parallel.sharding import make_mesh_grid
from particlemethod_fsi_tpu_torch.solver import Simulation
from particlemethod_fsi_tpu_torch.state import to_numpy

WIN = dict(backend="pallas_t", pallas_block=32, pallas_wmax=128)
COUPLED = dict(scene=SCENES["dam"],
               young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))
SPAWN_TIMEOUT = 110.0


def _fsi_cfg(**kw):
    return dam_like_config(**kw).replace(**COUPLED)


def _y_periodic_channel_grid():
    """y-periodic channel: a fluid strip spanning the full y extent beside
    a side wall, drifting +y so that particles wrap the y boundary
    mid-test (the scene of ``tests/test_halo2d.py``)."""
    grid = generate_grid(BoidScene(
        particle_distance=L0, lower_domain=(0.0, 0.0, 0.0),
        upper_domain=(14 * L0, 32 * L0, L0),
        primitives=[
            Primitive("Cuboid", spacing=L0, type=4, lower=(0, 0, 0),
                      upper=(3 * L0, 32 * L0, L0)),
            Primitive("Cuboid", spacing=L0, type=1, lower=(3 * L0, 0, 0),
                      upper=(9 * L0, 32 * L0, L0)),
        ]))
    grid.velocity[grid.prop == 1, 1] = 2.0
    return grid


def _l_shaped_grid():
    """A fluid floor layer across the tank and a residual column at the
    left wall: the dam-surge density where the tensor product of global
    quantiles is far out of balance (the scene of
    ``test_conditional_y_splits_balance_and_parity``), with seeded noise on
    positions and velocities: the unjittered lattice falls freely with no
    pair force, so a lost pair would not show."""
    return jitter(generate_grid(BoidScene(
        particle_distance=L0, lower_domain=(0.0, 0.0, 0.0),
        upper_domain=(60 * L0, 40 * L0, L0),
        primitives=[
            Primitive("Cuboid", spacing=L0, type=1, lower=(0.0, 0.0, 0.0),
                      upper=(60 * L0, 8 * L0, L0)),
            Primitive("Cuboid", spacing=L0, type=1, lower=(0.0, 8 * L0, 0.0),
                      upper=(12 * L0, 32 * L0, L0)),
        ])), seed=13)


def _packed_cfg():
    return dam_like_config(backend="packed")


# name -> (JAX config, grid maker, steps)
CASES = {
    "dam/packed": (_packed_cfg, mini_dam, 8),
    "dam/pallas_t": (lambda: dam_like_config(**WIN), mini_dam, 8),
    "fsi": (lambda: _fsi_cfg(backend="packed"), mini_fsi, 8),
    "fsi/pallas_t": (lambda: _fsi_cfg(**WIN), mini_fsi, 8),
    "c8": (lambda: _fsi_cfg(**WIN, rebuild_margin=0.5), mini_fsi, 20),
    "y_periodic": (lambda: dam_like_config(**WIN), _y_periodic_channel_grid,
                   14),
    "conditional": (_packed_cfg, _l_shaped_grid, 8),
    "overflow": (_packed_cfg, mini_dam, 30),
}
# the mesh shape(s) each case runs at, in the port and in the JAX package
PORT_SHAPES = {
    (2, 2): ("dam/packed", "dam/pallas_t", "fsi", "c8", "y_periodic",
             "conditional", "overflow"),
    (2, 4): ("dam/packed", "dam/pallas_t"),
    (1, 2): ("fsi/pallas_t",),
}


# cases that start from equal-count planes (conditional at ``ny == 2``), as
# the command line does: they put region corners inside the fluid, where
# corner pairs are forwarded; the others start from equal-width planes
EQUAL_COUNT = ("dam/packed", "dam/pallas_t", "fsi", "conditional")


def _planes(name, cfg, grid, shape):
    """(splits, splits_y) a case starts from (None, None: equal width)."""
    if name not in EQUAL_COUNT:
        return None, None
    sim = JaxSimulation(cfg, grid)
    valid = grid.prop >= 0
    sx = jhalo.compute_splits(sim, shape[0], grid.position, valid)
    sy = jhalo.compute_splits_y(sim, *shape, grid.position, valid,
                                splits_x=sx)
    return sx, sy


def _hcfg(name, jsim, shape, sx, sy):
    """The JAX config a case runs with (None: ``make_halo_step``'s
    default)."""
    if name == "overflow":
        return jhalo.default_halo_config(jsim, shape)._replace(
            migration_cap=1)
    if name in EQUAL_COUNT:
        return jhalo.default_halo_config(jsim, shape, splits=sx, splits_y=sy)
    return None


def _script(name, steps):
    if name == "overflow":
        return [("run", steps), ("gather",), ("regrow",), ("run", 20),
                ("gather",)]
    return [("run", steps), ("gather",)]


def _gathered(state):
    return dict(
        prop=np.asarray(state.prop), pos=np.asarray(state.pos),
        vel=np.asarray(state.vel), pos0=np.asarray(state.pos0),
        oid=np.asarray(state.oid), s_pos=np.asarray(state.s_pos),
        s_vel=np.asarray(state.s_vel),
        wall_center=np.asarray(state.wall_center), time=float(state.time))


@pytest.fixture(scope="module")
def jax_runs():
    """{(shape, case): the JAX halo of the case on that mesh}: engine,
    overflow, gathered state, and for ``overflow`` the regrow and the run
    after it."""
    out = {}
    for shape, names in PORT_SHAPES.items():
        for name in names:
            make_cfg, make_grid, steps = CASES[name]
            cfg, grid = make_cfg(), make_grid()
            sim = JaxSimulation(cfg, grid)
            mesh = jax_mesh_grid(*shape)
            sx, sy = _planes(name, cfg, grid, shape)
            hcfg = _hcfg(name, sim, shape, sx, sy)
            _, run, hcfg = jhalo.make_halo_step(sim, mesh, hcfg)
            rec = dict(engine=jhalo.make_halo_step.last_engine, hcfg=hcfg)
            state = jhalo.partition_state(sim, mesh, hcfg, splits=sx,
                                          splits_y=sy)
            state, over = run(state, steps)
            rec.update(overflow=int(over), state=jhalo.gather_state(sim, state))
            if name == "overflow":
                grown, sx2, sy2 = jhalo.regrow_config(sim, mesh, hcfg, state)
                _, run2, grown = jhalo.make_halo_step(sim, mesh, grown)
                state = jhalo.partition_state(sim, mesh, grown, splits=sx2,
                                              splits_y=sy2,
                                              state=_gathered(state))
                state, over2 = run2(state, 20)
                rec.update(grown=tuple(grown), overflow2=int(over2),
                           state2=jhalo.gather_state(sim, state))
            out[shape, name] = rec
    return out


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device trajectory of each case (slot state)."""
    out = {}
    for name, (make_cfg, make_grid, steps) in CASES.items():
        if name == "overflow":
            continue
        grid = make_grid()
        sim = Simulation(port_cfg(make_cfg()), port_grid(grid), device="cpu")
        out[name] = to_numpy(sim.run_chunk(sim.state0, steps), grid.n)
    return out


@pytest.fixture(scope="module")
def port_runs():
    """{shape: {"jobs": {case: every rank's records}, "modules": ...}}: one
    spawn of ``nx * ny`` gloo ranks per mesh shape."""
    out = {}
    for shape, names in PORT_SHAPES.items():
        jobs = []
        for name in names:
            make_cfg, make_grid, steps = CASES[name]
            cfg, grid = make_cfg(), make_grid()
            job = dict(mode="halo", mesh_shape=shape, cfg=port_cfg(cfg),
                       grid=port_grid(grid), script=_script(name, steps))
            sx, sy = _planes(name, cfg, grid, shape)
            hcfg = _hcfg(name, JaxSimulation(cfg, grid), shape, sx, sy)
            if hcfg is not None:
                job.update(hcfg=tuple(hcfg), splits=sx, splits_y=sy)
            jobs.append(job)
        ranks = launch.spawn(launch.run_jobs, shape[0] * shape[1], jobs,
                             transport="gloo", timeout=SPAWN_TIMEOUT,
                             threads=1)
        out[shape] = dict(
            jobs={n: [r["jobs"][i] for r in ranks]
                  for i, n in enumerate(names)},
            modules=[r["modules"] for r in ranks])
    return out


def _same_trajectory(got, want, n):
    """Types equal, positions and velocities at the JAX tests' bars; rows
    matched by original slot id (``want``: a gathered state, or a
    slot-ordered one with ``oid`` absent)."""
    assert got["prop"].shape[0] == n  # no particle lost
    assert np.array_equal(np.sort(got["oid"]), np.arange(n))
    if "oid" in want:
        order = np.argsort(want["oid"])
        want = {k: np.asarray(want[k])[order] for k in ("prop", "pos", "vel")}
    order = np.argsort(got["oid"])
    np.testing.assert_array_equal(got["prop"][order], want["prop"][:n])
    np.testing.assert_allclose(got["pos"][order], want["pos"][:n],
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(got["vel"][order], want["vel"][:n],
                               rtol=1e-8, atol=1e-13)


def _records(port_runs, shape, name):
    """(rank 0's records, every rank's records)."""
    ranks = port_runs[shape]["jobs"][name]
    return ranks[0], ranks


def _check_case(port_runs, jax_runs, one_device, shape, name, engine):
    recs, ranks = _records(port_runs, shape, name)
    setup, run, gathered = recs[:3]
    want = jax_runs[shape, name]
    n = CASES[name][1]().n
    assert setup["engine"] == want["engine"] == engine
    assert setup["hcfg"][3] > 0  # a y halo
    assert run["overflow"] == want["overflow"] == 0
    _same_trajectory(gathered["state"], one_device[name], n)
    _same_trajectory(gathered["state"], want["state"], n)
    # the replicated planes and structure stay bit-identical on every rank
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[2]["s_pos"], gathered["s_pos"])
        np.testing.assert_array_equal(r[2]["splits_y"], gathered["splits_y"])
    return setup, run, gathered


@pytest.mark.parametrize("engine", ["packed", "pallas_t"])
@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_dam_matches_one_device_and_jax(port_runs, jax_runs, one_device,
                                        shape, engine):
    """The collapsing dam on rectangles: migration across x planes, strips
    along both axes, corner pairs forwarded through the x ghosts."""
    setup, _, gathered = _check_case(port_runs, jax_runs, one_device, shape,
                                     f"dam/{engine}", engine)
    assert gathered["splits_y"].shape == (shape[0], shape[1] + 1)
    if engine == "pallas_t":
        # own + both x strips + both y strips fill whole receiver blocks
        cap, _, hal, hal_y = setup["hcfg"]
        assert (cap + 2 * hal + 2 * hal_y) % 32 == 0


def test_coupled_fsi_matches_one_device_and_jax(port_runs, jax_runs,
                                                one_device):
    """Coupled FSI at 2x2 (packed): the structure's owner is a rectangle
    (half-open in x and y) and its owner sums span every rank."""
    _check_case(port_runs, jax_runs, one_device, (2, 2), "fsi", "packed")


def test_one_by_two_rings_x_to_itself(port_runs, jax_runs, one_device):
    """1x2: the x axis has one rank, so its ring is a local copy (the
    window sweep's x ghost duplication) inside a world of two, while the y
    ring reaches the other rank."""
    _check_case(port_runs, jax_runs, one_device, (1, 2), "fsi/pallas_t",
                "pallas_t")


def test_c8_frame_reuse_matches_one_device_and_jax(port_runs, jax_runs,
                                                   one_device):
    """C8 reuse at 2x2: the predicate is a MAX over every rank and the
    cached y strips stay valid across reused steps."""
    _, run, _ = _check_case(port_runs, jax_runs, one_device, (2, 2), "c8",
                            "pallas_t")
    assert 1 <= run["rebuilds"] < 20  # the frame was reused


def test_y_periodic_wrap_on_the_window_sweep(port_runs, jax_runs,
                                             one_device):
    """A y-periodic scene keeps the window sweep on a 2-axis mesh (on x
    slabs it takes the packed engine): pairs across the y boundary ride the
    y ring's ghost layer, shifted by the domain height, and a particle that
    wraps from ymax to y0 migrates one hop."""
    grid = _y_periodic_channel_grid()
    psim = Simulation(port_cfg(CASES["y_periodic"][0]()), port_grid(grid),
                      device="cpu")
    one_d = halo.make_halo_step(psim, Comm.local())
    assert one_d.engine == "packed"  # x slabs: the y wrap has no ring
    _, _, gathered = _check_case(port_runs, jax_runs, one_device, (2, 2),
                                 "y_periodic", "pallas_t")
    g = gathered["state"]
    y0 = grid.position[g["oid"], 1]
    assert np.any(y0 - g["pos"][:, 1] > 20e-3), "no particle wrapped"


def test_conditional_y_splits_balance_and_parity(port_runs, jax_runs,
                                                 one_device):
    """Per-column conditional y planes at 2x2 on the L-shaped density: the
    port's planes equal the JAX package's, the columns' planes differ, the
    regions are near balance (the global planes are not), and the run
    holds against one device and JAX."""
    cfg, grid = CASES["conditional"][0](), _l_shaped_grid()
    psim = Simulation(port_cfg(cfg), port_grid(grid), device="cpu")
    valid = grid.prop >= 0
    sx, sy = _planes("conditional", cfg, grid, (2, 2))
    np.testing.assert_array_equal(
        halo.compute_splits(psim, 2, grid.position, valid), sx)
    got = halo.compute_splits_y(psim, 2, 2, grid.position, valid,
                                splits_x=sx)
    np.testing.assert_array_equal(got, sy)
    assert got.shape == (2, 3) and not np.allclose(got[0], got[1])
    counts = np.bincount(halo._dest_regions(grid.position[valid], sx, got,
                                            2, 2), minlength=4)
    assert counts.max() / counts.mean() < 1.10, counts
    gq = np.tile(halo.compute_splits(psim, 2, grid.position, valid, axis=1),
                 (2, 1))
    gcounts = np.bincount(halo._dest_regions(grid.position[valid], sx, gq,
                                             2, 2), minlength=4)
    assert gcounts.max() / gcounts.mean() > 1.25, gcounts
    _, _, gathered = _check_case(port_runs, jax_runs, one_device, (2, 2),
                                 "conditional", "packed")
    np.testing.assert_array_equal(gathered["splits_y"], sy)


def test_overflow_is_counted_and_migrants_deferred(port_runs, jax_runs):
    """A one-slot migration buffer overflows on the collapsing dam at 2x2:
    counted as in the JAX step (both stages), no particle lost; the regrow
    after it (both axes' caps doubled, fresh planes) runs clean."""
    _, run, gathered, regrow, run2, gathered2 = _records(
        port_runs, (2, 2), "overflow")[0]
    want = jax_runs[(2, 2), "overflow"]
    n = mini_dam().n
    assert run["overflow"] > 0
    assert run["overflow"] == want["overflow"]
    _same_trajectory(gathered["state"], want["state"], n)
    assert regrow["hcfg"] == want["grown"]
    assert run2["overflow"] == want["overflow2"] == 0
    _same_trajectory(gathered2["state"], want["state2"], n)


def test_ranks_import_neither_jax_nor_the_jax_package(port_runs):
    for shape in PORT_SHAPES:
        for mods in port_runs[shape]["modules"]:
            assert not {"jax", "jaxlib", "flax",
                        "particlemethod_fsi_tpu"} & set(mods)


# ---------------------------------------------------------------------------
# host side, in process
# ---------------------------------------------------------------------------

HOST_SHAPES = [(1, 2), (2, 2), (2, 4), (4, 2)]


def _fake_comm(rank, shape):
    """A rank's coordinates on the mesh, for the host-side functions (no
    process group: no collective may run)."""
    nx, ny = shape
    return make_mesh_grid(Comm(rank, nx * ny, torch.device("cpu"), "gloo"),
                          nx, ny)


def _jax_fields(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


@pytest.mark.parametrize("shape", HOST_SHAPES, ids=lambda s: "%dx%d" % s)
def test_planes_config_and_partition_layout_equal_jax(shape):
    nx, ny = shape
    cfg, grid = _fsi_cfg(**WIN), mini_fsi()
    jsim = JaxSimulation(cfg, grid)
    psim = Simulation(port_cfg(cfg), port_grid(grid), device="cpu")
    pos = np.asarray(jsim.state0.pos)
    valid = np.asarray(jsim.state0.prop) >= 0
    sx = jhalo.compute_splits(jsim, nx, pos, valid)
    sy = jhalo.compute_splits_y(jsim, nx, ny, pos, valid, splits_x=sx)
    np.testing.assert_array_equal(
        halo.compute_splits_y(psim, nx, ny, psim.state0.pos,
                              psim.state0.prop >= 0, splits_x=sx), sy)
    np.testing.assert_array_equal(
        halo.compute_splits_y(psim, nx, ny, pos, valid),
        jhalo.compute_splits_y(jsim, nx, ny, pos, valid))
    np.testing.assert_array_equal(halo.normalize_splits_y(sy[0], nx, ny),
                                  jhalo.normalize_splits_y(sy[0], nx, ny))
    with pytest.raises(ValueError, match="splits_y shape"):
        halo.normalize_splits_y(np.zeros((nx + 1, ny + 1)), nx, ny)
    hcfg = jhalo.default_halo_config(jsim, shape)
    assert tuple(halo.default_halo_config(psim, shape)) == tuple(hcfg)
    assert hcfg.halo_cap_y > 0
    sized = jhalo.default_halo_config(jsim, shape, splits=sx, splits_y=sy,
                                      npad_floor=False)
    assert tuple(halo.default_halo_config(
        psim, shape, splits=sx, splits_y=sy, npad_floor=False)) == \
        tuple(sized)
    want = _jax_fields(jhalo.partition_state(jsim, jax_mesh_grid(nx, ny),
                                             hcfg, splits=sx, splits_y=sy))
    states = [halo.partition_state(psim, _fake_comm(r, shape),
                                   halo.HaloConfig(*hcfg), splits=sx,
                                   splits_y=sy) for r in range(nx * ny)]
    got = convert.halo_state_to_numpy(states)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and back: the JAX partition as each rank's port state
    for r, s in enumerate(states):
        back = convert.halo_state_from_numpy(want, r, nx * ny,
                                             dtype=torch.float64)
        for k in halo.HaloState._fields:
            assert torch.equal(getattr(back, k), getattr(s, k)), k


@pytest.mark.parametrize("shape", HOST_SHAPES, ids=lambda s: "%dx%d" % s)
def test_regrow_and_adapt_return_the_jax_planes(shape):
    """``regrow_sizes`` and ``adapt_sizes`` on the JAX partition's rows:
    the planes of both axes equal the JAX ``regrow_config`` /
    ``adapt_config``'s, and so do the grown caps."""
    cfg, grid = _fsi_cfg(**WIN), mini_fsi()
    jsim = JaxSimulation(cfg, grid)
    psim = Simulation(port_cfg(cfg), port_grid(grid), device="cpu")
    mesh = jax_mesh_grid(*shape)
    hcfg = jhalo.default_halo_config(jsim, shape)
    state = jhalo.partition_state(jsim, mesh, hcfg)
    prop, pos = np.asarray(state.prop), np.asarray(state.pos)
    j_grown, j_sx, j_sy = jhalo.regrow_config(jsim, mesh, hcfg, state)
    grown, sx, sy = halo.regrow_sizes(psim, shape, halo.HaloConfig(*hcfg),
                                      prop, pos)
    assert tuple(grown) == tuple(j_grown)
    np.testing.assert_array_equal(sx, j_sx)
    np.testing.assert_array_equal(sy, j_sy)
    _, j_sx, j_sy, _ = jhalo.adapt_config(jsim, mesh, hcfg, state)
    new, sx, sy, _ = halo.adapt_sizes(psim, shape, halo.HaloConfig(*hcfg),
                                      prop, pos)
    np.testing.assert_array_equal(sx, j_sx)
    np.testing.assert_array_equal(sy, j_sy)
    assert new.halo_cap_y > 0


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (4, 2), (2, 4)],
                         ids=lambda s: "%dx%d" % s)
def test_ring_peers_follow_the_row_major_block_index(shape):
    """Rank ``ix * ny + iy`` (the JAX mesh's block index): the x ring's
    peers are ``rank +- ny``, the y ring's ``ix * ny + (iy +- 1) % ny``."""
    nx, ny = shape
    for r in range(nx * ny):
        c = _fake_comm(r, shape)
        ix, iy = c.coords
        assert (ix, iy) == (r // ny, r % ny)
        assert c._peer(0, +1) == (r + ny) % (nx * ny)
        assert c._peer(0, -1) == (r - ny) % (nx * ny)
        assert c._peer(1, +1) == ix * ny + (iy + 1) % ny
        assert c._peer(1, -1) == ix * ny + (iy - 1) % ny


def test_mesh_grid_raises_as_jax_where_it_needs_more_devices():
    with pytest.raises(ValueError) as want:
        jax_mesh_grid(4, 4)  # 16 of the 8 virtual devices
    with pytest.raises(ValueError) as got:
        make_mesh_grid(Comm(0, 8, torch.device("cpu"), "gloo"), 4, 4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="every rank must own a region"):
        make_mesh_grid(Comm(0, 8, torch.device("cpu"), "gloo"), 2, 2)
    # a 2-axis mesh without a y halo is refused as in JAX
    cfg, grid = _packed_cfg(), mini_dam()
    psim = Simulation(port_cfg(cfg), port_grid(grid), device="cpu")
    with pytest.raises(ValueError, match="halo_cap_y > 0"):
        halo.make_halo_step(psim, _fake_comm(0, (2, 2)),
                            halo.HaloConfig(1024, 256, 256, 0))
