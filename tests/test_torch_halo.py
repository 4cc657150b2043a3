"""PyTorch port vs JAX package: the 1-D slab halo mode
(``parallel/halo.py``), float64 on the CPU.

The port runs as 1, 2 and 4 gloo ranks (``parallel/launch.spawn``, one
process a rank; each world size is one spawn that drives every case of it
through ``launch.run_jobs``), the JAX package on its virtual 8-device mesh
(``tests/conftest.py``).  Cases, from ``tests/test_halo.py``: ``mini_fsi``
coupled for 8 steps on both local engines (``pallas_t``: the window sweep on
the halo frame; ``packed``), the C8 frame reuse at margin 0.5 for 20 steps,
the x-periodic channel across the wrap, the migration overflow (counted,
deferred) and the regrow after it, the guarded chunk, equal-count splits
where equal-width slabs overflow.  In process, without ranks: the default
configuration, the split planes and the partition's layout equal to the
JAX package's, and the three places where the port's host code departs
from it (each beside the JAX behaviour).

Tolerances are the JAX tests' own (``tests/test_halo.py:83-85``): types
equal, positions within rtol 1e-10 and atol 1e-14, velocities within rtol
1e-8 and atol 1e-13, rows matched by position; against the JAX halo and
against the port's one-device path (summation order differs)."""

import dataclasses

import numpy as np
import pytest
import torch

from cases import dam_like_config, mini_dam, mini_fsi
from test_torch_common import port_cfg, port_grid
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu.generator import BoidScene, Primitive, generate_grid
from particlemethod_fsi_tpu.parallel import halo as jhalo
from particlemethod_fsi_tpu.parallel.sharding import make_mesh
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu_torch import convert
from particlemethod_fsi_tpu_torch.parallel import halo, launch
from particlemethod_fsi_tpu_torch.parallel.comm import Comm
from particlemethod_fsi_tpu_torch.solver import Simulation
from particlemethod_fsi_tpu_torch.state import to_numpy

L0 = 1.0e-3
WIN = dict(backend="pallas_t", pallas_block=32, pallas_wmax=128)
ENGINES = {"pallas_t": WIN, "packed": dict(backend="packed")}
COUPLED = dict(scene=SCENES["dam"],
               young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))
WORLDS = (1, 2, 4)
SPAWN_TIMEOUT = 110.0


def _fsi_cfg(**kw):
    return dam_like_config(**kw).replace(**COUPLED)


def _periodic_channel_grid():
    """x-periodic channel: fluid strip spanning the full x extent between
    bottom walls, drifting +x so particles wrap the boundary mid-test (the
    scene of ``tests/test_halo.py``)."""
    grid = generate_grid(BoidScene(
        particle_distance=L0, lower_domain=(0.0, 0.0, 0.0),
        upper_domain=(32 * L0, 14 * L0, L0),
        primitives=[
            Primitive("Cuboid", spacing=L0, type=4, lower=(0, 0, 0),
                      upper=(32 * L0, 3 * L0, L0)),
            Primitive("Cuboid", spacing=L0, type=1, lower=(0, 3 * L0, 0),
                      upper=(32 * L0, 9 * L0, L0)),
        ]))
    grid.velocity[grid.prop == 1, 0] = 2.0
    return grid


def _skewed_grid():
    """All the water in the left tenth of a wide domain (the scene of
    ``test_equal_count_splits_where_equal_width_overflows``)."""
    return generate_grid(BoidScene(
        particle_distance=L0, lower_domain=(0.0, 0.0, 0.0),
        upper_domain=(80 * L0, 40 * L0, L0),
        primitives=[
            Primitive("Cuboid", spacing=L0, type=1, lower=(L0, 3 * L0, 0.0),
                      upper=(9 * L0, 33 * L0, L0)),
            Primitive("Cuboid", spacing=L0, type=4, lower=(0.0, 0.0, 0.0),
                      upper=(80 * L0, 3 * L0, L0)),
        ]))


def _diverging_cfg():
    cfg = dam_like_config(backend="packed")
    return cfg.replace(dt=cfg.dt * 2000.0, elastic_dt=cfg.elastic_dt * 2000.0)


SKEW_HCFG = (256, 128, 256, 0)  # 4 x 256 slots for 480 particles

# name -> (JAX config, grid builder, steps); every case's one-device
# reference and JAX reference run the same steps in one chunk
CASES = {
    "fsi/pallas_t": (lambda: _fsi_cfg(**WIN), mini_fsi, 8),
    "fsi/packed": (lambda: _fsi_cfg(backend="packed"), mini_fsi, 8),
    "c8": (lambda: _fsi_cfg(**WIN, rebuild_margin=0.5), mini_fsi, 20),
    "periodic": (lambda: dam_like_config(**WIN), _periodic_channel_grid, 14),
    "overflow": (lambda: dam_like_config(backend="packed"), mini_dam, 30),
    "guarded": (_diverging_cfg, mini_dam, 50),
    "equal_count": (lambda: dam_like_config(backend="packed"), _skewed_grid,
                    20),
}
# the world sizes each case runs at, and the one the JAX package runs
PORT_WORLDS = {"fsi/pallas_t": WORLDS, "fsi/packed": WORLDS, "c8": WORLDS,
               "periodic": (2, 4), "overflow": (2,), "guarded": (2,),
               "equal_count": (4,)}
JAX_WORLD = {"fsi/pallas_t": 4, "fsi/packed": 4, "c8": 4, "periodic": 2,
             "overflow": 2, "guarded": 2}


# fresh-frame steps (``HaloStep.step``) from the JAX package's partition
STEP_WORLD, STEP_STEPS = 2, 3


def _mig1_hcfg(jsim, ndev):
    return jhalo.default_halo_config(jsim, ndev)._replace(migration_cap=1)


def _script(name, steps):
    if name == "overflow":
        return [("run", steps), ("gather",), ("regrow",), ("run", 20),
                ("gather",)]
    if name == "guarded":
        return [("guarded", steps)]
    return [("run", steps), ("gather",)]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX halo of each case on its mesh: engine, overflow, gathered
    state (and for ``overflow`` the regrow that follows)."""
    out = {}
    for name, ndev in JAX_WORLD.items():
        make_cfg, make_grid, steps = CASES[name]
        sim = JaxSimulation(make_cfg(), make_grid())
        mesh = make_mesh(ndev)
        hcfg = _mig1_hcfg(sim, ndev) if name == "overflow" else None
        _, run, hcfg = jhalo.make_halo_step(sim, mesh, hcfg)
        rec = dict(engine=jhalo.make_halo_step.last_engine, hcfg=hcfg)
        state = jhalo.partition_state(sim, mesh, hcfg)
        if name == "guarded":
            _, over, done, ok = run.guarded(state, steps)
            rec.update(done=int(done), ok=bool(ok))
            out[name] = rec
            continue
        state, over = run(state, steps)
        rec.update(overflow=int(over), state=jhalo.gather_state(sim, state))
        if name == "overflow":
            grown, splits, splits_y = jhalo.regrow_config(sim, mesh, hcfg,
                                                          state)
            gathered = dict(
                prop=np.asarray(state.prop), pos=np.asarray(state.pos),
                vel=np.asarray(state.vel), pos0=np.asarray(state.pos0),
                oid=np.asarray(state.oid), s_pos=np.asarray(state.s_pos),
                s_vel=np.asarray(state.s_vel),
                wall_center=np.asarray(state.wall_center),
                time=float(state.time))
            _, run2, grown = jhalo.make_halo_step(sim, mesh, grown)
            state = jhalo.partition_state(sim, mesh, grown, splits=splits,
                                          splits_y=splits_y, state=gathered)
            state, over2 = run2(state, 20)
            rec.update(grown=tuple(grown), overflow2=int(over2),
                       state2=jhalo.gather_state(sim, state))
        out[name] = rec
    return out


@pytest.fixture(scope="module")
def jax_step():
    """The JAX halo ``step`` (a fresh frame a step) on coupled ``mini_fsi``
    over ``STEP_WORLD`` devices: its partition as numpy (the port's ranks
    start from it), the gathered state after ``STEP_STEPS`` steps and the
    largest overflow."""
    make_cfg, make_grid, _ = CASES["fsi/pallas_t"]
    sim = JaxSimulation(make_cfg(), make_grid())
    mesh = make_mesh(STEP_WORLD)
    step, _, hcfg = jhalo.make_halo_step(sim, mesh)
    state = jhalo.partition_state(sim, mesh, hcfg)
    fields = _jax_fields(state)
    over = 0
    for _ in range(STEP_STEPS):
        state, o = step(state)
        over = max(over, int(o))
    return dict(hcfg=tuple(hcfg), fields=fields, overflow=over,
                state=jhalo.gather_state(sim, state))


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device trajectory of each case (slot state)."""
    out = {}
    for name, (make_cfg, make_grid, steps) in CASES.items():
        if name in ("overflow", "guarded"):
            continue
        grid = make_grid()
        sim = Simulation(port_cfg(make_cfg()), port_grid(grid), device="cpu")
        out[name] = to_numpy(sim.run_chunk(sim.state0, steps), grid.n)
    return out


@pytest.fixture(scope="module")
def port_runs(jax_step):
    """{world: {case: records}}: one spawn of ``world`` gloo ranks per world
    size, running every case of that size through ``launch.run_jobs``
    (and at ``STEP_WORLD`` the fresh-frame steps from the JAX partition)."""
    out = {}
    for world in WORLDS:
        names = [n for n in CASES if world in PORT_WORLDS[n]]
        jobs = []
        for name in names:
            make_cfg, make_grid, steps = CASES[name]
            cfg, grid = make_cfg(), make_grid()
            job = dict(mode="halo", cfg=port_cfg(cfg), grid=port_grid(grid),
                       script=_script(name, steps))
            if name == "overflow":
                job["hcfg"] = tuple(_mig1_hcfg(JaxSimulation(cfg, grid),
                                               world))
            if name == "equal_count":
                job["hcfg"] = SKEW_HCFG
                job["splits"] = jhalo.compute_splits(
                    JaxSimulation(cfg, grid), world, grid.position,
                    grid.prop >= 0)
            jobs.append(job)
        if world == STEP_WORLD:
            make_cfg, make_grid, _ = CASES["fsi/pallas_t"]
            names.append("step")
            jobs.append(dict(
                mode="halo", cfg=port_cfg(make_cfg()),
                grid=port_grid(make_grid()), hcfg=jax_step["hcfg"],
                halo_state=jax_step["fields"],
                script=[("step", STEP_STEPS), ("gather",)]))
        ranks = launch.spawn(launch.run_jobs, world, jobs, transport="gloo",
                             timeout=SPAWN_TIMEOUT, threads=1)
        out[world] = dict(
            jobs={n: [r["jobs"][i] for r in ranks]
                  for i, n in enumerate(names)},
            modules=[r["modules"] for r in ranks])
    return out


def _by_pos(prop, pos, vel):
    order = np.lexsort((pos[:, 2], pos[:, 1], pos[:, 0]))
    return prop[order], pos[order], vel[order]


def _same_trajectory(got, want, n):
    """Types equal, positions and velocities at the JAX tests' bars, rows
    matched by position."""
    assert got["prop"].shape[0] == n  # no particle lost
    a = _by_pos(want["prop"][:n], want["pos"][:n], want["vel"][:n])
    b = _by_pos(got["prop"], got["pos"], got["vel"])
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(b[1], a[1], rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(b[2], a[2], rtol=1e-8, atol=1e-13)


def _records(port_runs, world, name):
    """(rank 0's records by op, every rank's records)."""
    ranks = port_runs[world]["jobs"][name]
    return ranks[0], ranks


@pytest.mark.parametrize("engine", ["pallas_t", "packed"])
@pytest.mark.parametrize("world", WORLDS)
def test_coupled_fsi_matches_one_device_and_jax(port_runs, jax_runs,
                                                one_device, world, engine):
    name = f"fsi/{engine}"
    recs, ranks = _records(port_runs, world, name)
    setup, run, gathered = recs
    n = mini_fsi().n
    assert setup["engine"] == jax_runs[name]["engine"] == engine
    assert run["overflow"] == jax_runs[name]["overflow"] == 0
    _same_trajectory(gathered["state"], one_device[name], n)
    if world == JAX_WORLD[name]:
        _same_trajectory(gathered["state"], jax_runs[name]["state"], n)
    # the replicated structure stays bit-identical on every rank
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[-1]["s_pos"], gathered["s_pos"])


@pytest.mark.parametrize("world", WORLDS)
def test_c8_frame_reuse_matches_one_device_and_jax(port_runs, jax_runs,
                                                   one_device, world):
    setup, run, gathered = _records(port_runs, world, "c8")[0]
    assert setup["engine"] == jax_runs["c8"]["engine"] == "pallas_t"
    assert run["overflow"] == jax_runs["c8"]["overflow"] == 0
    assert 1 <= run["rebuilds"] < 20  # the frame was reused
    n = mini_fsi().n
    _same_trajectory(gathered["state"], one_device["c8"], n)
    if world == JAX_WORLD["c8"]:
        _same_trajectory(gathered["state"], jax_runs["c8"]["state"], n)


@pytest.mark.parametrize("world", [2, 4])
def test_x_periodic_wrap_matches_one_device_and_jax(port_runs, jax_runs,
                                                    one_device, world):
    """Pairs across the global boundary ride the ring's shifted ghost
    layer, and a particle that wraps from xmax to x0 migrates one hop."""
    setup, run, gathered = _records(port_runs, world, "periodic")[0]
    assert setup["engine"] == jax_runs["periodic"]["engine"] == "pallas_t"
    assert run["overflow"] == jax_runs["periodic"]["overflow"] == 0
    grid = _periodic_channel_grid()
    g = gathered["state"]
    x0 = grid.position[g["oid"], 0]
    assert np.any(x0 - g["pos"][:, 0] > 20e-3), "no particle wrapped"
    _same_trajectory(g, one_device["periodic"], grid.n)
    if world == JAX_WORLD["periodic"]:
        _same_trajectory(g, jax_runs["periodic"]["state"], grid.n)


def test_step_from_the_jax_partition_matches_jax_step(port_runs, jax_step):
    """Both packages start from one partition (the JAX package's, each
    rank's block through ``convert.halo_state_from_numpy``) and take
    fresh-frame steps: ``HaloStep.step`` against the JAX ``step``."""
    setup, step, gathered = _records(port_runs, STEP_WORLD, "step")[0]
    assert setup["engine"] == "pallas_t"
    assert setup["hcfg"] == jax_step["hcfg"]
    assert step["overflow"] == jax_step["overflow"] == 0
    _same_trajectory(gathered["state"], jax_step["state"], mini_fsi().n)


def test_overflow_is_reported_and_migrants_deferred(port_runs, jax_runs):
    """A one-slot migration buffer overflows on the collapsing dam: counted
    as in the JAX step, and no particle is lost."""
    _, run, gathered, *_ = _records(port_runs, 2, "overflow")[0]
    assert run["overflow"] > 0
    assert run["overflow"] == jax_runs["overflow"]["overflow"]
    n = mini_dam().n
    assert np.array_equal(np.sort(gathered["state"]["oid"]), np.arange(n))
    _same_trajectory(gathered["state"], jax_runs["overflow"]["state"], n)


def test_regrow_after_saturation_runs_clean(port_runs, jax_runs):
    *_, regrow, run2, gathered2 = _records(port_runs, 2, "overflow")[0]
    assert regrow["hcfg"] == jax_runs["overflow"]["grown"]
    assert run2["overflow"] == jax_runs["overflow"]["overflow2"] == 0
    n = mini_dam().n
    _same_trajectory(gathered2["state"], jax_runs["overflow"]["state2"], n)


def test_guarded_chunk_stops_at_divergence(port_runs, jax_runs):
    _, guarded = _records(port_runs, 2, "guarded")[0]
    assert not guarded["ok"] and not jax_runs["guarded"]["ok"]
    assert 0 < guarded["done"] < 50
    assert guarded["done"] == jax_runs["guarded"]["done"]


def test_equal_count_splits_where_equal_width_overflows(port_runs,
                                                       one_device):
    grid = _skewed_grid()
    cfg = dam_like_config(backend="packed")
    psim = Simulation(port_cfg(cfg), port_grid(grid), device="cpu")
    hcfg = halo.HaloConfig(*SKEW_HCFG)
    with pytest.raises(ValueError, match="capacity"):
        halo.partition_state(psim, _fake_comm(0, 4), hcfg)
    want = jhalo.compute_splits(JaxSimulation(cfg, grid), 4, grid.position,
                                grid.prop >= 0)
    got = halo.compute_splits(psim, 4, grid.position, grid.prop >= 0)
    np.testing.assert_array_equal(got, want)
    _, run, gathered = _records(port_runs, 4, "equal_count")[0]
    assert run["overflow"] == 0
    _same_trajectory(gathered["state"], one_device["equal_count"], grid.n)


def test_ranks_import_neither_jax_nor_the_jax_package(port_runs):
    for world in WORLDS:
        for mods in port_runs[world]["modules"]:
            assert not {"jax", "jaxlib", "flax",
                        "particlemethod_fsi_tpu"} & set(mods)


# ---------------------------------------------------------------------------
# host side, in process
# ---------------------------------------------------------------------------

def _fake_comm(rank, size):
    """A rank's coordinates for the host-side functions, which read only
    ``rank`` and ``size`` (no process group: no collective may run)."""
    return Comm(rank, size, torch.device("cpu"), "gloo")


def _sims(make_cfg=lambda: _fsi_cfg(**WIN), make_grid=mini_fsi):
    cfg, grid = make_cfg(), make_grid()
    return (JaxSimulation(cfg, grid),
            Simulation(port_cfg(cfg), port_grid(grid), device="cpu"))


def _jax_fields(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


@pytest.mark.parametrize("world", WORLDS)
def test_config_splits_and_partition_layout_equal_jax(world):
    jsim, psim = _sims()
    hcfg = jhalo.default_halo_config(jsim, world)
    assert tuple(halo.default_halo_config(psim, world)) == tuple(hcfg)
    pos = np.asarray(jsim.state0.pos)
    valid = np.asarray(jsim.state0.prop) >= 0
    splits = jhalo.compute_splits(jsim, world, pos, valid)
    np.testing.assert_array_equal(
        halo.compute_splits(psim, world, psim.state0.pos,
                            psim.state0.prop >= 0), splits)
    sized = jhalo.default_halo_config(jsim, world, splits=splits,
                                      npad_floor=False)
    assert tuple(halo.default_halo_config(
        psim, world, splits=splits, npad_floor=False)) == tuple(sized)
    want = _jax_fields(jhalo.partition_state(jsim, make_mesh(world), hcfg,
                                             splits=splits))
    states = [halo.partition_state(psim, _fake_comm(r, world),
                                   halo.HaloConfig(*hcfg), splits=splits)
              for r in range(world)]
    got = convert.halo_state_to_numpy(states)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and back: the JAX partition as each rank's port state
    for r, s in enumerate(states):
        back = convert.halo_state_from_numpy(want, r, world,
                                             dtype=torch.float64)
        for k in halo.HaloState._fields:
            assert torch.equal(getattr(back, k), getattr(s, k)), k


def _slab_state(ndev):
    """mini_dam on ``ndev`` slabs (JAX): the sims, the mesh and the
    partitioned state."""
    jsim, psim = _sims(lambda: dam_like_config(backend="packed"), mini_dam)
    mesh = make_mesh(ndev)
    hcfg = jhalo.default_halo_config(jsim, ndev)
    return jsim, psim, mesh, jhalo.partition_state(jsim, mesh, hcfg)


def test_adapt_clamps_the_fresh_caps_before_comparing():
    """Deviation 1 (JAX ``halo.py:550``): on four slabs of mini_dam the
    geometry-sized halo cap (256 rows) exceeds the occupancy-sized capacity
    (128).  Run as the step clamps it, the JAX ``adapt_config`` still reads
    its own unclamped fresh config as growth at every output; the port's
    holds."""
    jsim, psim, mesh, state = _slab_state(4)
    q = 128
    fresh, _, _, _ = jhalo.adapt_config(
        jsim, mesh, jhalo.HaloConfig(q, q, q, 0), state, quantum=q)
    assert fresh.halo_cap > fresh.capacity  # the sparse-scene premise
    running = halo.clamp_config(halo.HaloConfig(*fresh))
    j_new, _, _, j_changed = jhalo.adapt_config(
        jsim, mesh, jhalo.HaloConfig(*running), state, quantum=q)
    assert j_changed and j_new.halo_cap > j_new.capacity  # JAX: spurious
    prop, pos = np.asarray(state.prop), np.asarray(state.pos)
    new, _, _, changed = halo.adapt_sizes(psim, 4, running, prop, pos,
                                       quantum=q)
    assert not changed and new == running  # port: holds


def test_adapt_shrinks_an_inflated_migration_cap():
    """Deviation 2 (JAX ``halo.py:559``): on one slab of mini_dam, a config
    inflated only in its migration cap (as a regrow leaves it) never
    shrinks under the JAX shrink metric (capacity + halo rows); the port's
    metric counts the migration buffers, and it shrinks back."""
    jsim, psim, mesh, state = _slab_state(1)
    q = 128
    prop, pos = np.asarray(state.prop), np.asarray(state.pos)
    j_fresh, _, _, _ = jhalo.adapt_config(
        jsim, mesh, jhalo.HaloConfig(q, q, q, 0), state, quantum=q)
    fresh, _, _, _ = halo.adapt_sizes(psim, 1, halo.HaloConfig(q, q, q, 0),
                                   prop, pos, quantum=q)
    assert tuple(fresh) == tuple(j_fresh)  # no cap above the capacity here
    fat = fresh._replace(migration_cap=fresh.migration_cap + 4 * q)
    j_new, _, _, j_changed = jhalo.adapt_config(
        jsim, mesh, jhalo.HaloConfig(*fat), state, quantum=q)
    assert not j_changed and tuple(j_new) == tuple(fat)  # JAX: stays fat
    new, _, _, changed = halo.adapt_sizes(psim, 1, fat, prop, pos,
                                          quantum=q)
    assert changed and new == fresh  # port: shrinks back


def test_regrow_trigger_scales_with_the_margin():
    """Deviation 3 (JAX ``cli.py:699``): the JAX command line regrows where
    the fullest region passes 0.95 of the capacity, whatever the margin;
    the port where it passes 1 / margin, the fill the margin sizes for.  At
    margin 1.2 a region at 90 % fill regrows in the port only; and right
    after an adaptive sizing at 1.08 neither fires (no regrow thrash)."""
    hcfg = halo.HaloConfig(1000, 256, 256, 0)
    occ = 900
    assert not occ > 0.95 * hcfg.capacity  # the JAX command line's test
    assert halo.regrow_wanted(occ, hcfg, 1.2)
    assert not halo.regrow_wanted(800, hcfg, 1.2)
    jsim, psim, mesh, state = _slab_state(4)
    prop, pos = np.asarray(state.prop), np.asarray(state.pos)
    new, splits, _, _ = halo.adapt_sizes(
        psim, 4, halo.HaloConfig(128, 128, 128, 0), prop, pos, quantum=128)
    dest = np.clip(np.searchsorted(splits, pos[prop >= 0, 0], side="right")
                   - 1, 0, 3)
    fullest = int(np.bincount(dest, minlength=4).max())
    assert not halo.regrow_wanted(fullest, new, 1.08)
