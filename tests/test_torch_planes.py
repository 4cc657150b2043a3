"""PyTorch port vs JAX package: 3-D frames with plane padding, float64 on the
CPU (the plain versions of the kernels; the JAX side runs its Pallas kernels
in interpret mode, one compile a case shared by the tests).

* ``packed_engine.pad_frame_planes`` against the JAX function on the same
  sorted frame, float64 and float32: key, type, position and velocity equal
  to the last bit; ``orig`` equal on the real rows, the pads given the
  unused indices ``[n, n_out)`` (the port's unsort is a scatter);
* the trap of the row rule's run search: some window of a plane-padded
  frame spans a plane end, and there the staged linear cells (``INT_MIN``
  for a pad, searched as unsigned, as the first design of kernels 4 and 6
  searched them) are not sorted and a binary search in them misses
  senders of a receiver's ring, while the keys stay sorted and find every
  one;
* one step's phase-1 fields and forces, both backends, against JAX
  ``pallas_t`` (rtol 1e-12 of the field's scale), and twelve steps (pos
  rtol 1e-12 / atol 1e-15, vel rtol 1e-9 / atol 1e-13: the JAX package's
  bar between its backends); the C8 skip on a plane-padded frame (margin
  1.0 against margin 0, the analog of ``tests/test_backends.py``'s 3-D C8
  parity, and a skip step's frame: the plane pads poisoned again); a 3-D
  ``diagnostics`` call; an x-periodic 3-D scene, where ghost
  rows and plane pads share a frame, against JAX ``packed``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cases import config_3d, mini_dam_3d
from test_torch_common import jitter, port_cfg, port_frame, port_grid
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.generator import BoidScene, Primitive, generate_grid
from particlemethod_fsi_tpu.ops import packed_engine as jpk
from particlemethod_fsi_tpu.ops import pallas_pairwise as jpw
from particlemethod_fsi_tpu.ops import pallas_windows_t as jpwt
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
from particlemethod_fsi_tpu_torch import convert
from particlemethod_fsi_tpu_torch.ops import ghosts as gh
from particlemethod_fsi_tpu_torch.ops import packed_engine as pk
from particlemethod_fsi_tpu_torch.ops import windows as pw
from particlemethod_fsi_tpu_torch.ops import windows_t as pwt
from particlemethod_fsi_tpu_torch.ops.packed_engine import cell_coords
from particlemethod_fsi_tpu_torch.solver import Simulation
from particlemethod_fsi_tpu_torch.state import to_numpy

STEPS = 12
KW = dict(pallas_block=32, pallas_wmax=256)
POS = dict(rtol=1e-12, atol=1e-15)
VEL = dict(rtol=1e-9, atol=1e-13)


@functools.lru_cache(maxsize=None)
def _grid():
    return jitter(mini_dam_3d(), seed=31)


def _jax_sim(**numerics):
    return JaxSimulation(config_3d(backend="pallas_t", **KW, **numerics),
                         _grid())


def _port_sim(**numerics):
    cfg = config_3d(**{"backend": "pallas_t", **KW, **numerics})
    return Simulation(port_cfg(cfg), port_grid(_grid()), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX ``pallas_t`` (margin 0): the state after STEPS steps, and one
    step's phase-1 fields and total force on the initial state, in slot
    order, and the diagnostics of the initial state."""
    jsim = _jax_sim()
    assert jsim._pad_planes
    s0 = jsim.state0
    g, ks, tb, pcfg = jsim._frame_grid, jsim.kernels, jsim.tables, jsim._pcfg

    @jax.jit
    def fields(pos, vel, prop):
        frame = jsim._pallas_frame(pos, vel, prop)
        win = jpw.compute_windows(frame, g, pcfg)
        f1 = jpwt.phase1_fields_pallas_t(frame, g, ks, tb, cfg=pcfg,
                                         windows=win, interpret=True)
        inv = jnp.argsort(frame.orig)[: jsim.n_pad]
        force_s = jpwt.phase2_forces_pallas_t(
            frame, f1, g, ks, tb, volume=jsim.volume, two_dimensional=False,
            cfg=pcfg, windows=win, interpret=True)
        return frame, force_s[inv], {k: f1[k][inv] for k in
                                     ("vol_strain", "divergence",
                                      "pressure_p", "density_a")}

    frame, force, f1 = fields(s0.pos, s0.vel, s0.prop)
    diag = jsim.diagnostics(s0)
    end = jsim.run_chunk(jax.tree_util.tree_map(lambda x: x.copy(), s0),
                         STEPS)
    return dict(frame=frame, f1={k: np.asarray(v) for k, v in f1.items()},
                force=np.asarray(force), diag=diag,
                end=jax_to_numpy(end, jsim.n))


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale,
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pad_frame_planes_equals_jax(dtype):
    """Both functions pad the same sorted frame (the JAX one, carried
    across); a frame with invalid slots, so that the tail region is
    padded too."""
    jsim = _jax_sim()
    g = jsim._frame_grid
    s = jsim.state0
    jd = jnp.float64 if dtype == "float64" else jnp.float32
    jframe = jpk.sort_frame(s.pos.astype(jd), s.vel.astype(jd), s.prop, g,
                            with_cell_start=False)
    want = jpk.pad_frame_planes(jframe, g)
    frame = convert.sorted_frame_from_numpy(
        {k: np.asarray(v) for k, v in jframe._asdict().items()},
        dtype=getattr(torch, dtype))
    pgrid = _port_sim()._frame_grid
    got = pk.pad_frame_planes(frame, pgrid)
    n, nz = frame.key.shape[0], g.cell_count[2]
    n_out = n + (nz + 1) * 256
    assert got.key.shape[0] == n_out and nz > 1 and n > _grid().n
    for k in ("key", "prop", "pos", "vel"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    real = np.asarray(want.prop) >= 0
    orig = got.orig.numpy()
    np.testing.assert_array_equal(orig[real], np.asarray(want.orig)[real])
    pads = np.asarray(want.orig) >= n
    assert np.array_equal(np.sort(orig[pads]), np.arange(n, n_out))
    assert np.all(np.diff(orig[pads]) > 0)
    # every plane starts at a multiple of 256, and the keys stay sorted
    key = got.key.numpy()
    assert np.all(np.diff(key) >= 0)
    plane = np.minimum(key // (g.cell_count[0] * g.cell_count[1]), nz)
    starts = np.flatnonzero(np.diff(plane)) + 1
    assert starts.size >= nz - 1 and np.all(starts % 256 == 0)
    # unsort keeps the slots and drops the pads
    (back,) = pk.unsort(got, got.pos, n=n)
    np.testing.assert_array_equal(back.numpy(), frame.pos.numpy()[
        np.argsort(frame.orig.numpy())])


def _unsigned_lower_bound(vals, lo, hi, v):
    """The binary search the first design of kernels 4 and 6 ran on their
    staged linear cells (``fsi_lower_bound<unsigned>``)."""
    v &= 0xFFFFFFFF
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        if (int(vals[mid]) & 0xFFFFFFFF) < v:
            lo = mid + 1
        else:
            hi = mid
    return lo


def test_windows_span_plane_ends_where_linear_cells_are_unsorted():
    """A plane-padded, ghost-extended frame of the solver's own frame path
    (the block periodic in x and y): some window spans a plane end; there
    the linear cells that kernels 4 and 6 stage (``INT_MIN`` for a pad) are
    not sorted as unsigned, and a search in them (over the whole window, one
    chunk) misses senders of receivers' ring runs that the key search of
    ``ring_runs_rows`` finds; every valid sender in a ring lies in its key
    run, and some plane pad's key lies in a receiver's ring (the last cell
    of a plane, a ghost corner, holds ghost rows)."""
    cfg = config_3d(backend="pallas", **KW).replace(gravity=(0.0, 0.0, 0.0))
    sim = Simulation(port_cfg(cfg), port_grid(_periodic_grid()),
                     device="cpu")
    assert sim._ghosts is not None and sim._pad_planes
    s = sim.state0
    frame = sim._frame(*sim._frame_inputs(s.pos, s.vel, s.prop)[0])
    grid, cfg = sim._frame_grid, sim._pcfg
    ws, wl = pw.compute_windows(frame, grid, cfg)
    nx, ny, nz = grid.cell_count
    key = frame.key.numpy().astype(np.int64)
    assert np.all(np.diff(key) >= 0)
    valid = frame.prop.numpy() >= 0
    cells = cell_coords(frame.pos, grid).numpy().astype(np.int64)
    lin = np.where(valid, cells[:, 0] + nx * (cells[:, 1] + ny * cells[:, 2]),
                   -(2**31))
    np.testing.assert_array_equal(lin[valid], key[valid])
    plane_pad = ~valid & (key < grid.num_cells)
    assert plane_pad.sum() > 0

    lo, hi = pw.ring_runs_rows(frame, ws, wl, grid, cfg.block)
    lo, hi = lo.numpy(), hi.numpy()
    _, offs_yz = pw.row_offsets(grid)
    spanning = unsorted = missed = pads_in_runs = 0
    for b in range(ws.shape[0]):
        for o in range(ws.shape[1]):
            a, e = int(ws[b, o]), int(ws[b, o] + wl[b, o])
            if e - a < 2:
                continue
            planes = key[a:e] // (nx * ny)
            if planes.min() != planes.max():
                spanning += 1
                staged = lin[a:e] & 0xFFFFFFFF
                unsorted += bool(np.any(np.diff(staged) < 0))
            for i in range(b * cfg.block, (b + 1) * cfg.block):
                if not valid[i]:
                    continue
                cx, cy, cz = cells[i]
                oy, oz = offs_yz[o]
                ty, tz = cy + oy, cz + oz
                if not (0 <= ty < ny and 0 <= tz < nz):
                    continue
                x0, x1 = max(cx - 1, 0), min(cx + 1, nx - 1)
                rlo = x0 + nx * (ty + ny * tz)
                rhi = x1 + nx * (ty + ny * tz)
                ring = np.flatnonzero(valid[a:e] & (lin[a:e] >= rlo)
                                      & (lin[a:e] <= rhi)) + a
                # the key run holds every valid sender of the ring
                assert ring.size == 0 or (lo[i, o] <= ring.min()
                                          and ring.max() < hi[i, o])
                pads_in_runs += int(plane_pad[lo[i, o]:hi[i, o]].sum())
                j0 = _unsigned_lower_bound(lin, a, e, rlo)
                j1 = _unsigned_lower_bound(lin, j0, e, rhi + 1)
                missed += int(np.sum((ring < j0) | (ring >= j1)))
    assert spanning > 0 and unsorted > 0, (spanning, unsorted)
    assert missed > 0 and pads_in_runs > 0, (missed, pads_in_runs)


@pytest.mark.parametrize("backend", ["pallas_t", "pallas"])
def test_one_step_fields_and_forces_match_jax(backend):
    want = _jax_run()
    sim = _port_sim(backend=backend)
    assert sim._pad_planes and sim._backend == backend
    s = sim.state0
    frame = sim._frame(s.pos, s.vel, s.prop)
    jf = port_frame(want["frame"])
    for k in ("key", "prop", "pos", "vel"):
        np.testing.assert_array_equal(getattr(frame, k).numpy(),
                                      getattr(jf, k).numpy(), err_msg=k)
    real = frame.prop >= 0
    assert torch.equal(frame.orig[real], jf.orig[real])
    grid, ks, tb, cfg = sim._frame_grid, sim.kernels, sim.tables, sim._pcfg
    win = pw.compute_windows(frame, grid, cfg)
    phase1 = pwt.phase1_fields_t if backend == "pallas_t" else pw.phase1_fields
    f1 = phase1(frame, grid, ks, tb, cfg=cfg, windows=win)
    inv = torch.argsort(frame.orig)[: sim.n_pad]
    for k, v in want["f1"].items():
        _close(f1[k][inv].numpy(), v, k)
    assert float(np.abs(want["f1"]["pressure_p"]).max()) > 0
    # the pair forces (the total less gravity, which both add alike)
    force, over = sim._force(s.pos, s.vel, s.prop)
    fluid = (s.prop >= 0) & (s.prop < 4)
    mass = sim.tables.density[torch.clamp(s.prop, 0, 5).long()] * sim.volume
    grav = torch.where(fluid[:, None], mass[:, None] * sim._grav_t,
                       torch.zeros((), dtype=torch.float64))
    _close((force - grav).numpy(), want["force"], "force")
    assert int(over) == 0 and float(np.abs(want["force"]).max()) > 0


@pytest.mark.parametrize("backend", ["pallas_t", "pallas"])
def test_twelve_steps_match_jax(backend):
    want = _jax_run()["end"]
    sim = _port_sim(backend=backend)
    got = to_numpy(sim.run_chunk(sim.state0, STEPS), sim.n)
    np.testing.assert_allclose(got["pos"], want["pos"], **POS)
    np.testing.assert_allclose(got["vel"], want["vel"], **VEL)
    assert sim.rebuilds == STEPS
    assert np.abs(got["pos"] - _grid().position).max() > 1e-7


def test_c8_skip_on_a_plane_padded_frame_matches():
    """Margin 1.0 (the cached frame reused on most steps: the payload
    gathered by the cached source rows, plane pads poisoned again) against
    margin 0 (JAX ``pallas_t``, which the port's margin 0 equals in
    ``test_twelve_steps_match_jax``), twelve steps; and a skip step's frame
    row by row."""
    sim1 = _port_sim(rebuild_margin=1.0)
    assert sim1._margin_cached and sim1._pad_planes
    b = to_numpy(sim1.run_chunk(sim1.state0, STEPS), sim1.n)
    assert 1 <= sim1.rebuilds < STEPS
    want = _jax_run()["end"]
    np.testing.assert_allclose(b["pos"], want["pos"], **POS)
    np.testing.assert_allclose(b["vel"], want["vel"], **VEL)
    # a skip step's frame: every plane pad poisoned again (position 1e9,
    # velocity 0: its cached key is a real cell, so only its position keeps
    # it out of the key rule's rings), every other row its slot's current
    # payload (the frames are recorded, the forces not evaluated)
    frames = []
    sim1._pair_forces = lambda frame, *a: frames.append(frame)
    st = sim1.state0
    cache = sim1._init_cache(st)
    extremes = gh.valid_extremes(st.pos, st.prop < 0)
    _, _, cache = sim1._force_cached(st.pos, st.vel, st.prop, cache, extremes)
    pads = cache["pads"]
    assert pads is not None and int(pads.sum()) > 0
    assert not bool((cache["prop_s"][pads] >= 0).any())
    # a rigid shift and a new velocity: no displacement spread, a skip
    pos, vel = st.pos + 1e-5, st.vel + 0.25
    _, _, cache_skip = sim1._force_cached(pos, vel, st.prop, cache, extremes)
    assert cache_skip is cache and len(frames) == 2
    frame = frames[1]
    assert bool((frame.pos[pads] == 1.0e9).all())
    assert bool((frame.vel[pads] == 0.0).all())
    real = frame.orig[~pads]
    np.testing.assert_array_equal(frame.pos[~pads].numpy(), pos[real].numpy())
    np.testing.assert_array_equal(frame.vel[~pads].numpy(), vel[real].numpy())


@pytest.mark.parametrize("backend", ["pallas_t", "pallas"])
def test_diagnostics_match_jax(backend):
    want = _jax_run()["diag"]
    sim = _port_sim(backend=backend)
    got = sim.diagnostics(sim.state0)
    assert set(got) == set(want)
    for k in ("force", "accel", "pressure_p", "vol_strain", "density_a",
              "virial_stress", "virial_pressure", "max_speed"):
        _close(got[k], np.asarray(want[k]), k)
    for k in ("neighbor_count", "cell_overflow", "window_overflow",
              "ghost_overflow", "initial_neighbor_count"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert float(np.abs(want["virial_pressure"]).max()) > 0


@functools.lru_cache(maxsize=None)
def _periodic_grid():
    """A 3-D fluid block that fills the domain in x and y (pairs across both
    boundaries: ghost rows) and leaves room in z; four planes of cells in
    z."""
    l0 = 1e-3
    grid = generate_grid(BoidScene(
        particle_distance=l0, lower_domain=(0.0, 0.0, 0.0),
        upper_domain=(11 * l0, 10 * l0, 10 * l0),
        primitives=[Primitive("Cuboid", spacing=l0, type=0, lower=(0, 0, 0),
                              upper=(11 * l0, 10 * l0, 7 * l0))]))
    rng = np.random.default_rng(41)
    grid.velocity[:] = rng.normal(scale=0.05, size=(grid.n, 3))
    return grid


def test_x_periodic_3d_scene_matches_jax_packed():
    """The block periodic in x and y, three steps on each backend against
    JAX ``packed`` (always the minimum image)."""
    grid = _periodic_grid()
    base = dict(gravity=(0.0, 0.0, 0.0))
    # the packed engine's cells (3.3 l0 wide) hold up to ~37 particles
    jsim = JaxSimulation(config_3d(backend="packed", cell_capacity=48)
                         .replace(**base), grid)
    s = jsim.state0
    for _ in range(3):
        s = jsim.step(s)
    want = jax_to_numpy(s, grid.n)
    for backend in ("pallas_t", "pallas"):
        cfg = config_3d(backend=backend, **KW).replace(**base)
        sim = Simulation(port_cfg(cfg), port_grid(grid), device="cpu")
        assert sim._pad_planes and sim._ghosts is not None
        assert gh.spec_axes(sim._ghosts) == (True, True, False)
        st = sim.state0
        (pos, vel, prop), _, _ = sim._frame_inputs(st.pos, st.vel, st.prop)
        frame = sim._frame(pos, vel, prop)
        ghost = (frame.orig >= sim.n_pad) & (frame.orig < pos.shape[0])
        plane_pad = (frame.prop < 0) & (frame.key < sim._frame_grid.num_cells)
        assert int((ghost & (frame.prop >= 0)).sum()) > 0
        assert int(plane_pad.sum()) > 0
        for _ in range(3):
            st = sim.step(st)
        got = to_numpy(st, grid.n)
        np.testing.assert_allclose(got["pos"], want["pos"], **POS)
        np.testing.assert_allclose(got["vel"], want["vel"], **VEL)
        assert int(st.ghost_overflow) == 0 and sim.ghost_refreshes == 0
