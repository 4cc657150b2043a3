"""PyTorch port vs JAX package: the row-major window sweeps
(``windows.phase1_fields``, ``phase2_forces`` and ``virial`` against
``pallas_pairwise.phase1_fields_pallas``, ``phase2_forces_pallas`` and
``virial_pallas``) on the same frame, for every specialization branch of the
three kernels, 2-D and 3-D.  The JAX side runs its Pallas kernels in
interpret mode; the port runs the plain versions of its CUDA kernels (the
tensors are on the CPU).  Phase 2 and the virial get the same phase-1 fields
on both sides (the JAX ones), as in ``test_torch_virial.py``: the EOS
amplifies the rounding of the phase-1 sums, which is phase 1's to answer
for.

Tolerance: rtol 1e-12, atol 1e-13 of each field's term scale (the sums are
taken in another order, nothing else differs); neighbour counts and the
longest window equal."""

import functools

import jax
import numpy as np
import pytest
import torch

from cases import dam_like_config, mini_dam, mini_fsi
from test_torch_common import jitter, port_frame, port_statics
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)
from test_torch_windows_t import _close, _field_scales, _jax_sim

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu.ops import packed_engine as jpk
from particlemethod_fsi_tpu.ops import pallas_pairwise as jpw
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu_torch.ops import packed_engine as pk
from particlemethod_fsi_tpu_torch.ops import windows as pw

ROWS_KW = dict(backend="pallas", pallas_block=32, pallas_wmax=128)
_FSI = dict(scene=SCENES["dam"], young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))

# case: expected flags of the window config
CASES = {
    "mini_dam": dict(surface_tension=False, uniform_ratio=True, planar=True),
    "mini_fsi": dict(surface_tension=False, planar=True),
    "surface_tension": dict(surface_tension=True, uniform_ratio=False,
                            uniform_radii=True),
    "uniform_ratio_st": dict(surface_tension=True, uniform_ratio=True),
    "nonuniform_radii": dict(surface_tension=True, uniform_ratio=False,
                             uniform_radii=False),
    "non_planar_2d": dict(surface_tension=False, planar=False),
    # 3-D with surface tension runs on the card (chip_smoke.py's double
    # instances); the plain body it shares is held to JAX with the key ring
    # in test_torch_windows_t.py
    "3d": dict(surface_tension=False, planar=False),
}


def _case(name):
    """(JAX Simulation, (pos, vel, prop)) of a case."""
    if name == "mini_dam":
        grid, cfg = jitter(mini_dam(), seed=21), dam_like_config(**ROWS_KW)
    elif name == "mini_fsi":
        grid = jitter(mini_fsi(), seed=22)
        cfg = dam_like_config(**ROWS_KW).replace(**_FSI)
    elif name == "non_planar_2d":
        # a 2-D frame (one z plane of cells) whose z terms are live
        grid = jitter(mini_dam(), seed=23)
        free = grid.prop < 4
        rng = np.random.default_rng(23)
        grid.position[free, 2] += rng.normal(scale=0.05 * grid.spacing,
                                             size=int(free.sum()))
        grid.velocity[free, 2] = rng.normal(scale=0.05, size=int(free.sum()))
        cfg = dam_like_config(**ROWS_KW)
    else:
        return _jax_sim(name)
    jsim = JaxSimulation(cfg, grid)
    s = jsim.state0
    return jsim, (s.pos, s.vel, s.prop)


@functools.lru_cache(maxsize=None)
def _jax_rows_fn(jsim):
    """The JAX row-major phase 1, and phase 2 and virial on its fields, as
    one function compiled once a Simulation.  One receiver block a grid
    program (``subblocks=1``): a TPU layout choice that changes no sum and
    halves the kernels' interpret-mode compile."""
    g, ks, tb = jsim._frame_grid, jsim.kernels, jsim.tables
    jcfg = jsim._pcfg._replace(subblocks=1)
    kw = dict(volume=jsim.volume, two_dimensional=jsim.cfg.two_dimensional,
              cfg=jcfg, interpret=True)

    @jax.jit
    def rows(jframe):
        jf1 = jpw.phase1_fields_pallas(jframe, g, ks, tb, cfg=jcfg,
                                       interpret=True)
        jforce = jpw.phase2_forces_pallas(jframe, jf1, g, ks, tb, **kw)
        return jf1, jforce, jpw.virial_pallas(jframe, jf1, g, ks, tb, **kw)

    return rows


def _jax_rows(jsim, jframe):
    jf1, jforce, (jstress, jvp) = _jax_rows_fn(jsim)(jframe)
    return jf1, np.asarray(jforce), np.asarray(jstress), np.asarray(jvp)


def _port_rows(jsim, frame, jf1, windows=None):
    """The port's three row-major functions; phase 2 and the virial on the
    JAX phase-1 fields."""
    grid, ks, tables, cfg = port_statics(jsim)
    win = windows if windows is not None else pw.compute_windows(
        frame, grid, cfg)
    kw = dict(volume=jsim.volume, two_dimensional=jsim.cfg.two_dimensional,
              cfg=cfg, windows=win)
    f1 = pw.phase1_fields(frame, grid, ks, tables, cfg=cfg, windows=win)
    fields = {k: torch.as_tensor(np.array(jf1[k]))
              for k in ("pressure_p", "pressure_a", "gravity_center", "mu")}
    force = pw.phase2_forces(frame, fields, grid, ks, tables, **kw)
    stress, vp = pw.virial(frame, fields, grid, ks, tables, **kw)
    return cfg, f1, force, stress, vp


def _check(jsim, jout, pout, rows=slice(None)):
    """Port against JAX at the module's tolerance, over frame rows
    ``rows``."""
    jf1, jforce, jstress, jvp = jout
    cfg, f1, force, stress, vp = pout
    assert set(f1) == set(jf1)
    scales = _field_scales(jsim, jf1)
    for k in ("density_a", "gravity_center", "vol_strain", "divergence",
              "pressure_p", "pressure_a", "mu"):
        _close(k, f1[k][rows], np.asarray(jf1[k])[rows], scales.get(k))
    np.testing.assert_array_equal(f1["neighbor_count"][rows].numpy(),
                                  np.asarray(jf1["neighbor_count"])[rows])
    _close("force", force[rows], jforce[rows],
           scales["force"] + float(np.max(np.abs(jforce))))
    scale = float(np.abs(jstress).max())
    _close("virial_stress", stress[:, rows], jstress[:, rows], scale)
    _close("virial_pressure", vp[rows], jvp[rows], scale)


@functools.lru_cache(maxsize=None)
def _case_rows(case):
    """(JAX Simulation, sorted frame, JAX rows) of a case, computed once."""
    jsim, (pos, vel, prop) = _case(case)
    jframe = jpk.sort_frame(pos, vel, prop, jsim._frame_grid,
                            with_cell_start=False)
    return jsim, jframe, _jax_rows(jsim, jframe)


@pytest.mark.parametrize("case", list(CASES))
def test_rows_match_jax(case):
    jsim, jframe, jout = _case_rows(case)
    for k, v in CASES[case].items():
        assert getattr(jsim._pcfg, k) == v, (case, k)
    frame = port_frame(jframe)
    before = dict(pw.launch_counts)
    pout = _port_rows(jsim, frame, jout[0])
    assert pw.launch_counts == before  # the plain versions never count
    _check(jsim, jout, pout)
    assert int(pout[1]["window_overflow"]) == int(jout[0]["window_overflow"])

    jf1, jforce, jstress, _ = jout
    grid = pout[0]
    # the case is live: 3-D frames have nine row offsets, and every sum the
    # branch produces is nonzero somewhere
    assert len(pw.row_offsets(jsim._frame_grid)[0]) == (
        9 if not jsim.cfg.two_dimensional else 3)
    assert int(np.asarray(jf1["neighbor_count"]).max()) >= 8
    assert float(np.abs(jforce).max()) > 0
    assert float(np.abs(np.asarray(jf1["divergence"])).max()) > 0
    if grid.surface_tension:
        assert float(np.abs(np.asarray(jf1["density_a"])).max()) > 0
        assert float(np.abs(np.asarray(jf1["gravity_center"])).max()) > 0
    live = [0, 1, 3, 4] if grid.planar else range(9)
    for r in live:
        assert float(np.abs(jstress[r]).max()) > 0, r


def test_pads_inside_the_fluid_change_nothing():
    """Pad rows carry the sentinel key but their positions can sit inside
    the fluid, where they pass a ring recomputed from positions: only the
    ``prop_j >= 0`` test keeps them out.  Move every pad onto a fluid
    particle's neighbourhood AND run every window on to the frame's end, so
    that each pad is a candidate of every receiver, as the JAX kernel's
    chunked reads make it: the real rows are what they were, and what the
    JAX kernels give."""
    jsim, jframe, jout = _case_rows("mini_fsi")
    base = _port_rows(jsim, port_frame(jframe), jout[0])

    p = np.asarray(jframe.pos).copy()
    sprop = np.asarray(jframe.prop)
    pads = np.nonzero(sprop < 0)[0]
    fluid = np.nonzero(sprop == 1)[0]
    assert pads.size >= 8 and fluid.size > pads.size
    rng = np.random.default_rng(3)
    p[pads] = p[rng.choice(fluid, pads.size, replace=False)] + rng.normal(
        scale=0.3 * jsim.spacing, size=(pads.size, 3)) * [1, 1, 0]
    moved = jframe._replace(pos=jframe.pos.at[:].set(p))
    jout = _jax_rows(jsim, moved)
    frame = port_frame(moved)
    grid, _, _, cfg = port_statics(jsim)
    ws, wl = pw.compute_windows(frame, grid, cfg)
    to_end = (frame.pos.shape[0] - ws).to(torch.int32)
    assert bool((to_end > wl).all())
    pout = _port_rows(jsim, frame, jout[0], windows=(ws, to_end))

    real = torch.as_tensor(sprop >= 0)
    _check(jsim, jout, pout, rows=real.numpy())
    # and against the unmoved frame with its exact windows
    (_, f1_a, force_a, stress_a, _), (_, f1_b, force_b, stress_b, _) = base, pout
    for k in ("density_a", "vol_strain", "divergence", "pressure_p"):
        _close(k, f1_b[k][real], f1_a[k][real].numpy())
    assert torch.equal(f1_b["neighbor_count"][real], f1_a["neighbor_count"][real])
    _close("force", force_b[real], force_a[real].numpy())
    _close("virial", stress_b[:, real], stress_a[:, real].numpy())
    # the pads did land inside the fluid: their own sums see neighbours
    assert int(f1_b["neighbor_count"][~real].max()) > 0


def _boundary_x(dmin: float, cw: float, lo: float, hi: float) -> float:
    """An x in [lo, hi) exactly on a cell boundary: ``x - dmin == k * cw``
    in float64, so that ``(x - dmin) / cw`` is the integer k.  Where one
    exists, one at which a reciprocal multiply would give cell k - 1
    instead."""
    inv, exact = 1.0 / cw, []
    for k in range(int((lo - dmin) / cw) + 1, int((hi - dmin) / cw) + 1):
        x = dmin + k * cw
        for _ in range(16):
            if x - dmin == k * cw and np.floor((x - dmin) / cw) == k:
                if np.floor((x - dmin) * inv) != k:
                    return x
                exact.append(x)
            x = np.nextafter(x, -np.inf)
    assert exact, "no position exactly on a cell boundary"
    return exact[0]


def test_cell_boundary_particle_gets_the_jax_ring():
    """A particle exactly on a cell boundary falls in the cell the sort key
    gives it, in the kernel's ring as in the key: the coordinate is a true
    divide in both packages (a reciprocal multiply would move it one cell
    down and split its ring from its key)."""
    from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
    from particlemethod_fsi_tpu_torch.state import make_state

    jsim = _case_rows("mini_dam")[0]
    vel, prop = jsim.state0.vel, jsim.state0.prop
    g = jsim._frame_grid
    p = np.asarray(jsim.state0.pos).copy()
    sprop = np.asarray(prop)
    fluid = np.nonzero(sprop == 1)[0]
    i = fluid[np.argmin(np.abs(p[fluid, 0] - np.median(p[fluid, 0])))]
    p[i, 0] = _boundary_x(g.domain_min[0], g.cell_width[0], p[i, 0] - 3e-3,
                          p[i, 0] + 3e-3)
    pos = jsim.state0.pos.at[:].set(p)
    jframe = jpk.sort_frame(pos, vel, prop, g, with_cell_start=False)
    jout = _jax_rows(jsim, jframe)

    # the port sorts the same positions itself
    grid, _, _, _ = port_statics(jsim)
    s = jax_to_numpy(jsim.state0)
    st = make_state(s["prop"][: jsim.n], p[: jsim.n], s["pos0"][: jsim.n],
                    np.asarray(vel)[: jsim.n], dtype=torch.float64)
    frame = pk.sort_frame(st.pos, st.vel, st.prop, grid)
    np.testing.assert_array_equal(frame.key.numpy(), np.asarray(jframe.key))
    np.testing.assert_array_equal(frame.orig.numpy(), np.asarray(jframe.orig))
    cell = pk.cell_coords(torch.as_tensor(p[i:i + 1]), grid)[0, 0]
    assert int(cell) == int(round((p[i, 0] - g.domain_min[0]) / g.cell_width[0]))
    _check(jsim, jout, _port_rows(jsim, frame, jout[0]))


def test_cuda_tensor_never_takes_the_plain_rows(monkeypatch):
    """The row-major wrappers take their plain versions only because the
    tensor lies on the CPU: for anything else they go to the kernel path
    (which, without a compiler or a card, raises) -- never a fall-back."""
    jsim, (pos, vel, prop) = _case("mini_fsi")
    grid, ks, tables, cfg = port_statics(jsim)
    frame = port_frame(jpk.sort_frame(pos, vel, prop, jsim._frame_grid,
                                      with_cell_start=False))
    win = pw.compute_windows(frame, grid, cfg)

    class FakeCuda:
        is_cuda = True

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("phase1_rows_sweep_plain", "phase2_rows_sweep_plain",
                 "virial_rows_sweep_plain"):
        monkeypatch.setattr(pw, name, boom)
    fake = frame._replace(pos=FakeCuda())
    kw = dict(volume=1.0, two_dimensional=True)
    calls = [
        lambda: pw.phase1_rows_sweep(fake, *win, grid, ks, cfg, tables),
        lambda: pw.phase2_rows_sweep(fake, None, None, None, None, *win, grid,
                                     ks, cfg, tables, **kw),
        lambda: pw.virial_rows_sweep(fake, None, None, None, None, *win, grid,
                                     ks, cfg, tables, **kw),
    ]
    for call in calls:
        with pytest.raises(Exception) as e:
            call()
        assert not isinstance(e.value, AssertionError)
    for k in ("phase1_rows", "phase2_rows", "virial_rows"):
        assert k in pw.launch_counts


def test_phase1_always_counts():
    """The row-major phase 1 takes the field-major one's ``count`` keyword,
    so that the solver calls both alike, and refuses to leave the count
    out."""
    jsim, jframe, _ = _case_rows("mini_fsi")
    grid, ks, tables, cfg = port_statics(jsim)
    frame = port_frame(jframe)
    f1 = pw.phase1_fields(frame, grid, ks, tables, cfg=cfg, count=True)
    assert int(f1["neighbor_count"].max()) >= 8
    with pytest.raises(ValueError, match="always counts"):
        pw.phase1_fields(frame, grid, ks, tables, cfg=cfg, count=False)


def test_harmonic_mu_is_zero_for_inviscid_pairs():
    mu = torch.tensor([0.0, 2.0, 1e-3, 0.0], dtype=torch.float64)
    other = torch.tensor([0.0, 2.0, 3e-3, 5.0], dtype=torch.float64)
    h = pw.harmonic_mu(mu, other)
    assert h[0] == 0.0 and h[3] == 0.0
    assert h[1] == 2.0
    torch.testing.assert_close(h[2], torch.tensor(1.5e-3, dtype=torch.float64),
                               rtol=1e-15, atol=0)


def test_check_no_wrap_pairs_matches_jax():
    """The set-up check of the no-wrap precondition, on a wall-bounded scene
    (true) and on one whose fluid fills a periodic box (false)."""
    from particlemethod_fsi_tpu.generator import BoidScene, Primitive, generate_grid

    jsim, (pos, _, prop) = _case("mini_dam")
    grid = port_statics(jsim)[0]
    s = jsim._frame_support
    valid = np.asarray(prop) >= 0
    assert pw.check_no_wrap_pairs(grid, np.asarray(pos), valid, s) is True
    assert jpw.check_no_wrap_pairs(jsim._frame_grid, pos, valid, s) is True
    full = generate_grid(BoidScene(
        particle_distance=1e-3, lower_domain=(0.0, 0.0, 0.0),
        upper_domain=(12e-3, 12e-3, 1e-3),
        primitives=[Primitive("Cuboid", spacing=1e-3, type=1, lower=(0, 0, 0),
                              upper=(12e-3, 12e-3, 1e-3))]))
    jsim2 = JaxSimulation(dam_like_config(), full)
    g2 = port_statics(jsim2)[0]
    v2 = full.prop >= 0
    assert pw.check_no_wrap_pairs(g2, full.position, v2, 2.1e-3) is False
    assert jpw.check_no_wrap_pairs(jsim2.cell_grid, full.position, v2,
                                   2.1e-3) is False

