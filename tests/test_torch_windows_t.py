"""PyTorch port vs JAX package: phase-1 fields and phase-2 forces of the
window sweep on the same frame (carried across with ``convert``), for every
specialization branch of the two kernels.  The JAX side runs its Pallas
kernels in interpret mode; the port runs the plain versions of its CUDA
kernels (the tensors are on the CPU).  Tolerance: rtol 1e-12 with atol scaled
to the field -- the sums are taken in another order, nothing else differs."""

import numpy as np
import pytest
import torch

from cases import config_3d, dam_like_config, mini_dam, mini_dam_3d
from test_torch_common import (
    WINDOW_KW,
    bench_sims,
    jitter,
    port_frame,
    port_statics,
)
from test_torch_common import close_to_scale as _close
from test_torch_common import field_scales as _field_scales
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.ops import packed_engine as jpk
from particlemethod_fsi_tpu.ops import pallas_pairwise as jpw
from particlemethod_fsi_tpu.ops import pallas_windows_t as jpwt
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu_torch.ops import windows as pw
from particlemethod_fsi_tpu_torch.ops import windows_t as pwt

_IR = [[1.0] * 6 for _ in range(6)]
_IR[1][4] = 0.5
_IR[4][1] = 0.8
_ST = dict(
    surface_tension=(0.05, 0.05, 0.0, 0.0, 0.05, 0.0),
    interaction_ratio=tuple(tuple(r) for r in _IR),
)


def _jax_sim(case):
    """JAX Simulation whose statics give the flag set of ``case``."""
    if case == "main_path":  # no surface tension, uniform ratio, planar, uniform radii
        jsim, _ = bench_sims(24)
        js = jsim.state0
        for _ in range(3):
            js = jsim.step(js)
        return jsim, (js.pos, js.vel, js.prop)
    if case in ("surface_tension", "nonuniform_radii", "uniform_ratio_st"):
        grid = jitter(mini_dam(), seed=11)
        kw = dict(_ST)
        if case == "nonuniform_radii":
            kw.update(radius_ratio_a=2.1, radius_ratio_v=2.3)
        if case == "uniform_ratio_st":
            kw.pop("interaction_ratio")
        cfg = dam_like_config(**WINDOW_KW).replace(**kw)
    elif case in ("3d", "3d_surface_tension"):
        grid = jitter(mini_dam_3d(), seed=12)
        cfg = config_3d(**{**WINDOW_KW, "pallas_wmax": 256})
        if case == "3d_surface_tension":
            cfg = cfg.replace(**_ST)
    else:
        raise ValueError(case)
    jsim = JaxSimulation(cfg, grid)
    s = jsim.state0
    return jsim, (s.pos, s.vel, s.prop)


_EXPECT = {
    "main_path": dict(surface_tension=False, uniform_ratio=True, planar=True,
                      uniform_radii=True),
    "surface_tension": dict(surface_tension=True, uniform_ratio=False,
                            planar=False, uniform_radii=True),
    "uniform_ratio_st": dict(surface_tension=True, uniform_ratio=True,
                             uniform_radii=True),
    "nonuniform_radii": dict(surface_tension=True, uniform_ratio=False,
                             uniform_radii=False),
    "3d": dict(surface_tension=False, planar=False),
    "3d_surface_tension": dict(surface_tension=True, uniform_ratio=False,
                               planar=False),
}


@pytest.mark.parametrize("case,count", [
    *[(c, False) for c in _EXPECT],
    ("main_path", True), ("nonuniform_radii", True), ("3d", True),
])
def test_phases_match_jax(case, count):
    jsim, (pos, vel, prop) = _jax_sim(case)
    jcfg = jsim._pcfg
    for k, v in _EXPECT[case].items():
        if case == "surface_tension" and k == "planar":
            continue  # jittered 2-D grid stays planar; checked below
        assert getattr(jcfg, k) == v, (case, k)
    # the frame without 3-D plane padding: the sweep's own contract
    jframe = jpk.sort_frame(pos, vel, prop, jsim._frame_grid,
                            with_cell_start=False)
    jwin = jpw.compute_windows(jframe, jsim._frame_grid, jcfg)
    jf1 = jpwt.phase1_fields_pallas_t(
        jframe, jsim._frame_grid, jsim.kernels, jsim.tables, cfg=jcfg,
        windows=jwin, interpret=True, count=count)
    jforce = jpwt.phase2_forces_pallas_t(
        jframe, jf1, jsim._frame_grid, jsim.kernels, jsim.tables,
        volume=jsim.volume, two_dimensional=jsim.cfg.two_dimensional,
        cfg=jcfg, windows=jwin, interpret=True)

    grid, ks, tables, cfg = port_statics(jsim)
    frame = port_frame(jframe)
    win = pw.compute_windows(frame, grid, cfg)
    np.testing.assert_array_equal(win[0].numpy(), np.asarray(jwin[0]))
    np.testing.assert_array_equal(win[1].numpy(), np.asarray(jwin[1]))
    before = dict(pwt.launch_counts)
    f1 = pwt.phase1_fields_t(frame, grid, ks, tables, cfg=cfg, windows=win,
                             count=count)
    force = pwt.phase2_forces_t(
        frame, f1, grid, ks, tables, volume=jsim.volume,
        two_dimensional=jsim.cfg.two_dimensional, cfg=cfg, windows=win)
    # the plain versions never count as kernel launches
    assert pwt.launch_counts == before

    assert set(f1) == set(jf1) - {"window_overflow"}
    scales = _field_scales(jsim, jf1)
    for k in ("density_a", "gravity_center", "gc_rows", "vol_strain",
              "divergence", "pressure_p", "pressure_a", "mu"):
        _close(k, f1[k], jf1[k], scales.get(k))
    np.testing.assert_array_equal(f1["neighbor_count"].numpy(),
                                  np.asarray(jf1["neighbor_count"]))
    _close("force", force, jforce,
           scales["force"] + float(np.max(np.abs(np.asarray(jforce)))))
    # the case is live: the fields are not all zero
    assert float(np.abs(np.asarray(jforce)).max()) > 0
    assert float(np.abs(np.asarray(jf1["divergence"])).max()) > 0
    if count:
        assert int(f1["neighbor_count"].max()) >= 8
    if cfg.surface_tension:
        assert float(np.abs(np.asarray(jf1["density_a"])).max()) > 0
        assert float(np.abs(np.asarray(jf1["gravity_center"])).max()) > 0


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A wrapper picks the plain version only because the tensor lies on the
    CPU: for anything else it goes to the kernel path (which, without a
    compiler or a card, raises) -- never a silent fall-back."""
    jsim, (pos, vel, prop) = _jax_sim("surface_tension")
    grid, ks, tables, cfg = port_statics(jsim)
    frame = port_frame(jpk.sort_frame(pos, vel, prop, jsim._frame_grid,
                                      with_cell_start=False))
    win = pw.compute_windows(frame, grid, cfg)

    class FakeCuda:
        """Stands for frame.pos on a card: only is_cuda is consulted before
        the kernel path takes over."""
        is_cuda = True

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(pwt, "phase1_sweep_plain", boom)
    monkeypatch.setattr(pwt, "phase2_sweep_plain", boom)
    fake = frame._replace(pos=FakeCuda())
    offs, _ = pw.row_offsets(grid)
    with pytest.raises(Exception) as e1:
        pwt.phase1_sweep(fake, win[0], win[1], offs, ks, cfg, tables,
                         support=grid.support)
    assert not isinstance(e1.value, AssertionError)
    with pytest.raises(Exception) as e2:
        pwt.phase2_sweep(fake, None, None, None, None, win[0], win[1], offs,
                         ks, cfg, tables, volume=1.0, two_dimensional=True)
    assert not isinstance(e2.value, AssertionError)


def test_inverse_viscosity_zero_is_inf():
    mu = torch.tensor([0.0, 2.0, 1e-3], dtype=torch.float64)
    inv = pwt.inverse_viscosity(mu)
    assert torch.isinf(inv[0]) and inv[1] == 0.5
    assert (2.0 / (inv[0] + inv[1])) == 0.0


def test_plain_versions_do_not_depend_on_the_slab_size(monkeypatch):
    """The plain versions work through receiver blocks in slabs; a tiny
    budget (one block a slab) gives the same sums as one slab for all, to
    rounding."""
    jsim, (pos, vel, prop) = _jax_sim("nonuniform_radii")
    grid, ks, tables, cfg = port_statics(jsim)
    frame = port_frame(jpk.sort_frame(pos, vel, prop, jsim._frame_grid,
                                      with_cell_start=False))
    win = pw.compute_windows(frame, grid, cfg)

    def both():
        f1 = pwt.phase1_fields_t(frame, grid, ks, tables, cfg=cfg,
                                 windows=win, count=True)
        return f1, pwt.phase2_forces_t(
            frame, f1, grid, ks, tables, volume=jsim.volume,
            two_dimensional=True, cfg=cfg, windows=win)

    f1_a, force_a = both()
    # the slab walk is shared by both sweep families and lives in windows.py
    monkeypatch.setattr(pw, "_PLAIN_PAIR_BUDGET", 1)
    slabs = list(pw._window_slabs(frame, win[0], win[1], 1, cfg.block))
    # one block a slab; blocks whose window is empty (pad rows) yield nothing
    assert all(nb == 1 for _, _, nb, *_ in slabs)
    assert len(slabs) == int((win[1][:, 0] > 0).sum()) > 1
    f1_b, force_b = both()
    # a slab's lane count changes the order torch sums a row in: equal to
    # rounding, not bit for bit
    for k in f1_a:
        torch.testing.assert_close(
            f1_a[k], f1_b[k], rtol=1e-13,
            atol=1e-13 * float(f1_a[k].abs().max()), msg=k)
    torch.testing.assert_close(force_a, force_b, rtol=1e-13,
                               atol=1e-13 * float(force_a.abs().max()))
