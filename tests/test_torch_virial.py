"""PyTorch port vs JAX package: the virial stress of the window sweep
(``virial_t`` against ``virial_pallas_t``) on the same frame and the same
phase-1 fields, for every specialization branch of the kernel.  The JAX side
runs its Pallas kernel in interpret mode; the port runs the plain version of
its CUDA kernel (the tensors are on the CPU).

Tolerance: rtol 1e-12, atol 1e-13 of the term scale.  The term scale is the
largest magnitude over all nine components: a diagonal component sums terms
of one sign (``f_a x_a = coeff x_a^2 / r``), so it is as large as its terms,
and an off-diagonal one sums the same terms with mixed signs.  The sums are
taken in another order, nothing else differs."""

import numpy as np
import pytest
import torch

from cases import dam_like_config, mini_dam, mini_fsi
from test_torch_common import WINDOW_KW, port_frame, port_statics
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)
from test_torch_windows_t import _EXPECT, _jax_sim

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu.ops import packed_engine as jpk
from particlemethod_fsi_tpu.ops import pallas_pairwise as jpw
from particlemethod_fsi_tpu.ops import pallas_windows_t as jpwt
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu_torch.ops import windows as pw
from particlemethod_fsi_tpu_torch.ops import windows_t as pwt


def _stepped(case):
    """A JAX Simulation of a scene from ``tests/cases.py`` and its state
    after three steps (live pressures and velocities)."""
    if case == "mini_dam_stepped":
        grid, cfg = mini_dam(), dam_like_config(**WINDOW_KW)
    else:
        grid = mini_fsi()
        cfg = dam_like_config(**WINDOW_KW).replace(
            scene=SCENES["dam"], young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))
    jsim = JaxSimulation(cfg, grid)
    s = jsim.state0
    for _ in range(3):
        s = jsim.step(s)
    return jsim, (s.pos, s.vel, s.prop)


def _both(case):
    jsim, (pos, vel, prop) = (_stepped(case) if case.endswith("_stepped")
                              else _jax_sim(case))
    jcfg = jsim._pcfg
    jframe = jpk.sort_frame(pos, vel, prop, jsim._frame_grid,
                            with_cell_start=False)
    jwin = jpw.compute_windows(jframe, jsim._frame_grid, jcfg)
    jf1 = jpwt.phase1_fields_pallas_t(
        jframe, jsim._frame_grid, jsim.kernels, jsim.tables, cfg=jcfg,
        windows=jwin, interpret=True)
    kw = dict(volume=jsim.volume, two_dimensional=jsim.cfg.two_dimensional)
    jstress, jvp = jpwt.virial_pallas_t(
        jframe, jf1, jsim._frame_grid, jsim.kernels, jsim.tables, cfg=jcfg,
        windows=jwin, interpret=True, **kw)

    grid, ks, tables, cfg = port_statics(jsim)
    frame = port_frame(jframe)
    win = pw.compute_windows(frame, grid, cfg)
    # the same phase-1 fields feed both: the EOS amplifies the rounding of
    # the phase-1 sums (kappa * (sum - n0)), which is not the virial's to
    # answer for; the port's own phase 1 is held to the JAX one elsewhere
    f1 = {k: torch.as_tensor(np.array(jf1[k]))
          for k in ("pressure_p", "pressure_a", "gravity_center", "mu")}
    before = dict(pwt.launch_counts)
    stress, vp = pwt.virial_t(frame, f1, grid, ks, tables, cfg=cfg,
                              windows=win, **kw)
    assert pwt.launch_counts == before  # the plain version never counts
    return jsim, cfg, (np.asarray(jstress), np.asarray(jvp)), (stress, vp)


@pytest.mark.parametrize("case", ["mini_dam_stepped", "mini_fsi_stepped",
                                  *_EXPECT])
def test_virial_matches_jax(case):
    jsim, cfg, (jstress, jvp), (stress, vp) = _both(case)
    for k, v in _EXPECT.get(case, {}).items():
        if case == "surface_tension" and k == "planar":
            continue
        assert getattr(cfg, k) == v, (case, k)
    assert tuple(stress.shape) == jstress.shape == (9, jsim.n_pad)
    assert tuple(vp.shape) == jvp.shape == (jsim.n_pad,)
    assert stress.dtype == vp.dtype == torch.float64
    scale = float(np.abs(jstress).max())
    assert scale > 0
    np.testing.assert_allclose(stress.numpy(), jstress, rtol=1e-12,
                               atol=1e-13 * scale)
    np.testing.assert_allclose(vp.numpy(), jvp, rtol=1e-12,
                               atol=1e-13 * scale)
    # live rows: in-plane components always; the z rows only off the plane
    live = [0, 1, 3, 4] if cfg.planar else list(range(9))
    for r in range(9):
        if r in live:
            assert float(np.abs(jstress[r]).max()) > 0, r
        else:
            assert not stress[r].any() and not jstress[r].any(), r
    # the trace pressure is what the rows say it is
    d = 2.0 if jsim.cfg.two_dimensional else 3.0
    tr = stress[0] + stress[4] + (0 if jsim.cfg.two_dimensional else stress[8])
    torch.testing.assert_close(vp, -tr / d, rtol=0, atol=0)


def test_virial_takes_the_receiver_pressure_only():
    """What sets the virial apart from phase 2: P_i alone (a sender's
    pressure changes nothing), no structure rule (a structure receiver next
    to structure senders still gets its pressure term), and the viscosity at
    half weight."""
    jsim, (pos, vel, prop) = _stepped("mini_fsi_stepped")
    grid, ks, tables, cfg = port_statics(jsim)
    frame = port_frame(jpk.sort_frame(pos, vel, prop, jsim._frame_grid,
                                      with_cell_start=False))
    win = pw.compute_windows(frame, grid, cfg)
    offs, _ = pw.row_offsets(grid)
    n = frame.pos.shape[0]
    rng = np.random.default_rng(5)
    pp = torch.as_tensor(rng.normal(scale=1e2, size=n))
    mu = tables.shear_viscosity[torch.clamp(frame.prop, 0, 5).long()]
    kw = dict(volume=jsim.volume, two_dimensional=True)

    def sweep(pp, vel=frame.vel, invmu=pwt.inverse_viscosity(mu)):
        fr = frame._replace(vel=vel)
        return pwt.virial_sweep(fr, pp, None, None, invmu, *win, offs, ks,
                                cfg, tables, **kw)

    base = sweep(pp)
    # scaling the pressure of every particle scales each row by its OWN
    # factor: only P_i enters receiver i
    factor = torch.as_tensor(rng.uniform(0.5, 2.0, size=n))
    rest = torch.zeros_like(frame.vel)
    inviscid = torch.full_like(mu, float("inf"))
    a = sweep(pp, vel=rest, invmu=inviscid)
    b = sweep(pp * factor, vel=rest, invmu=inviscid)
    torch.testing.assert_close(b, a * factor[None, :], rtol=1e-12,
                               atol=1e-13 * float(a.abs().max()))
    # a structure receiver deep in the bar has structure senders only, and a
    # live pressure term all the same
    s_rows = ((frame.prop >= 2) & (frame.prop < 4)).nonzero()[:, 0]
    assert float(a[:, s_rows].abs().max()) > 0
    # viscosity: linear in the velocities, and half of phase 2's weight --
    # the viscous part of the virial of a pressure-free fluid
    zero_p = torch.zeros_like(pp)
    visc = sweep(zero_p)
    visc2 = sweep(zero_p, vel=2.0 * frame.vel)
    torch.testing.assert_close(visc2, 2.0 * visc, rtol=1e-12,
                               atol=1e-13 * float(visc.abs().max()))
    assert float(visc.abs().max()) > 0
    torch.testing.assert_close(base, sweep(pp, vel=rest, invmu=inviscid) + visc,
                               rtol=1e-10, atol=1e-12 * float(base.abs().max()))


def test_cuda_tensor_never_takes_the_plain_virial(monkeypatch):
    """``virial_sweep`` picks the plain version only because the tensor lies
    on the CPU: for anything else it goes to the kernel path (which, without
    a compiler or a card, raises)."""
    jsim, (pos, vel, prop) = _jax_sim("main_path")
    grid, ks, tables, cfg = port_statics(jsim)
    frame = port_frame(jpk.sort_frame(pos, vel, prop, jsim._frame_grid,
                                      with_cell_start=False))
    win = pw.compute_windows(frame, grid, cfg)
    offs, _ = pw.row_offsets(grid)

    class FakeCuda:
        is_cuda = True

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(pwt, "virial_sweep_plain", boom)
    with pytest.raises(Exception) as e:
        pwt.virial_sweep(frame._replace(pos=FakeCuda()), None, None, None,
                         None, win[0], win[1], offs, ks, cfg, tables,
                         volume=1.0, two_dimensional=True)
    assert not isinstance(e.value, AssertionError)
    assert "virial_sweep" in pwt.launch_counts
