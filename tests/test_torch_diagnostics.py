"""PyTorch port vs JAX package: the output-time diagnostics and the guarded
chunk, float64 on the CPU, the JAX side on its ``pallas_t`` backend (Pallas
in interpret mode).

Tolerances.  ``Simulation.diagnostics`` is compared key by key: same keys,
shapes and kinds of dtype, integers equal, floats rtol 1e-12 with atol 1e-12
of the scale of the terms a field is made from (phase-1 sums in another
order; the EOS fields and all that is built on the pressures -- force,
accel, virial -- carry that rounding amplified by ``kappa * (sum - n0)``, so
their scale is that of the EOS terms).  The guarded chunk is held to
``run_chunk`` bit for bit on a healthy run, and to the JAX guarded chunk's
``steps_done`` on a run that blows up."""

import jax
import numpy as np
import pytest
import torch

from cases import dam_like_config, mini_fsi
from test_torch_common import (
    WINDOW_KW,
    bench_sims,
    port_cfg,
    port_grid,
    port_state,
)
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu_torch import convert
from particlemethod_fsi_tpu_torch.solver import Simulation
from particlemethod_fsi_tpu_torch.state import to_numpy


def _sims(scene, **numerics_kw):
    if scene == "bench24":
        return bench_sims(24, **numerics_kw)
    grid = mini_fsi()
    cfg = dam_like_config(**{**WINDOW_KW, **numerics_kw}).replace(
        scene=SCENES["dam"], young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))
    return (JaxSimulation(cfg, grid),
            Simulation(port_cfg(cfg), port_grid(grid), device="cpu"))


def _copy(jstate):
    # the JAX chunk runners donate their carry on an accelerator
    return jax.tree_util.tree_map(lambda x: x.copy(), jstate)


def _scales(jsim, want) -> dict:
    """Magnitudes of the terms the pressure-borne fields are sums of."""
    ks = jsim.kernels
    wp = float(np.abs(np.asarray(want["vol_strain"]) + ks.n0p).max())
    p_max = float(np.abs(want["pressure_p"]).max())
    pp = float(np.asarray(jsim.tables.bulk_modulus).max()) * wp + p_max
    norm_p = 1.0 / ks.swp / ks.radius_p**ks.dim_power
    # some two dozen neighbours, each a (P_i + P_j) dwp V term
    force = 24 * 2 * pp * norm_p * (2.0 / ks.radius_p) * jsim.volume
    mass = float(np.asarray(jsim.tables.density).min()) * jsim.volume
    vir = force * ks.support_radius / jsim.volume
    # strain = (F^T F - I) / 2 is a difference of terms of size 1, and the
    # stress is that times the Lame moduli
    lame = float(np.abs(np.asarray(jsim.solid.lam)).max()
                 + 2.0 * np.abs(np.asarray(jsim.solid.mu)).max())
    return dict(force=force, accel=force / mass, pressure_p=pp,
                vol_strain=wp, virial_stress=vir, virial_pressure=vir,
                strain=1.0, deform_gradient=1.0, stress=lame)


@pytest.mark.parametrize("scene", ["mini_fsi", "bench24"])
def test_diagnostics_match_jax(scene):
    jsim, psim = _sims(scene, rebuild_margin=0.5)
    jstate = jsim.run_chunk(_copy(jsim.state0), 5)
    want = convert.diagnostics_from_numpy(jsim.diagnostics(jstate))
    # the port's diagnostics of the very same state
    got = psim.diagnostics(port_state(jstate))

    assert set(got) == set(want)
    scales = _scales(jsim, want)
    for k in sorted(want):
        g, w = got[k], np.asarray(want[k])
        assert g.shape == w.shape, k
        assert g.dtype.kind == w.dtype.kind, (k, g.dtype, w.dtype)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g.dtype == w.dtype == np.float64, k
            scale = scales.get(k, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12 * scale,
                                       err_msg=k)
    # live: neighbours were counted, the virial is not zero, and with a bar
    # the solid tensors are filled in subset rows only
    assert int(got["neighbor_count"].max()) >= 8
    assert float(np.abs(got["virial_stress"]).max()) > 0
    assert int(got["ghost_overflow"]) == 0
    assert int(got["window_overflow"]) > 0 and int(got["cell_overflow"]) > 0
    s_rows = (np.asarray(jstate.prop) >= 2) & (np.asarray(jstate.prop) < 4)
    assert float(np.abs(got["stress"][s_rows]).max()) > 0
    assert not got["stress"][~s_rows].any()
    assert np.allclose(got["deform_gradient"][s_rows][:, 2, 2], 0.0)
    assert int(got["initial_neighbor_count"].max()) > 0


def test_diagnostics_use_a_fresh_frame_and_leave_the_state_alone():
    """The diagnostics never read the step's C8 cache: after a chunk that
    reused its frame they give, bit for bit, what a simulation that never
    stepped gives for the same state."""
    _, cached = _sims("mini_fsi", rebuild_margin=0.5)
    _, fresh = _sims("mini_fsi", rebuild_margin=0.5)
    state = cached.run_chunk(cached.state0, 6)
    assert cached.rebuilds < 6
    before = to_numpy(state)
    a, b = cached.diagnostics(state), fresh.diagnostics(state)
    for k, v in to_numpy(state).items():
        np.testing.assert_array_equal(v, before[k])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert set(cached.last_diagnostics_seconds) == {"device_and_copies",
                                                    "host_assembly"}


@pytest.mark.parametrize("margin", [0.0, 0.5])
def test_guarded_chunk_equals_run_chunk_on_a_healthy_run(margin):
    _, psim = _sims("mini_fsi", rebuild_margin=margin)
    s0 = psim.state0
    want = psim.run_chunk(s0, 8)
    rebuilds = psim.last_chunk_rebuilds
    got, done, ok = psim.run_chunk_guarded(s0, 8)
    assert (done, ok) == (8, True)
    assert psim.last_chunk_rebuilds == rebuilds
    for k in ("pos", "vel", "time", "prop"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("margin", [0.0, 0.5])
def test_guarded_chunk_stops_at_the_first_bad_state_like_jax(margin):
    """A time step far past the CFL bound blows up within a few steps: both
    guarded chunks stop after the same number of steps, the returned state is
    the first bad one, and the state before it was still good."""
    jsim, psim = _sims("mini_fsi", rebuild_margin=margin)
    big = dict(dt=2e-2, elastic_dt=2e-2)
    jsim = JaxSimulation(jsim.cfg.replace(**big), mini_fsi())
    psim = Simulation(psim.cfg.replace(**big), port_grid(mini_fsi()),
                      device="cpu")
    n = 40
    _, jdone, jok = jsim.run_chunk_guarded(_copy(jsim.state0), n)
    state, done, ok = psim.run_chunk_guarded(psim.state0, n)
    assert not bool(jok) and not ok
    assert done == int(jdone) and 1 <= done < n

    def top2(s):
        return float(psim._top_speed2(s))

    assert not psim._healthy(top2(state))
    # the bad step is counted, and nothing before it was bad
    prev, d2, ok2 = psim.run_chunk_guarded(psim.state0, done - 1)
    assert (d2, ok2) == (done - 1, True) and psim._healthy(top2(prev))
