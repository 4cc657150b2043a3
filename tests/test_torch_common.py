"""Helpers of the ``test_torch_*`` files: carry JAX-side objects across to the
PyTorch port as numpy arrays and plain dicts (the port imports nothing of the
JAX package, so the unpacking happens here, on the tests' side)."""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
from particlemethod_fsi_tpu_torch import convert
from particlemethod_fsi_tpu_torch.io.grid_file import GridData as PortGridData

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """PyTorch on one CPU thread while a test module runs (imported into
    each ``test_torch_*`` module that runs the port).  The lane runs six
    workers on eight cores; the port's steps are many small ops, and on
    eight threads a worker each they spend their time waiting for each
    other's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fields_np(obj) -> dict:
    """NamedTuple of arrays -> dict of numpy arrays."""
    return {k: np.asarray(v) for k, v in obj._asdict().items()}


def port_cfg(cfg):
    return convert.case_config_from_dict(dataclasses.asdict(cfg))


def port_grid(grid) -> PortGridData:
    return PortGridData(**{
        f.name: (np.array(getattr(grid, f.name))
                 if isinstance(getattr(grid, f.name), np.ndarray)
                 else getattr(grid, f.name))
        for f in dataclasses.fields(grid)})


def port_state(jstate):
    return convert.state_from_numpy(jax_to_numpy(jstate), dtype=F64)


def port_frame(jframe):
    return convert.sorted_frame_from_numpy(fields_np(jframe), dtype=F64)


def port_packed_frame(jframe):
    """A JAX frame of ``sort_frame(..., with_cell_start=True)``, with its
    cell offsets and cell coordinates."""
    return convert.sorted_frame_from_numpy(fields_np(jframe), dtype=F64,
                                           packed=True)


def port_statics(jsim):
    """(grid, kernels, tables, window config) of a JAX Simulation, as the
    port's objects."""
    return (
        convert.cell_grid_from_dict(dataclasses.asdict(jsim._frame_grid)),
        convert.kernel_set_from_dict(dataclasses.asdict(jsim.kernels)),
        convert.type_tables_from_numpy(fields_np(jsim.tables), dtype=F64),
        convert.window_config_from_dict(jsim._pcfg._asdict()),
    )


def jitter(grid, seed: int, *, pos_scale: float = 0.05, vel_scale: float = 0.05):
    """Seeded numpy noise on the in-plane (or all, in 3-D) positions and
    velocities of the non-wall particles, so that no pair sits exactly on a
    radius boundary and the velocity terms are live."""
    rng = np.random.default_rng(seed)
    flat = np.all(grid.position[:, 2] == grid.position[0, 2])
    nd = 2 if flat else 3
    free = grid.prop < 4
    grid.position[free, :nd] += rng.normal(
        scale=pos_scale * grid.spacing, size=(int(free.sum()), nd))
    grid.velocity[free, :nd] = rng.normal(
        scale=vel_scale, size=(int(free.sum()), nd))
    return grid


WINDOW_KW = dict(backend="pallas_t", pallas_block=32, pallas_wmax=128)


def bench_sims(n_side: int, backend: str = "pallas_t", **numerics_kw):
    """(JAX Simulation, port Simulation) of the bench scene, float64, CPU."""
    import bench
    from particlemethod_fsi_tpu_torch.models import build_case

    kw = dict(dtype="float64", pallas_block=32, pallas_wmax=128,
              backend=backend, **numerics_kw)
    jsim = bench.build_case(n_side, **kw)
    psim = build_case(n_side, device="cpu", **kw)
    return jsim, psim


def close_to_scale(name, got, want, scale=None):
    """rtol 1e-12, atol 1e-13 of the field's scale: the largest magnitude of
    the field itself or, where the field is a difference of larger terms
    (the EOS: kappa * (sum - n0)), of those terms."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if scale is None:
        scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13 * scale,
                               err_msg=name)


def field_scales(jsim, jf1):
    """Magnitudes of the terms each EOS field is a difference of (tables
    taken over the particle types present)."""
    ks = jsim.kernels
    present = np.unique(np.asarray(jsim.state0.prop))
    present = present[present >= 0]
    t = type(jsim.tables)(*[np.asarray(v)[present] for v in jsim.tables])
    wp = float(np.max(np.abs(np.asarray(jf1["vol_strain"]) + ks.n0p)))
    dvg = float(np.max(np.abs(np.asarray(jf1["divergence"]))))
    da = max(float(np.max(np.abs(np.asarray(jf1["density_a"])))), ks.n0a)
    pp = (float(np.max(np.asarray(t.bulk_modulus))) * wp
          + float(np.max(np.asarray(t.bulk_viscosity))) * dvg)
    pa = float(np.max(np.abs(np.asarray(t.cof_a)))) * da / ks.spacing
    # the force is a sum over ~2 dozen neighbours of (P_i + P_j) dwp V terms
    # that largely cancel (near-hydrostatic fluid), and it inherits the EOS
    # amplification through P: scale it to those terms
    norm_p = 1.0 / ks.swp / ks.radius_p**ks.dim_power
    p_max = float(np.max(np.abs(np.asarray(jf1["pressure_p"]))))
    force = 24 * 2 * (p_max + pp) * norm_p * (2.0 / ks.radius_p) * jsim.volume
    return dict(vol_strain=wp, pressure_p=pp, pressure_a=pa, force=force)
