"""PyTorch port vs JAX package: the file formats.  ``.data`` parsing and
writing, ``.grid``/``.prof`` and ``.vtk`` bytes (the compiled writer and the
numpy writer each against the JAX package's writer), the generator and the
binary checkpoint.  Everything is exact: equal configs, equal bytes, equal
arrays.  Scratch files live under ``tmp_path``."""

import dataclasses
import glob
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_common import port_cfg
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu import generator as jgen
from particlemethod_fsi_tpu.io import data_file as jdata
from particlemethod_fsi_tpu.io import grid_file as jgrid
from particlemethod_fsi_tpu.io import native as jnative
from particlemethod_fsi_tpu.io import vtk_writer as jvtk
from particlemethod_fsi_tpu.state import ParticleState as JaxState
from particlemethod_fsi_tpu.utils import checkpoint as jckpt
from particlemethod_fsi_tpu_torch import convert
from particlemethod_fsi_tpu_torch import generator as pgen
from particlemethod_fsi_tpu_torch.io import data_file as pdata
from particlemethod_fsi_tpu_torch.io import grid_file as pgrid
from particlemethod_fsi_tpu_torch.io import native as pnative
from particlemethod_fsi_tpu_torch.io import vtk_writer as pvtk
from particlemethod_fsi_tpu_torch.models import bench_config
from particlemethod_fsi_tpu_torch.utils import checkpoint as pckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_FILES = sorted(
    os.path.relpath(p, REPO)
    for pat in ("cases/*/*.data", "goldens/*/*.data")
    for p in glob.glob(os.path.join(REPO, pat)))


def _writer_or_skip(writer):
    """``use_native`` for the writer under test; the compiled case is skipped
    only on a machine with no C++ compiler."""
    if writer == "compiled" and pnative.find_compiler() is None:
        pytest.skip("no C++ compiler on this machine")
    return writer == "compiled"


def _need_jax_compiled_writer():
    """The JAX package's bytes of reference are those of its compiled writer
    (its numpy writer formats some blocks differently)."""
    if jnative.ensure_built() is None:
        pytest.skip("the JAX package's IO library is not built here")


@pytest.mark.parametrize("path", DATA_FILES)
def test_parse_data_file_equals_jax(path):
    want = jdata.parse_data_file(os.path.join(REPO, path))
    got = pdata.parse_data_file(os.path.join(REPO, path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == port_cfg(want)


def test_data_files_were_found():
    assert len(DATA_FILES) >= 14
    assert "cases/fsi_gate/gate.data" in DATA_FILES


@pytest.mark.parametrize("which", ["bench", "gate", "rolling", "odd_numbers"])
def test_write_data_file_round_trip(which, tmp_path):
    if which == "bench":
        cfg = bench_config()
    elif which == "odd_numbers":
        # values that %g would cut: the writer prints repr
        ratio = [[1.0] * 6 for _ in range(6)]
        ratio[1][4] = 1.0 / 3.0
        cfg = bench_config().replace(
            dt=1.2345678901234e-5, gravity=(0.1 + 0.2, -9.80665, 1e-300),
            surface_tension=(0.072, 0.05, 0.0, 0.0, 1.0 / 7.0, 0.3),
            interaction_ratio=tuple(tuple(r) for r in ratio))
    else:
        name = {"gate": "fsi_gate/gate", "rolling": "rolling/rolling"}[which]
        cfg = pdata.parse_data_file(os.path.join(REPO, "cases", name + ".data"))
    path = tmp_path / "case.data"
    pdata.write_data_file(cfg, path)
    back = pdata.parse_data_file(path)
    # the .data tier carries everything but scene, numerics, compat and
    # dimensionality
    back = back.replace(scene=cfg.scene, numerics=cfg.numerics,
                        compat=cfg.compat, two_dimensional=cfg.two_dimensional)
    assert back == cfg
    # the 4-column rows land in their slots of the 6-slot tuples
    text = path.read_text()
    ym = [ln for ln in text.splitlines() if ln.startswith("YoungModulus")][0]
    assert [float(t) for t in ym.split()[1:]] == list(cfg.young_modulus[2:])
    # and the JAX package reads the file to the same config
    assert dataclasses.asdict(jdata.parse_data_file(path)) == {
        **dataclasses.asdict(back),
        "scene": dataclasses.asdict(jdata.CaseConfig().scene),
        "numerics": dataclasses.asdict(jdata.CaseConfig().numerics),
        "compat": dataclasses.asdict(jdata.CaseConfig().compat),
        "two_dimensional": True}


def _arrays(n=257, seed=3):
    rng = np.random.default_rng(seed)
    return dict(
        prop=rng.integers(0, 6, n).astype(np.int32),
        position=rng.normal(size=(n, 3)),
        initial_position=rng.normal(size=(n, 3)),
        velocity=rng.normal(size=(n, 3)) * 1e-7,
        stress=rng.normal(size=(n, 3, 3)) * 1e5,
        strain=rng.normal(size=(n, 3, 3)) * 1e-4,
        acceleration=rng.normal(size=(n, 3)) * 9.81,
        force=rng.normal(size=(n, 3)) * 1e-3,
        initial_neighbor_count=rng.integers(0, 30, n).astype(np.int32),
        neighbor_count=rng.integers(0, 30, n).astype(np.int32),
    )


def _grid(cls, a, time=0.0123):
    return cls(time=time, spacing=1e-3, domain_min=np.array([-0.1, 0.0, 0.0]),
               domain_max=np.array([1.0, 2.0, 1e-3]), prop=a["prop"],
               position=a["position"], initial_position=a["initial_position"],
               velocity=a["velocity"])


@pytest.mark.parametrize("generator_style", [False, True])
@pytest.mark.parametrize("writer", ["compiled", "numpy"])
def test_grid_bytes_equal_jax(writer, generator_style, tmp_path):
    use_native = _writer_or_skip(writer)
    a = _arrays()
    jgrid.write_grid_file(_grid(jgrid.GridData, a), tmp_path / "j.grid",
                          generator_style=generator_style)
    pgrid.write_grid_file(_grid(pgrid.GridData, a), tmp_path / "p.grid",
                          generator_style=generator_style,
                          use_native=use_native)
    want = (tmp_path / "j.grid").read_bytes()
    assert (tmp_path / "p.grid").read_bytes() == want
    assert want.count(b"\n") == 2 + 257
    # and both readers of the port read it back as the JAX reader does
    jg = jgrid.read_grid_file(tmp_path / "p.grid")
    pg = pgrid.read_grid_file(tmp_path / "p.grid", use_native=use_native)
    assert pg.time == jg.time and pg.spacing == jg.spacing and pg.n == 257
    for k in ("domain_min", "domain_max", "prop", "position",
              "initial_position", "velocity"):
        np.testing.assert_array_equal(getattr(pg, k), getattr(jg, k), err_msg=k)
    assert pg.prop.dtype == np.int32
    assert pgrid.segment_counts(pg.prop) == jgrid.segment_counts(jg.prop)


@pytest.mark.parametrize("fields", ["all", "some_missing", "float32_state"])
@pytest.mark.parametrize("writer", ["compiled", "numpy"])
def test_vtk_bytes_equal_jax(writer, fields, tmp_path):
    use_native = _writer_or_skip(writer)
    _need_jax_compiled_writer()
    a = _arrays()
    extra = {"VirialPressureAtParticle":
             np.random.default_rng(4).normal(size=257) * 1e3}
    if fields == "some_missing":
        for k in ("stress", "force", "neighbor_count"):
            a[k] = None
        extra = None
    elif fields == "float32_state":
        for k, v in a.items():
            if v.dtype == np.float64:
                a[k] = v.astype(np.float32)
        extra = {k: v.astype(np.float32) for k, v in extra.items()}
    jvtk.write_vtk_file(tmp_path / "j.vtk", **a, extra_scalars=extra)
    ran = pvtk.write_vtk_file(tmp_path / "p.vtk", **a, extra_scalars=extra,
                              use_native=use_native)
    assert ran == writer
    want = (tmp_path / "j.vtk").read_bytes()
    assert (tmp_path / "p.vtk").read_bytes() == want
    assert want.startswith(b"# vtk DataFile Version 2.0\n")
    assert (b"VirialPressureAtParticle" in want) == (extra is not None)


def test_compiled_io_failures_raise(tmp_path, monkeypatch):
    """Nothing on the compiled path is swallowed: a write that fails raises,
    a build that fails raises with the compiler's output, and only a machine
    without a compiler takes the numpy writer."""
    if pnative.find_compiler() is None:
        pytest.skip("no C++ compiler on this machine")
    a = _arrays(5)
    with pytest.raises(IOError):
        pgrid.write_grid_file(_grid(pgrid.GridData, a),
                              tmp_path / "no_such_dir" / "x.grid")
    with pytest.raises(IOError):
        pvtk.write_vtk_file(tmp_path / "no_such_dir" / "x.vtk", **a)
    with pytest.raises(ValueError):
        pnative.parse_grid_body(b"1 2 3\n", 4)
    assert pnative.writer_name() == "compiled"

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "SOURCE", bad)
    monkeypatch.setattr(pnative, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_searched", False)
    with pytest.raises(RuntimeError, match="bad.cpp"):
        pnative.ensure_built()
    # no compiler: the numpy writer, and the log can say so
    monkeypatch.setattr(pnative, "find_compiler", lambda: None)
    assert pnative.ensure_built() is None
    assert pnative.writer_name() == "numpy"
    assert pvtk.write_vtk_file(tmp_path / "n.vtk", **a) == "numpy"


@pytest.mark.parametrize("case", ["dam/dam", "fsi_gate/gate"])
def test_generator_equals_jax(case, tmp_path):
    boid = os.path.join(REPO, "cases", case + ".boid")
    want = jgen.generate_grid(jgen.parse_boid_file(boid))
    scene = pgen.parse_boid_file(boid)
    assert dataclasses.asdict(scene) == dataclasses.asdict(
        jgen.parse_boid_file(boid))
    got = pgen.generate_grid(scene)
    assert got.n == want.n == {"dam/dam": 6650, "fsi_gate/gate": 6724}[case]
    for k in ("domain_min", "domain_max", "prop", "position",
              "initial_position", "velocity"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    # the command line: <case>.boid -> <case>.grid, the JAX command's bytes
    name = os.path.basename(case)
    for d in ("j", "p"):
        os.makedirs(tmp_path / d)
        shutil.copy(boid, tmp_path / d / (name + ".boid"))
    jgen.main([str(tmp_path / "j" / name)])
    pgen.main([str(tmp_path / "p" / name)])
    assert ((tmp_path / "p" / (name + ".grid")).read_bytes()
            == (tmp_path / "j" / (name + ".grid")).read_bytes())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_cross_loading(direction, tmp_path):
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    n_pad, n = 256, 201
    arrays = dict(
        prop=np.where(np.arange(n_pad) < n, rng.integers(0, 6, n_pad), -1)
        .astype(np.int32),
        pos=rng.normal(size=(n_pad, 3)), pos0=rng.normal(size=(n_pad, 3)),
        vel=rng.normal(size=(n_pad, 3)), wall_center=rng.normal(size=(6, 3)),
        time=0.0375)
    path = tmp_path / "ck.npz"
    if direction == "jax_to_port":
        jckpt.save_checkpoint(
            path, JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            n=n, extra={"note": np.arange(3)})
        state, n_back, extra = pckpt.load_checkpoint(path)
        got = {k: getattr(state, k).numpy() for k in arrays}
        assert isinstance(state.pos, torch.Tensor)
        assert int(state.ghost_overflow) == 0
        via_convert = convert.checkpoint_state_from_numpy(
            dict(np.load(path)), dtype=torch.float64)
        for k in arrays:
            assert torch.equal(getattr(via_convert, k), getattr(state, k)), k
    else:
        pstate = convert.state_from_numpy(arrays, dtype=torch.float64)
        pckpt.save_checkpoint(path, pstate, n=n, extra={"note": np.arange(3)})
        state, n_back, extra = jckpt.load_checkpoint(path)
        got = {k: np.asarray(getattr(state, k)) for k in arrays}
    assert n_back == n
    np.testing.assert_array_equal(extra["note"], np.arange(3))
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # a cast on load, as the command line asks for with --dtype
    s32, _, _ = pckpt.load_checkpoint(path, dtype=torch.float32)
    assert s32.pos.dtype == torch.float32 and s32.prop.dtype == torch.int32
