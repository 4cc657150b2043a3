"""The PyTorch port against goldens produced by the reference binary
(provenance in ``goldens/README.md``): the coupled gate case and the
pure-fluid dam case after 100 steps, the Rolling1 module (clamped structure
block) after 100 and the Hydroelastic module (water column on a clamped
slab) after 200, loaded through ``load_case`` from the committed ``.data``
and a grid generated from the committed ``.boid``, float64 on the CPU: on
the field-major window sweep (the plain versions of its kernels), and again
on the packed engine at cell capacity 12, as the JAX package's goldens run
(``tests/test_golden.py``).

Tolerances are those the JAX package holds itself to against the same files
(``tests/test_golden.py``): positions within 2.0e-6 m (Hydroelastic 5.0e-5
m, its structure rows 1.0e-5 m), dam velocities within 5.0e-4 m/s -- just
above the ``.prof`` ``%e`` six-digit floor plus the measured drift."""

import gzip
import os

import numpy as np
import pytest

from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu_torch.config import NumericsConfig
from particlemethod_fsi_tpu_torch.generator import generate_case
from particlemethod_fsi_tpu_torch.solver import Simulation, load_case
from particlemethod_fsi_tpu_torch.state import to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "goldens")


def load_golden(path):
    with gzip.open(path, "rt") as f:
        t = float(f.readline())
        f.readline()
        rows = np.loadtxt(f)
    return t, rows


# the numerics each golden runs on: the field-major window sweep, and the
# packed engine at the cell capacity the JAX package's goldens run it at
# (tests/test_golden.py)
NUMERICS = {"pallas_t": dict(backend="pallas_t", pallas_block=32),
            "packed": dict(backend="packed", cell_capacity=12)}


def run_steps(tmp_path, case_dir, name, gold_dir, n_steps, scene="dam",
              data=None, backend="pallas_t"):
    """The grid comes from the case's ``.boid`` through the port's generator
    command (written under ``tmp_path``), the physics from the golden's own
    ``.data`` (``data``, else ``<name>.data``) and the scene module
    ``scene``; float64 on ``backend`` (:data:`NUMERICS`)."""
    os.symlink(os.path.join(REPO, "cases", case_dir, name + ".boid"),
               tmp_path / (name + ".boid"))
    generate_case(str(tmp_path / name))
    cfg, grid = load_case(
        os.path.join(GOLD, gold_dir, data or name + ".data"),
        tmp_path / (name + ".grid"), scene=scene,
        numerics=NumericsConfig(dtype="float64", **NUMERICS[backend]))
    sim = Simulation(cfg, grid, device="cpu")
    assert sim._backend == backend
    state, done, ok = sim.run_chunk_guarded(sim.state0, n_steps)
    assert (done, ok) == (n_steps, True)
    return sim, to_numpy(state, sim.n)


def check_gate(tmp_path, backend):
    """Coupled FSI (dam break on a clamped elastic gate, five elastic
    substeps a step) against the reference binary after 100 steps."""
    sim, out = run_steps(tmp_path, "fsi_gate", "gate", "gate", 100,
                         backend=backend)
    assert sim.n == 6724 and sim.has_structure and sim.cfg.substeps == 5
    t, g = load_golden(os.path.join(GOLD, "gate", "gate100.prof.gz"))
    assert t == pytest.approx(0.01) and out["time"] == pytest.approx(0.01)
    np.testing.assert_array_equal(out["prop"], g[:, 0].astype(np.int32))
    dp = np.abs(out["pos"][:, :2] - g[:, 1:3]).max()
    assert dp < 2.0e-6, f"position diff {dp:.3e} m vs golden"


def check_dam(tmp_path, backend):
    """Pure-fluid dam break against the reference binary after 100 steps."""
    sim, out = run_steps(tmp_path, "dam", "dam", "dam", 100, backend=backend)
    assert sim.n == 6650 and not sim.has_structure
    t, g = load_golden(os.path.join(GOLD, "dam", "dam100.prof.gz"))
    assert t == pytest.approx(0.01)
    np.testing.assert_array_equal(out["prop"], g[:, 0].astype(np.int32))
    dp = np.abs(out["pos"][:, :2] - g[:, 1:3]).max()
    dv = np.abs(out["vel"][:, :2] - g[:, 7:9]).max()
    assert dp < 2.0e-6, f"position diff {dp:.3e} m vs golden"
    assert dv < 5.0e-4, f"velocity diff {dv:.3e} m/s vs golden"


def check_rolling1(tmp_path, backend):
    """Rolling1 module (clamped structure block, y0 < 0.003) against the
    reference binary built with ``#define Rolling1`` after 100 steps."""
    sim, out = run_steps(tmp_path, "rolling", "rolling", "rolling1", 100,
                         scene="rolling1", data="r1f.data", backend=backend)
    assert sim.has_structure and sim.cfg.scene.name == "rolling1"
    t, g = load_golden(os.path.join(GOLD, "rolling1", "r1f_0100.prof.gz"))
    assert t == pytest.approx(0.01) and out["time"] == pytest.approx(0.01)
    np.testing.assert_array_equal(out["prop"], g[:, 0].astype(np.int32))
    dp = np.abs(out["pos"][:, :2] - g[:, 1:3]).max()
    assert dp < 2.0e-6, f"position diff {dp:.3e} m vs golden"


def check_hydroelastic(tmp_path, backend):
    """Hydroelastic module (x0 < 0.01 or x0 > 1.99 clamp): a water column
    on a clamped elastic slab against the reference binary built with
    ``#define Hydroelastic`` after 200 steps."""
    sim, out = run_steps(tmp_path, "hydroelastic", "hydro", "hydro", 200,
                         scene="hydroelastic", backend=backend)
    assert sim.has_structure and sim.cfg.scene.name == "hydroelastic"
    t, g = load_golden(os.path.join(GOLD, "hydro", "hydro0200.prof.gz"))
    assert t == pytest.approx(0.01) and out["time"] == pytest.approx(0.01)
    np.testing.assert_array_equal(out["prop"], g[:, 0].astype(np.int32))
    dp = np.abs(out["pos"][:, :2] - g[:, 1:3]).max()
    assert dp < 5.0e-5, f"position diff {dp:.3e} m vs golden"
    typ = g[:, 0].astype(int)
    struct = (typ >= 2) & (typ < 4)
    ds = np.abs(out["pos"][struct, :2] - g[struct, 1:3]).max()
    assert ds < 1.0e-5, f"structure position diff {ds:.3e} m vs golden"


def test_gate_golden_100_steps(tmp_path):
    check_gate(tmp_path, "pallas_t")


def test_dam_golden_100_steps(tmp_path):
    check_dam(tmp_path, "pallas_t")


def test_rolling1_golden_100_steps(tmp_path):
    check_rolling1(tmp_path, "pallas_t")


def test_hydroelastic_golden_200_steps(tmp_path):
    check_hydroelastic(tmp_path, "pallas_t")


CHECKS = dict(gate=check_gate, dam=check_dam, rolling1=check_rolling1,
              hydroelastic=check_hydroelastic)


@pytest.mark.parametrize("case", list(CHECKS))
def test_golden_on_packed(tmp_path, case):
    """Each golden again on the packed engine at cell capacity 12, as the
    JAX package's goldens run."""
    CHECKS[case](tmp_path, "packed")
