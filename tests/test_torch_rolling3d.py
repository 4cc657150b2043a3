"""The rocking tank in 3-D, the benchmark's ``rolling3d-2m`` cut to the CPU:
the port's ``Simulation`` against the configuration's plain reference
(``benchmark/references/rolling3d.py``, loaded by path), float64 on the
CPU, on the field-major window sweep (the plain versions of its kernels)
and on the packed engine; the reference against the reference binary's
rocking-tank golden in 2-D; planted faults that must come out wrong; and
the structure pair search against a brute force.

The tank is the configuration's five cuboids at 5 mm, their walls three
spacings thick as the configuration's are, 16 layers deep (an axis of
eight spacings is too narrow for the port's periodic plans), with the
seed's perturbation of the fluid.  Its domain is widened in x and y so
that only the depth wraps, as in the configuration.  Each run is a few
steps: a 3-D step of the plain sweeps takes seconds here.

Bars.  Port and reference sum the same pairs in other orders, so in
float64 they part by rounding alone: at most 3e-17 m and 2e-14 m/s over
these runs.  Positions are held to 1e-11 m and velocities to 1e-8 m/s:
more than five orders above that rounding, and more than four below
what a static wall, a rotation about the wrong centre or an unclamped
post gives in one step (7.8e-7 m and 2e-3 m/s at the least; the planted
faults below).  The golden is held to 2e-6 m, the bar the port is held
to on the same golden's ``rolling1`` twin (``tests/test_torch_golden.py``);
the reference binary's ``.prof`` keeps six digits."""

import copy
import dataclasses
import gzip
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu_torch.config import CaseConfig, NumericsConfig
from particlemethod_fsi_tpu_torch.generator import generate_case
from particlemethod_fsi_tpu_torch.io.grid_file import GridData
from particlemethod_fsi_tpu_torch.solver import Simulation, load_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from fsibench import harness, traffic  # noqa: E402
from fsibench.pairs import min_image  # noqa: E402
from fsibench.program import Program  # noqa: E402

GOLD = os.path.join(REPO, "goldens", "rolling")
L0 = 5e-3
SEED = 2_100_000_021
POS_BAR = 1e-11  # m
VEL_BAR = 1e-8  # m/s


def reference_module():
    spec = importlib.util.spec_from_file_location(
        "rolling3d_reference", os.path.join(BENCH, "references",
                                            "rolling3d.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = reference_module()


def small_spec(backend: str, rolling=None) -> dict:
    """The cell at 5 mm, 16 layers deep, on ``backend``; ``rolling``
    replaces the configuration's rocking."""
    spec = copy.deepcopy(harness.cell_spec("rolling3d-2m.slosh"))
    cfg = spec["config"]
    w = 3 * L0
    cfg["sizes"] = {"spacing": L0, "depth": 16 * L0}
    cfg["geometry"] = {
        "cuboids_xy": [[1, [0.0, 0.0], [0.06, 0.12]],
                       [2, [0.1, 0.0], [0.11, 0.05]],
                       [4, [-w, -w], [0.2 + w, 0.0]],
                       [4, [-w, 0.0], [0.0, 0.2]],
                       [4, [0.2, 0.0], [0.2 + w, 0.2]]],
        "domain_xy": [[-0.05, -0.05], [0.25, 0.25]]}
    # the shipped 2.5 mm steps scaled to 5 mm: two substeps a step
    cfg["dt"], cfg["elastic_dt"] = 2e-4, 1e-4
    cfg["numerics"].update(backend=backend, pallas_block=32)
    if backend == "packed":
        # the fullest cell at 5 mm (a 3.1-spacing cube at the walls'
        # corners holds 64 rows); fewer would drop pairs
        cfg["numerics"]["cell_capacity"] = 64
    if rolling is not None:
        cfg["scene_physics"]["rolling"] = rolling
    return spec


def start(spec):
    scene = harness.build_scene(spec)
    phys = REF.physics(spec["config"], scene["domain_min"],
                       scene["domain_max"])
    pos, vel = traffic.start_state(scene, spec["cell"]["traffic_params"],
                                   SEED, 3, phys.domain_width, "cpu")
    return scene, phys, pos, vel


def port_run(spec, steps: int, time0: float = 0.0):
    """The port's guarded chunk of ``steps`` from the seed's state at
    ``time0``: ``(scene, physics, start (pos, vel), end (pos, vel))``."""
    scene, phys, pos, vel = start(spec)
    prog = Program(spec["config"], scene, "cpu", dtype="float64")
    s0 = prog.start(pos, vel)
    s0 = s0.replace(time=torch.tensor(time0, dtype=torch.float64))
    state, done, ok = prog.sim.run_chunk_guarded(s0, steps)
    assert (done, ok) == (steps, True)
    assert int(prog.sim.peak_occupancy) <= prog.sim.cell_capacity
    n = prog.n
    return scene, phys, (pos, vel), (state.pos[:n], state.vel[:n])


def reference_run(spec, scene, phys, start_state, time0, steps, **changes):
    """The reference over the same steps; ``changes`` replace fields of
    its physics (the planted faults)."""
    phys = dataclasses.replace(phys, **changes)
    ref = REF.Reference(phys, scene["prop"], scene["pos"], "cpu",
                        precision="float64")
    return ref.run(*start_state, time0, steps), ref


def gaps(port_end, ref_end, width):
    (pp, pv), (rp, rv) = port_end, ref_end
    dx = min_image(pp - rp, torch.as_tensor(width)).norm(dim=1).max()
    dv = (pv - rv).norm(dim=1).max()
    return float(dx), float(dv)


# (name, backend, steps, time0, rolling): the configuration's rocking on
# both sweeps; rocked hard (10 degrees over a 0.02 s period: the far wall
# rows move 5.2 mm, over a spacing, in the three steps); and from a later
# start, where the rocking's angle and rate are those of t = 0.05 s
RUNS = {
    "as configured, pallas_t": ("pallas_t", 2, 0.0, None),
    "as configured, packed": ("packed", 1, 0.0, None),
    "rocked hard, packed": ("packed", 3, 0.0,
                            {"max_angle_deg": 10.0, "period": 0.02}),
    "from t = 0.05 s, packed": ("packed", 1, 0.05, None),
}
_runs: dict = {}


def run(name):
    """The port's run ``name`` of :data:`RUNS`, once a module."""
    if name not in _runs:
        backend, steps, time0, rolling = RUNS[name]
        spec = small_spec(backend, rolling)
        _runs[name] = (spec, steps, time0) + port_run(spec, steps, time0)
    return _runs[name]


@pytest.mark.parametrize("name", list(RUNS))
def test_port_matches_the_reference(name):
    spec, steps, time0, scene, phys, s, end = run(name)
    assert phys.dim == 3 and phys.rolling is not None
    assert int(((scene["prop"] >= 2) & (scene["prop"] < 4)).sum()) == 320
    (rp, rv), ref = reference_run(spec, scene, phys, s, time0, steps)
    dx, dv = gaps(end, (rp, rv), phys.domain_width)
    assert dx < POS_BAR, f"position gap {dx:.3e} m"
    assert dv < VEL_BAR, f"velocity gap {dv:.3e} m/s"
    # the wall rows did turn about Wall6's centre: a step from t turns
    # them by theta(t) - theta(t - dt)
    amp, freq = phys.rolling
    turn = amp * (math.sin(freq * (time0 + (steps - 1) * phys.dt))
                  - math.sin(freq * (time0 - phys.dt)))
    wall = torch.as_tensor(scene["prop"] == 4)
    r = torch.as_tensor(scene["pos"])[wall] - torch.tensor(
        [0.1, 0.1, 0.0], dtype=torch.float64)
    moved = (end[0][wall] - s[0][wall]).norm(dim=1)
    chord = 2.0 * math.sin(0.5 * abs(turn)) * float(r[:, :2].norm(dim=1).max())
    assert float(moved.max()) == pytest.approx(chord, rel=1e-9)
    if name.startswith("rocked hard"):
        assert float(moved.max()) > L0


# (fault, the physics' fields it replaces)
FAULTS = {
    "walls left static": dict(rolling=None),
    "rotated about the bottom centre": dict(
        wall_center=tuple((0.1, 0.0, 0.0) if t == 4 else (0.0, 0.0, 0.0)
                          for t in range(6))),
    "the post unclamped": dict(clamp=None),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_comes_out_wrong(fault):
    spec, steps, time0, scene, phys, s, end = run("as configured, packed")
    assert phys.wall_center[4] == (0.1, 0.1, 0.0)
    assert phys.clamp == (1, 0.003, False)
    (rp, rv), _ = reference_run(spec, scene, phys, s, time0, steps,
                                **FAULTS[fault])
    dx, dv = gaps(end, (rp, rv), phys.domain_width)
    assert dx > 100 * POS_BAR, f"{fault}: position gap only {dx:.3e} m"


def test_reference_refuses_what_it_does_not_do():
    cfg = small_spec("packed")["config"]
    spun = copy.deepcopy(cfg)
    spun["walls"][4]["omega"] = [0.0, 0.0, 1.0]
    with pytest.raises(ValueError, match=r"walls\[4\]\.omega"):
        REF.physics(spun, (0, 0, 0), (0.3, 0.3, 0.08))
    pushed = copy.deepcopy(cfg)
    pushed["walls"][4]["velocity"] = [0.1, 0.0, 0.0]
    with pytest.raises(ValueError, match=r"walls\[4\]\.velocity"):
        REF.physics(pushed, (0, 0, 0), (0.3, 0.3, 0.08))
    scene = harness.build_scene(small_spec("packed"))
    phys = REF.physics(cfg, scene["domain_min"], scene["domain_max"])
    ref = REF.Reference(phys, scene["prop"], scene["pos"], "cpu", "float64")
    pos = torch.as_tensor(scene["pos"])
    with pytest.raises(ValueError, match="wall_motion_end_time"):
        ref.run(pos, torch.zeros_like(pos), 0.2 - phys.dt, 2)


def _config_file(cfg: CaseConfig, spacing: float) -> dict:
    """A port's CaseConfig as a configuration file states it."""
    d = json.loads(json.dumps(dataclasses.asdict(cfg)))
    d["scene_physics"] = d.pop("scene")
    d["sizes"] = {"spacing": spacing}
    return d


def test_reference_matches_the_rolling_golden_in_2d(tmp_path):
    """The reference alone, in 2-D on the shipped case's grid (the port's
    generator on ``cases/rolling/rolling.boid``) and the golden's own
    ``.data`` with the rolling scene, 100 steps against the reference
    binary's ``rolling0100.prof``: the wall rows turned and the water and
    post carried with them, independently of the port."""
    os.symlink(os.path.join(REPO, "cases", "rolling", "rolling.boid"),
               tmp_path / "rolling.boid")
    generate_case(str(tmp_path / "rolling"))
    cfg, grid = load_case(os.path.join(GOLD, "rolling.data"),
                          tmp_path / "rolling.grid", scene="rolling")
    assert cfg.two_dimensional and cfg.scene.rolling is not None
    phys = REF.physics(_config_file(cfg, grid.spacing), grid.domain_min,
                       grid.domain_max)
    assert phys.wall_center[4] == (0.1, 0.1, 0.0) and phys.substeps == 2
    ref = REF.Reference(phys, grid.prop, grid.position, "cpu", "float64")
    pos, _ = ref.run(torch.as_tensor(grid.position),
                     torch.as_tensor(grid.velocity), 0.0, 100)
    with gzip.open(os.path.join(GOLD, "rolling0100.prof.gz"), "rt") as f:
        t = float(f.readline())
        f.readline()
        gold = np.loadtxt(f)
    assert t == pytest.approx(0.01)
    np.testing.assert_array_equal(grid.prop, gold[:, 0].astype(np.int32))
    dp = np.abs(pos.numpy()[:, :2] - gold[:, 1:3]).max()
    assert dp < 2.0e-6, f"position diff {dp:.3e} m vs golden"
    wall = grid.prop == 4
    assert np.abs(pos.numpy()[wall, :2] - grid.position[wall, :2]).max() \
        > 1e-6  # the walls did move


def _brute_force(p0, width, support):
    """Every ordered pair within ``support`` by the minimum image, each
    row's in ascending order: all n^2 differences."""
    d = p0[None, :, :] - p0[:, None, :]
    d -= width * np.floor(d / width + 0.5)
    r2 = np.sum(d * d, axis=2)
    np.fill_diagonal(r2, np.inf)
    return [np.nonzero(row <= support * support)[0] for row in r2]


def _block(lo, hi, l0):
    ax = [lo[d] + (np.arange(int(round((hi[d] - lo[d]) / l0))) + 0.5) * l0
          for d in range(3)]
    g = np.meshgrid(*ax, indexing="ij")
    return np.stack([x.ravel() for x in g], axis=1)


def _solid_scene(two_d: bool):
    """Solids across a periodic seam (x, and z in 3-D), beside fluid rows
    that the search leaves out: ``(grid, config)``."""
    l0 = 1e-3
    depth = l0 if two_d else 0.012
    solid = _block((0.0, 0.0, 0.0), (0.006, 0.008, depth), l0)
    other = _block((0.012, 0.0, 0.0), (0.015, 0.003, min(depth, 0.004)), l0)
    solid[:, 0] = np.mod(solid[:, 0] - 0.003, 0.02)  # across x's seam
    if not two_d:
        solid[:, 2] = np.mod(solid[:, 2] - 0.005, depth)  # and z's
    fluid = _block((0.006, 0.01, 0.0), (0.01, 0.014, depth), l0)
    pos = np.concatenate([fluid, solid, other])
    prop = np.concatenate([np.full(len(fluid), 1), np.full(len(solid), 2),
                           np.full(len(other), 3)]).astype(np.int32)
    grid = GridData(time=0.0, spacing=l0, domain_min=np.zeros(3),
                    domain_max=np.array([0.02, 0.02, depth]), prop=prop,
                    position=pos, initial_position=pos.copy(),
                    velocity=np.zeros_like(pos))
    cfg = CaseConfig(two_dimensional=two_d,
                     numerics=NumericsConfig(dtype="float64",
                                             backend="packed"))
    return grid, cfg


@pytest.mark.parametrize("two_d", [True, False], ids=["2-D", "3-D"])
def test_structure_neighbours_equal_a_brute_force(two_d):
    grid, cfg = _solid_scene(two_d)
    sim = Simulation(cfg, grid, device="cpu")
    idx, mask = sim._initial_structure_neighbors(grid)
    s_idx = np.nonzero((grid.prop >= 2) & (grid.prop < 4))[0]
    want = _brute_force(grid.initial_position[s_idx],
                        np.asarray(sim.domain_width),
                        sim.kernels.support_radius)
    k0 = max(cfg.numerics.max_initial_neighbors,
             int(np.ceil(max(len(w) for w in want) / 8.0)) * 8)
    assert idx.shape == mask.shape == (sim.n_pad, k0)
    other = np.ones(sim.n_pad, dtype=bool)
    other[s_idx] = False
    assert not mask[other].any() and not idx[other].any()
    crossing = 0
    for a, w in zip(s_idx, want):
        np.testing.assert_array_equal(idx[a, :len(w)], s_idx[w])
        assert mask[a, :len(w)].all() and not mask[a, len(w):].any()
        assert not idx[a, len(w):].any()
        crossing += int(np.any(np.abs(grid.initial_position[s_idx[w], 0]
                                      - grid.initial_position[a, 0]) > 0.01))
    assert crossing > 0  # some pairs are found only across the seam


def test_walls_section_and_counter_only_where_the_walls_move():
    """A step of the rocking tank (here in 2-D at 5 mm on the packed
    engine) counts one wall motion (``ops/walls.launch_counts``) and marks
    "walls" from the step's begin, before "read"; the same tank with the
    rocking taken away counts none, marks none, and its "read" begins the
    step, as on every scene whose walls stand still."""
    from particlemethod_fsi_tpu_torch.ops import walls

    for want in (2, 0):
        spec = small_spec("packed")
        cfg = spec["config"]
        if not want:
            del cfg["scene_physics"]["rolling"]
        cfg["two_dimensional"] = True
        cfg["sizes"]["depth"] = L0
        cfg["numerics"]["cell_capacity"] = 16
        scene = harness.build_scene(spec)
        prog = Program(cfg, scene, "cpu", dtype="float64")
        assert prog.sim._walls_static == (want == 0)
        prog.spans_on(True)
        walls.reset_launch_counts()
        _, done, ok = prog.chunk(prog.start(
            torch.as_tensor(scene["pos"]), torch.as_tensor(scene["vel"])), 2)
        names = [n for n, _ in prog.take_spans()]
        prog.spans_on(False)
        assert (done, ok) == (2, True)
        assert walls.launch_counts["wall_motion"] == want
        assert names.count("walls") == want and names.count("read") == 2
        for k, name in enumerate(names):
            if name == "begin" and k + 1 < len(names):
                assert names[k + 1] == ("walls" if want else "read")
