"""The rocking tank (``rolling3d-2m``, cell ``rolling3d-2m.slosh``): its
file is the port's parse of the shipped case but for the stated cuts, its
scene has the stated counts a layer, its walls' reader reads the program's
"walls" section, which the program marks where the walls move and nowhere
else."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from fsibench import harness, physics, traffic
from fsibench.program import Program, case_config, section_ms

CELL = "rolling3d-2m.slosh"
# what the configuration changes from the shipped case: the steps scaled
# to 1 mm, 3-D, the numerics of cases/rolling/execute.sh, and the output
# schedule, which a configuration file does not state
CUTS = ("dt", "elastic_dt", "two_dimensional", "numerics", "output_interval",
        "vtk_output_interval", "end_time")


def _spec():
    return copy.deepcopy(harness.cell_spec(CELL))


def test_file_is_the_ports_parse_of_the_shipped_case(tmp_path):
    from particlemethod_fsi_tpu_torch.generator import generate_case
    from particlemethod_fsi_tpu_torch.solver import load_case

    os.symlink(os.path.join(harness.ROOT, "cases", "rolling", "rolling.boid"),
               tmp_path / "rolling.boid")
    generate_case(str(tmp_path / "rolling"))
    theirs, _ = load_case(os.path.join(harness.ROOT, "cases", "rolling",
                                       "rolling.data"),
                          tmp_path / "rolling.grid", scene="rolling")
    cfg = _spec()["config"]
    mine = case_config(cfg)
    for f in dataclasses.fields(mine):
        if f.name not in CUTS:
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.walls[4].center == (0.1, 0.1, 0.0)
    assert mine.scene.rolling.max_angle_deg == 2.0
    assert mine.scene.rolling.period == 1.646
    assert (mine.scene.clamp_axis, mine.scene.clamp_threshold) == (1, 0.003)
    # the cuts: the steps scaled with the spacing (2.5 mm -> 1 mm), two
    # substeps as shipped, 3-D, and the shipped execute.sh's margin
    scale = cfg["sizes"]["spacing"] / 0.0025
    assert mine.dt == pytest.approx(theirs.dt * scale)
    assert mine.elastic_dt == pytest.approx(theirs.elastic_dt * scale)
    assert mine.substeps == theirs.substeps == 2
    assert not mine.two_dimensional and theirs.two_dimensional
    assert mine.numerics.rebuild_margin == 0.5
    assert (mine.numerics.dtype, mine.numerics.backend,
            mine.numerics.pallas_block) == ("float32", "pallas_t", 64)
    assert cfg["reduced"] == [] and cfg["reference"] == "rolling3d"


def test_geometry_is_the_shipped_tank_at_1mm():
    """The five cuboids of ``cases/rolling/rolling.boid`` in its order, the
    walls three rows thick at 1 mm as they are at 2.5 mm, the domain as
    shipped."""
    from particlemethod_fsi_tpu_torch.generator import parse_boid_file

    boid = parse_boid_file(os.path.join(harness.ROOT, "cases", "rolling",
                                        "rolling.boid"))
    geo = _spec()["config"]["geometry"]
    l0, shipped = 0.001, boid.particle_distance
    assert [p.type for p in boid.primitives] == [k for k, _, _ in
                                                 geo["cuboids_xy"]]
    # a wall's outer face three rows out: at 3 l0 where the case has it at
    # three of its spacings; every other face where the case has it
    outer = {-3 * shipped: -3 * l0, 0.2 + 3 * shipped: 0.2 + 3 * l0}
    for p, (_, lo, hi) in zip(boid.primitives, geo["cuboids_xy"]):
        for d in range(2):
            for mine, theirs in ((lo[d], p.lower[d]), (hi[d], p.upper[d])):
                want = next((v for o, v in outer.items()
                             if abs(theirs - o) < 1e-9), theirs)
                assert mine == pytest.approx(want)
    assert [list(boid.lower_domain[:2]),
            list(boid.upper_domain[:2])] == geo["domain_xy"]


def test_full_scene_has_the_stated_counts():
    spec = _spec()
    cfg = spec["config"]
    scene = harness.build_scene(spec)
    layers = round(cfg["sizes"]["depth"] / cfg["sizes"]["spacing"])
    assert layers == 210
    counts = np.bincount(scene["prop"], minlength=5)
    assert counts[1] == 7200 * layers
    assert counts[2] == 500 * layers == 105000
    assert counts[4] == (618 + 1200) * layers
    assert counts.sum() == cfg["particles"] == 1998780
    z = np.unique(scene["pos"][:, 2])
    assert z.size == layers
    assert scene["domain_max"][2] - scene["domain_min"][2] == \
        cfg["sizes"]["depth"]


def test_walls_reader_on_a_hand_made_context():
    mod = harness.load_module(harness.metric_path("walls_ms"), "walls_ms")
    assert mod.read(dict(steps=250, spans={"walls": 105.0, "read": 400.0})) \
        == pytest.approx(0.42)
    assert mod.read(dict(steps=250, spans={"read": 400.0})) is None
    assert mod.read(dict(steps=250, spans={})) is None
    # the split twin of the solid's reader reads the same section
    assert harness.metric_path("solid_ms.host_rate").endswith("solid_ms.py")


def _tank_2d(spec):
    """The cell's tank in 2-D at 5 mm on the packed engine: a scene the
    CPU steps in a fraction of a second."""
    cfg = spec["config"]
    l0, w = 5e-3, 15e-3
    cfg["two_dimensional"] = True
    cfg["sizes"] = {"spacing": l0, "depth": l0}
    cfg["geometry"]["cuboids_xy"] = [
        [1, [0.0, 0.0], [0.06, 0.12]], [2, [0.1, 0.0], [0.11, 0.05]],
        [4, [-w, -w], [0.2 + w, 0.0]], [4, [-w, 0.0], [0.0, 0.2]],
        [4, [0.2, 0.0], [0.2 + w, 0.2]]]
    cfg["geometry"]["domain_xy"] = [[-0.05, -0.05], [0.25, 0.25]]
    cfg["dt"], cfg["elastic_dt"] = 2e-4, 1e-4
    cfg["numerics"].update(backend="packed", cell_capacity=16)
    return spec


def _marked(spec, steps: int):
    """Sections (ms, summed) and the wall-motion count of one marked
    guarded chunk of ``steps`` on the CPU."""
    from particlemethod_fsi_tpu_torch.ops import walls

    cfg = spec["config"]
    scene = harness.build_scene(spec)
    ref_physics, _ = harness.reference_for(cfg)
    phys = ref_physics(cfg, scene["domain_min"], scene["domain_max"])
    pos, vel = traffic.start_state(scene, spec["cell"]["traffic_params"],
                                   2_100_000_031, phys.dim,
                                   phys.domain_width, "cpu")
    prog = Program(cfg, scene, "cpu", dtype="float64")
    prog.spans_on(True)
    walls.reset_launch_counts()
    state, done, ok = prog.chunk(prog.start(pos, vel), steps)
    assert (done, ok) == (steps, True)
    events = prog.take_spans()
    prog.spans_on(False)
    return events, walls.launch_counts["wall_motion"]


def test_walls_section_and_counter_where_the_walls_move():
    """The rocking tank marks "walls" once a step, before "read", and
    counts one wall motion a step; a scene whose walls stand still (the
    small dam) marks and counts neither, and its "read" begins the step as
    before."""
    torch.set_num_threads(min(4, torch.get_num_threads()))
    events, count = _marked(_tank_2d(_spec()), 3)
    names = [n for n, _ in events]
    assert count == 3 and names.count("walls") == 3
    for k, name in enumerate(names):
        if name == "walls":
            assert names[k - 1] == "begin" and names[k + 1] == "read"
    spans = section_ms(events)
    assert spans["walls"] > 0 and spans["read"] > 0
    reader = harness.load_module(harness.metric_path("walls_ms"), "walls_ms")
    assert reader.read(dict(steps=3, spans=spans)) == pytest.approx(
        spans["walls"] / 3)

    from test_fsibench_reference import small_spec

    dam = small_spec("dam3d-2m.collapse")
    dam["config"]["numerics"].update(backend="packed")
    events, count = _marked(dam, 2)
    names = [n for n, _ in events]
    assert count == 0 and "walls" not in names
    for k, name in enumerate(names):
        if name == "begin" and k + 1 < len(names):
            assert names[k + 1] == "read"
    assert harness.load_module(harness.metric_path("walls_ms"),
                               "walls_ms").read(
        dict(steps=2, spans=section_ms(events))) is None


def test_reference_takes_the_rocking_and_refuses_other_motion():
    spec = _spec()
    cfg = spec["config"]
    phys_fn, ref_cls = harness.reference_for(cfg)
    assert phys_fn is not physics.physics
    ph = phys_fn(cfg, [-0.02, -0.02, 0.0], [0.22, 0.22, 0.21])
    assert ph.dim == 3 and ph.substeps == 2
    assert ph.wall_center[4] == (0.1, 0.1, 0.0)
    assert ph.clamp == (1, 0.003, False)
    assert ph.rolling[0] == pytest.approx(2.0 * np.pi / 180.0)
    assert ph.rolling[1] == pytest.approx(2.0 * np.pi / 1.646)
    with pytest.raises(ValueError, match="static walls"):
        physics.physics(cfg, [-0.02, -0.02, 0.0], [0.22, 0.22, 0.21])
    spun = json.loads(json.dumps(cfg))
    spun["walls"][4]["omega"] = [0.0, 0.0, 0.5]
    with pytest.raises(ValueError, match=r"walls\[4\]\.omega"):
        phys_fn(spun, [-0.02, -0.02, 0.0], [0.22, 0.22, 0.21])
