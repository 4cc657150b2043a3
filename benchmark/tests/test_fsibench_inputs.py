"""The benchmark's inputs: the scenes equal the port's own builders and the
dam's geometry the shipped Dam case's, the configuration files give the
port's case configurations, the physics constants match a hand
computation, a seed gives the same inputs and another seed other ones, and
the roofline and pair count on hand-counted frames."""

import copy
import dataclasses
import itertools
import os

import numpy as np
import pytest
import torch

from fsibench import harness, physics, roofline, traffic
from fsibench.pairs import build_pairs, count_pairs
from test_fsibench_reference import shrink_dam


def _spec(cell):
    return copy.deepcopy(harness.cell_spec(cell))


@pytest.mark.parametrize("depth", [0.012, 0.02])
def test_dam3d_scene_is_the_ports_generator(depth):
    """The scene builder gives the port's generator's particles on the same
    primitives (a small basin)."""
    from particlemethod_fsi_tpu_torch.generator import (BoidScene, Primitive,
                                                        generate_grid)
    from test_fsibench_reference import shrink_dam

    spec = _spec("dam3d-2m.collapse")
    cfg = shrink_dam(spec["config"], depth)
    scene = harness.build_scene(spec)
    mod = harness.load_module(os.path.join(harness.BENCH_DIR, "scenes",
                                           "dam3d.py"), "dam3d_scene")
    boxes, dmin, dmax = mod.primitives(cfg)
    l0 = cfg["sizes"]["spacing"]
    grid = generate_grid(BoidScene(
        particle_distance=l0, lower_domain=tuple(dmin),
        upper_domain=tuple(dmax),
        primitives=[Primitive("Cuboid", spacing=l0, type=k, lower=lo,
                              upper=hi) for k, lo, hi in boxes]))
    assert grid.n > 1000
    for mine, theirs in ((scene["prop"], grid.prop),
                         (scene["pos"], grid.position),
                         (scene["vel"], grid.velocity),
                         (scene["domain_min"], grid.domain_min),
                         (scene["domain_max"], grid.domain_max)):
        assert np.array_equal(mine, theirs)


def test_dam3d_geometry_is_the_dam_case():
    """The configuration's cuboids and domain in x and y are the shipped
    Dam case's (``cases/dam/dam.boid``: 4,850 water and 1,800 wall
    particles a layer at 1 mm), its walls stand above the water, and in
    the Dam case every cuboid spans the domain's z range, so that the
    extrusion over the depth is the Dam case's basin made deeper."""
    from particlemethod_fsi_tpu_torch.generator import parse_boid_file

    cfg = _spec("dam3d-2m.collapse")["config"]
    boid = parse_boid_file(os.path.join(harness.ROOT, "cases", "dam",
                                        "dam.boid"))
    geo = cfg["geometry"]
    assert boid.particle_distance == cfg["sizes"]["spacing"]
    assert [[p.type, list(p.lower[:2]), list(p.upper[:2])]
            for p in boid.primitives] == geo["cuboids_xy"]
    assert [list(boid.lower_domain[:2]),
            list(boid.upper_domain[:2])] == geo["domain_xy"]
    for p in boid.primitives:
        assert (p.lower[2], p.upper[2]) == (boid.lower_domain[2],
                                            boid.upper_domain[2])
    water = max(hi[1] for k, _, hi in geo["cuboids_xy"] if k == 1)
    assert min(hi[1] for k, _, hi in geo["cuboids_xy"]
               if k == 4 and hi[1] > 0.01) > water
    spec = _spec("dam3d-2m.collapse")
    scene = harness.build_scene(spec)
    layers = round(cfg["sizes"]["depth"] / cfg["sizes"]["spacing"])
    counts = np.bincount(scene["prop"], minlength=5)
    assert counts[1] == 4850 * layers and counts[4] == 1800 * layers
    assert scene["domain_max"][2] - scene["domain_min"][2] == \
        cfg["sizes"]["depth"]


def test_turek_scene_is_the_ports():
    from particlemethod_fsi_tpu_torch.models import turek_grid

    spec = _spec("turek-1m.channel")
    spec["config"]["sizes"]["spacing"] = 5e-3
    scene = harness.build_scene(spec)
    grid = turek_grid(5e-3)
    assert grid.n == 44000
    for mine, theirs in ((scene["prop"], grid.prop),
                         (scene["pos"], grid.position),
                         (scene["vel"], grid.velocity),
                         (scene["domain_min"], grid.domain_min),
                         (scene["domain_max"], grid.domain_max)):
        assert np.array_equal(mine, theirs)


def test_full_size_scenes_have_the_stated_counts():
    for cell in ("dam3d-2m.collapse", "turek-1m.channel"):
        spec = _spec(cell)
        scene = harness.build_scene(spec)
        assert scene["prop"].shape[0] == spec["config"]["particles"]
    spec = _spec("turek-1m.channel")
    assert int((harness.build_scene(spec)["prop"] == 2).sum()) == 8000


def _physics_fields(cfg):
    d = dataclasses.asdict(cfg)
    for k in ("output_interval", "vtk_output_interval", "end_time",
              "numerics"):
        d.pop(k)
    return d


def test_config_files_give_the_ports_case_configs():
    from particlemethod_fsi_tpu_torch.config import NumericsConfig
    from particlemethod_fsi_tpu_torch.models import dam_break_3d, turek_config
    from fsibench.program import case_config

    mine = case_config(_spec("dam3d-2m.collapse")["config"])
    theirs, _ = dam_break_3d(4, numerics=NumericsConfig(rebuild_margin=0.5))
    assert _physics_fields(mine) == _physics_fields(theirs)
    assert mine.numerics.rebuild_margin == 0.5
    mine = case_config(_spec("turek-1m.channel")["config"])
    theirs = turek_config(1e-3)
    assert _physics_fields(mine) == _physics_fields(theirs)
    assert mine.numerics.rebuild_margin == theirs.numerics.rebuild_margin
    for cfg in (mine,):
        assert cfg.numerics.dtype == "float32"
        assert cfg.numerics.backend == "pallas_t"
        assert cfg.numerics.pallas_block == 64


def test_physics_constants_are_the_ports():
    from particlemethod_fsi_tpu_torch.ops.smoothing import build_kernels
    from particlemethod_fsi_tpu_torch.solver import adjust_domain

    for cell in ("dam3d-2m.collapse", "turek-1m.channel"):
        spec = _spec(cell)
        cfg = spec["config"]
        scene = harness.build_scene(spec)
        ph = physics.physics(cfg, scene["domain_min"], scene["domain_max"])
        ks = build_kernels(
            spacing=cfg["sizes"]["spacing"], radius_ratio_a=2.5,
            radius_ratio_p=2.5, radius_ratio_v=2.5,
            surface_tension=tuple(cfg["surface_tension"]),
            two_dimensional=cfg["two_dimensional"])
        assert ph.n0p == pytest.approx(ks.n0p, rel=1e-14)
        assert ph.radius == ks.radius_p
        assert ph.wnorm == pytest.approx(1 / ks.swp / ks.radius_p
                                         ** ph.dim, rel=1e-14)
        assert ph.structure_reach == pytest.approx(ks.support_radius)
        dmin, dmax = adjust_domain(scene["domain_min"], scene["domain_max"],
                                   cfg["sizes"]["spacing"],
                                   cfg["two_dimensional"])
        assert ph.domain_width == tuple(dmax - dmin)


# the sites of the square and cubic lattices within 2.5 spacings of one
# site, counted by hand: {squared distance in spacings: sites}
SHELLS = {2: {1: 4, 2: 4, 4: 4, 5: 8},
          3: {1: 6, 2: 12, 3: 8, 4: 6, 5: 24, 6: 24}}


@pytest.mark.parametrize("dim", [2, 3])
def test_physics_constants_by_hand(dim):
    """Swp's closed form against the integral by quadrature, and N0p
    against the lattice shells within 2.5 spacings summed by hand, for the
    spacing both configurations run at."""
    l0, radius = 1e-3, 2.5e-3
    # midpoint rule in the radial coordinate
    s = (np.arange(200000) + 0.5) / 200000
    sphere = 2 * np.pi if dim == 2 else 4 * np.pi
    quad = sphere * np.sum((1 - s) ** 2 * s ** (dim - 1)) / 200000
    assert physics.kernel_integral(dim) == pytest.approx(quad, rel=1e-9)
    assert physics.kernel_integral(dim) == pytest.approx(
        np.pi / 6 if dim == 2 else 2 * np.pi / 15, rel=1e-15)
    wnorm = 1.0 / (physics.kernel_integral(dim) / l0 ** dim) / radius ** dim
    hand = wnorm * sum(n * (1 - np.sqrt(d2) / 2.5) ** 2
                       for d2, n in SHELLS[dim].items())
    assert physics.lattice_number_density(radius, l0, dim, wnorm) == \
        pytest.approx(hand, rel=1e-13)
    if dim == 2:
        # the 2-D Dam case's N0p, as its solver logs it
        assert hand == pytest.approx(7.467341e-01, abs=5e-8)
    spec = _spec("dam3d-2m.collapse" if dim == 3 else "turek-1m.channel")
    scene = harness.build_scene(spec)
    ph = physics.physics(spec["config"], scene["domain_min"],
                         scene["domain_max"])
    assert ph.wnorm == pytest.approx(wnorm, rel=1e-15)
    assert ph.n0p == pytest.approx(hand, rel=1e-13)


def test_adjust_domain_by_hand():
    """The upper corner moves to the whole number of spacings nearest the
    width; z is left alone in 2-D."""
    dmin, dmax = physics.adjust_domain((0.0, -0.5, 0.0), (0.2204, 0.2996,
                                                          0.0017), 0.001, 2)
    assert list(dmin) == [0.0, -0.5, 0.0]
    assert dmax[0] == 220 * 0.001 and dmax[1] == -0.5 + 800 * 0.001
    assert dmax[2] == 0.0017
    _, dmax = physics.adjust_domain((0.0,) * 3, (0.0004, 2.0, 0.0026), 0.001, 3)
    assert dmax[0] == 0.001 and dmax[1] == 2.0 and dmax[2] == 3 * 0.001


def _start(cell, seed):
    spec = _spec(cell)
    if cell.startswith("dam"):
        shrink_dam(spec["config"])
    else:
        spec["config"]["sizes"]["spacing"] = 5e-3
    scene = harness.build_scene(spec)
    ph = physics.physics(spec["config"], scene["domain_min"],
                         scene["domain_max"])
    return scene, traffic.start_state(scene, spec["cell"]["traffic_params"],
                                      seed, ph.dim, ph.domain_width, "cpu")


@pytest.mark.parametrize("cell", ["dam3d-2m.collapse", "turek-1m.channel"])
def test_seed_gives_the_same_inputs_and_another_other_ones(cell):
    scene, (pos, vel) = _start(cell, 3_000_000_017)
    _, (pos2, vel2) = _start(cell, 3_000_000_017)
    _, (pos3, vel3) = _start(cell, 3_000_000_018)
    assert torch.equal(pos, pos2) and torch.equal(vel, vel2)
    assert torch.equal(pos, pos3) and not torch.equal(vel, vel3)
    # a small perturbation of the fluid only, none in z in 2-D
    base = torch.as_tensor(scene["vel"])
    dv = (vel - base).norm(dim=1)
    fluid = torch.as_tensor(scene["prop"] < 2)
    assert float(dv[~fluid].max()) == 0.0
    assert float(dv.max()) == pytest.approx(0.01, rel=1e-12)
    if cell.startswith("turek"):
        assert float(vel[:, 2].abs().max()) == 0.0


def test_perturbation_is_divergence_free():
    """Each mode runs across its wave: the field's divergence, by central
    differences on a fine lattice, is round-off."""
    x = torch.linspace(0.0, 1.0, 41, dtype=torch.float64)
    g = torch.stack(torch.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    h = 1e-6
    div = torch.zeros(g.shape[0], dtype=torch.float64)
    for d in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[d] = h
        vp = traffic.modes_field(5, g + e, (1.0, 1.0, 1.0), 3, 4, 3)
        vm = traffic.modes_field(5, g - e, (1.0, 1.0, 1.0), 3, 4, 3)
        div += (vp[:, d] - vm[:, d]) / (2 * h)
    assert float(div.abs().max()) < 1e-6
    field = traffic.modes_field(5, g, (1.0, 1.0, 1.0), 3, 4, 3)
    assert float(field.norm(dim=1).max()) > 0.5


def test_roofline_on_a_hand_counted_frame():
    """Four particles on a line 1 apart, radius 1.5: pairs (0,1), (1,2),
    (2,3) in range, six ordered; 2-D counts."""
    pos = torch.tensor([[1.0, 5.0], [2.0, 5.0], [3.0, 5.0], [4.0, 5.0]],
                       dtype=torch.float64)
    assert count_pairs(pos, (0.0, 0.0), (10.0, 10.0), 1.5) == 6
    t = roofline.least_seconds("phase1_sweep", 6, 4, False)
    assert t == max(6 * 20 / 67e12, 4 * 28 / 3.35e12)
    t = roofline.least_seconds("phase2_sweep", 1e9, 10, True)
    assert t == pytest.approx(1e9 * 43 / 67e12)
    assert roofline.BYTES_PER_PARTICLE["phase2_sweep"] == (40, 52)


@pytest.mark.parametrize("dim,width", [(2, (1.0, 0.8)), (3, (1.0, 0.8, 0.6)),
                                       (3, (1.0, 0.4, 0.25))])
def test_pairs_against_all_pairs(dim, width):
    """The cell list's pairs are all pairs of a random periodic cloud
    closer than the cut-off, each once, across the boundary too, also
    where an axis is too narrow for three cells."""
    gen = torch.Generator().manual_seed(dim)
    pos = torch.rand((300, dim), generator=gen, dtype=torch.float64) \
        * torch.tensor(width, dtype=torch.float64) - 0.1
    a, b = build_pairs(pos, (-0.1,) * dim, width, 0.15, block=64)
    got = {(min(i, j), max(i, j)) for i, j in zip(a.tolist(), b.tolist())}
    assert len(got) == a.shape[0]
    w = torch.tensor(width, dtype=torch.float64)
    want = set()
    for i, j in itertools.combinations(range(300), 2):
        d = pos[j] - pos[i]
        d = d - w * torch.round(d / w)
        if float((d * d).sum()) < 0.15 ** 2:
            want.add((i, j))
    assert got == want
