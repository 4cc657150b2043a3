"""The plain reference against the port's CPU path, the control against the
reference, and what the reference and the harness import."""

import copy
import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from fsibench import harness
from fsibench.control import ControlProgram

BENCH, ROOT = harness.BENCH_DIR, harness.ROOT


# a basin the CPU holds at the dam's 1 mm: a 10 x 17 mm column in a 30 mm
# basin with 25 mm walls, 12 mm deep (4,920 particles)
SMALL_DAM = {
    "cuboids_xy": [[1, [0.0, 0.003], [0.01, 0.02]],
                   [4, [0.0, 0.0], [0.03, 0.003]],
                   [4, [0.03, 0.0], [0.033, 0.025]],
                   [4, [-0.003, 0.0], [0.0, 0.025]]],
    "domain_xy": [[-0.01, 0.0], [0.04, 0.05]]}


def shrink_dam(cfg: dict, depth: float = 0.012) -> dict:
    cfg["geometry"] = copy.deepcopy(SMALL_DAM)
    cfg["sizes"]["depth"] = depth
    return cfg


def small_spec(cell: str) -> dict:
    """A cell at a size the CPU holds: the 3-D dam in a small basin
    (:data:`SMALL_DAM`) or the 44,000-particle channel at 5 mm with its
    steps, in short episodes; block 32."""
    spec = copy.deepcopy(harness.cell_spec(cell))
    cfg, mix = spec["config"], spec["cell"]["traffic_params"]
    cfg["numerics"]["pallas_block"] = 32
    if cell.startswith("dam"):
        shrink_dam(cfg)
        mix.update(episode_steps=20, chunk_steps=10)
    else:
        cfg["sizes"]["spacing"] = 5e-3
        cfg["dt"], cfg["elastic_dt"] = 1e-4, 2e-5
        mix.update(episode_steps=40, chunk_steps=20)
    return spec


def port(dtype):
    from fsibench.program import Program

    return lambda cfg, scene, device: Program(cfg, scene, device,
                                              dtype=dtype)


def checks(spec, make, seed=2_200_000_001, precision=None):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    r, readings = harness.run_cell(spec, seed, 0.0, False, "cpu",
                                   time.time(), make_program=make,
                                   precision=precision, log=lambda m: None)
    return r, {f"{key}.{tag}": v for tag, g in readings.items()
               for key, v in g.items()}


@pytest.mark.parametrize("cell", ["dam3d-2m.collapse", "turek-1m.channel"])
def test_reference_is_the_ports_float64_path(cell):
    """The same inputs, float64 on both sides: the port's step (kernels'
    plain versions on the CPU) and the reference agree to round-off over
    both sampled chunks, the flag's substeps, ghosts and inlet included."""
    r, got = checks(small_spec(cell), port("float64"), precision="float64")
    assert r["correct"] and r["failed"] == 0
    assert set(got) == {f"{k}.{t}" for k in ("pos_gap", "pos_gap_q",
                                              "vel_gap", "vel_gap_q")
                        for t in ("start", "later")}
    for key, value in got.items():
        assert value < 1e-9, (key, value)


@pytest.mark.parametrize("cell", ["dam3d-2m.collapse", "turek-1m.channel"])
def test_control_fails_the_cells_limits(cell):
    """The reference a step below float32, in the program's place, reads
    above the cell's limits; the port in float32 reads below them."""
    spec = small_spec(cell)
    limits = spec["cell"]["check"]
    r, got = checks(spec, ControlProgram)
    assert not r["correct"]
    assert any(got[f"{k}.{t}"] > limits[k] for k in limits
               for t in ("start", "later"))
    r, got = checks(spec, port("float32"))
    assert r["correct"], r["checks"]


_BLOCK = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def __init__(self, roots):
            self.roots = roots

        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in self.roots:
                raise ImportError("blocked for this test: " + name)
            return None

    sys.meta_path.insert(0, Block(ROOTS))
    sys.path[:0] = [%r, %r]
""" % (ROOT, BENCH))


def _run(roots, body):
    code = f"ROOTS = {roots!r}\n" + _BLOCK + textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_harness_imports_no_jax():
    """The harness, the program's adapter and the readers import with jax,
    jaxlib, flax and the JAX package unimportable (top-level names compared
    whole: the port's name begins with the JAX package's)."""
    r = _run(("jax", "jaxlib", "flax", "particlemethod_fsi_tpu"), """
        import glob, os, runpy
        from fsibench import harness, program, control, trace, roofline
        import particlemethod_fsi_tpu_torch
        for f in glob.glob(os.path.join(harness.BENCH_DIR, "metrics", "*.py")):
            harness.load_module(f, "m_" + os.path.basename(f)[:-3].replace(".", "_"))
        for f in glob.glob(os.path.join(harness.BENCH_DIR, "scenes", "*.py")):
            harness.load_module(f, "s_" + os.path.basename(f)[:-3])
        sys.argv = ["run.py", "--workload", "dam3d-2m.collapse",
                    "--seed", "1", "--seconds", "1"]
        try:
            runpy.run_path(os.path.join(harness.BENCH_DIR, "run.py"),
                           run_name="__main__")
        except SystemExit as e:
            code = e.code
        assert code == 2, code  # no CUDA device here
        loaded = {m.split(".")[0] for m in sys.modules}
        assert not loaded & {"jax", "jaxlib", "flax", "particlemethod_fsi_tpu"}
        print("ok")
    """)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_reference_imports_nothing_of_the_port():
    """The reference and everything it reads run with the port (and the
    JAX package) unimportable; so does every configuration's own reference
    under ``references/``, each with ``physics`` and ``Reference``."""
    r = _run(("jax", "jaxlib", "flax", "particlemethod_fsi_tpu",
              "particlemethod_fsi_tpu_torch"), """
        import copy, glob, json, os
        from fsibench import harness, physics, pairs, reference, control
        from fsibench import traffic, roofline
        for f in sorted(glob.glob(os.path.join(harness.BENCH_DIR,
                                               "references", "*.py"))):
            name = os.path.basename(f)[:-3]
            phys_fn, ref_cls = harness.reference_for({"reference": name})
            assert callable(phys_fn) and callable(ref_cls.run), name
        spec = copy.deepcopy(harness.cell_spec("dam3d-2m.collapse"))
        spec["config"]["geometry"] = GEOMETRY
        spec["config"]["sizes"]["depth"] = 0.012
        scene = harness.build_scene(spec)
        ph = physics.physics(spec["config"], scene["domain_min"],
                             scene["domain_max"])
        ref = reference.Reference(ph, scene["prop"], scene["pos"], "cpu")
        import torch
        pos, vel = ref.run(torch.as_tensor(scene["pos"]),
                           torch.as_tensor(scene["vel"]), 0.0, 2)
        assert bool(torch.isfinite(pos).all())
        loaded = {m.split(".")[0] for m in sys.modules}
        assert "particlemethod_fsi_tpu_torch" not in loaded
        print("ok")
    """.replace("GEOMETRY", repr(SMALL_DAM)))
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_run_refuses_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files,
    the command exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "dam3d-2m.collapse", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
