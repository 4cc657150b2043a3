"""A configuration's plain reference, found by ``harness.reference_for``:
the frozen modules for a configuration that names none, and for one that
names its own (``"reference": "<name>"``, ``references/<name>.py``), that
module on every side that compares: the harness's comparison, the control
and ``readings.py``."""

import filecmp
import functools
import inspect
import json
import os
import re
import shutil
import time

import pytest
import torch

import readings
from fsibench import harness, physics, reference
from fsibench.control import ControlProgram
from test_fsibench_faults import AnswerAltered
from test_fsibench_reference import shrink_dam, small_spec

# a throw-away reference: the frozen one with each call logged beside it,
# its answer moved by SHIFT spacings along every axis
STUB = '''
import json, os

from fsibench import physics as frozen_physics
from fsibench import reference as frozen_reference

SHIFT = {shift!r}
LOG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "{name}.calls")


def _log(**kw):
    with open(LOG, "a") as f:
        f.write(json.dumps(kw) + "\\n")


def physics(cfg, domain_min, domain_max):
    _log(call="physics")
    return frozen_physics.physics(cfg, domain_min, domain_max)


class Reference(frozen_reference.Reference):
    def __init__(self, phys, prop, pos0, device, precision="float32"):
        _log(call="init", precision=precision)
        super().__init__(phys, prop, pos0, device, precision=precision)

    def run(self, pos, vel, time0, steps):
        _log(call="run", steps=steps)
        pos, vel = super().run(pos, vel, time0, steps)
        return pos + SHIFT * self.p.spacing, vel
'''

SEED = 2_500_000_011


def _checkout(root, stubs: dict) -> str:
    """A checkout of the benchmark with, for each ``{name: shift}``, a
    reference ``references/<name>.py``, a configuration ``dam3d-<name>``
    (the dam's file naming that reference) and a cell ``dam3d-<name>.tiny``,
    all added as files and entries."""
    bench = root / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    (bench / "references").mkdir(exist_ok=True)
    cell = json.loads((bench / "workloads" /
                       "dam3d-2m.collapse.json").read_text())
    cfg = json.loads((bench / "configs" / "dam3d-2m.json").read_text())
    for name, shift in stubs.items():
        (bench / "references" / f"{name}.py").write_text(
            STUB.format(shift=shift, name=name))
        config = f"dam3d-{name}"
        (bench / "configs" / f"{config}.json").write_text(
            json.dumps(dict(cfg, name=config, reference=name)))
        manifest["configs"].append(
            {"name": config, "source": "a throw-away configuration",
             "file": f"benchmark/configs/{config}.json", "reduced": [],
             "why": "a throw-away configuration"})
        (bench / "workloads" / f"{config}.tiny.json").write_text(
            json.dumps(dict(cell, name=f"{config}.tiny", config=config,
                            traffic="tiny")))
        manifest["workloads"].append(
            {"name": f"{config}.tiny", "config": config, "traffic": "tiny",
             "chips": 1, "why": "a throw-away cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return str(bench)


def _spec(root, bench, name) -> dict:
    spec = harness.cell_spec(f"dam3d-{name}.tiny", root=str(root),
                             bench_dir=bench)
    shrink_dam(spec["config"])
    spec["config"]["numerics"]["pallas_block"] = 32
    spec["cell"]["traffic_params"].update(episode_steps=4, chunk_steps=2)
    return spec


def _calls(bench, name) -> list:
    path = os.path.join(bench, "references", f"{name}.calls")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        calls = [json.loads(line) for line in f]
    os.remove(path)
    return calls


def _run(spec, make=None):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return harness.run_cell(spec, SEED, 0.0, False, "cpu", time.time(),
                            make_program=make, log=lambda m: None)[0]


def test_a_named_reference_is_what_every_side_compares_against(tmp_path):
    """A configuration added as files, naming a reference of its own: the
    harness compares against that module, the control steps it, a planted
    fault still comes out not correct, ``readings.py`` runs both sides on
    it, and a reference whose answer is moved makes the sound program not
    correct.  No file that was there is edited."""
    root = tmp_path / "checkout"
    bench = _checkout(root, {"counted": 0.0, "shifted": 0.5})
    phys_fn, ref_cls = harness.reference_for(
        _spec(root, bench, "counted")["config"], bench)
    assert ref_cls.__module__ == "fsibench_reference_counted"
    assert issubclass(ref_cls, reference.Reference)
    assert phys_fn is not physics.physics

    spec = _spec(root, bench, "counted")
    r = _run(spec)
    assert r["correct"], r["checks"]
    calls = _calls(bench, "counted")
    # one set-up, the reference in the configuration's type, both chunks
    assert calls == [{"call": "physics"},
                     {"call": "init", "precision": "float32"},
                     {"call": "run", "steps": 2}, {"call": "run", "steps": 2}]

    r = _run(spec, AnswerAltered)
    assert not r["correct"], r["checks"]
    assert sum(c["call"] == "run" for c in _calls(bench, "counted")) == 2

    control = functools.partial(ControlProgram, bench_dir=bench)
    _run(spec, control)
    inits = [c["precision"] for c in _calls(bench, "counted")
             if c["call"] == "init"]
    assert inits == ["bfloat16", "float32"]  # the control's, the check's

    rows = []
    worst = readings.collect(spec, [SEED], [SEED], "cpu", out=rows.append,
                             log=lambda m: None)
    assert [json.loads(row)["side"] for row in rows] == ["program",
                                                         "control"]
    assert worst[("program", "failed_chunks")] == [0, 0]
    inits = [c["precision"] for c in _calls(bench, "counted")
             if c["call"] == "init"]
    assert inits == ["float32", "bfloat16", "float32"]

    r = _run(_spec(root, bench, "shifted"))
    assert not r["correct"]
    assert r["checks"]["pos_gap.start"]["value"] > 0.5
    assert len(_calls(bench, "shifted")) == 4

    cmp = filecmp.dircmp(harness.BENCH_DIR, bench,
                         ignore=["_cache", "__pycache__"])

    def edited(c):
        return c.diff_files + [f for sub in c.subdirs.values()
                               for f in edited(sub)]

    assert edited(cmp) == [] and cmp.left_only == []


@pytest.mark.parametrize("cell", ["dam3d-2m.collapse", "turek-1m.channel"])
def test_shipped_configs_take_the_frozen_reference(cell):
    """Both shipped configurations name no reference: ``reference_for``
    gives the frozen modules, and a chunk through it ends bit for bit where
    the frozen reference called directly ends."""
    spec = small_spec(cell)
    cfg = spec["config"]
    assert "reference" not in cfg
    phys_fn, ref_cls = harness.reference_for(cfg)
    assert phys_fn is physics.physics and ref_cls is reference.Reference
    scene = harness.build_scene(spec)
    ends = []
    for ph_fn, cls in ((phys_fn, ref_cls),
                       (physics.physics, reference.Reference)):
        ph = ph_fn(cfg, scene["domain_min"], scene["domain_max"])
        ref = cls(ph, scene["prop"], scene["pos"], "cpu", precision="float32")
        ends.append(ref.run(torch.as_tensor(scene["pos"]),
                            torch.as_tensor(scene["vel"]), 0.0, 3))
    for a, b in zip(*ends):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["../reference", "a/b", "", 7])
def test_a_reference_name_is_a_name(name):
    with pytest.raises(ValueError, match="not a name"):
        harness.reference_for({"reference": name})


def test_frozen_modules_are_named_only_by_reference_for():
    """The control and ``readings.py`` name neither frozen module, and the
    harness names each only in ``reference_for``: every side that compares
    takes the reference from there."""
    def text(path):
        with open(os.path.join(harness.BENCH_DIR, path)) as f:
            return f.read()

    for path in ("fsibench/control.py", "readings.py"):
        assert not re.search(r"fsibench(\.| import )(physics|reference)\b",
                             text(path)), path
    body = inspect.getsource(harness.reference_for)
    for name in ("frozen_physics.", "frozen_reference."):
        assert text("fsibench/harness.py").count(name) == 1
        assert body.count(name) == 1
