"""The card's rate of a host-paced cell: the busy seconds read from a
profile's raw events, a split per-layer metric read by its quantity's
reader, and the host's rate over a traced run's untraced chunks."""

import json
import os
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from fsibench import harness
from test_fsibench_reference import shrink_dam

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Raw:
    """A raw profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, start, end, device=CUDA, name="kernel",
                 annotation=False):
        self._s, self._e, self._d = start, end, device
        self._n, self._a = name, annotation

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def name(self):
        return self._n

    def is_user_annotation(self):
        return self._a


def raw_profile(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_busy_is_the_union_of_the_card_activities():
    """Overlapping and nested activities count once; host events, the
    benchmark's own ranges and user annotations not at all."""
    events = [Raw(100, 200), Raw(150, 250), Raw(160, 170), Raw(400, 450),
              Raw(450, 500), Raw(0, 1000, CPU),
              Raw(0, 1000, name="fsibench.chunk"),
              Raw(0, 1000, name="fsi.read", annotation=True),
              Raw(900, 960)]
    assert harness.device_busy_s(raw_profile(events)) == pytest.approx(
        (150 + 100 + 60) * 1e-9, rel=1e-12)
    assert harness.device_busy_s(raw_profile([])) == 0.0


def test_a_split_metric_is_read_by_its_quantitys_reader(tmp_path):
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    for name in ("step_mfu", "read_ms", "read_ms.device_rate"):
        (metrics / f"{name}.py").write_text("def read(ctx):\n    return 1\n")
    path = lambda name: harness.metric_path(name, str(tmp_path))
    assert path("step_mfu.device_rate") == str(metrics / "step_mfu.py")
    assert path("read_ms.device_rate") == str(metrics / "read_ms.device_rate.py")
    assert path("read_ms") == str(metrics / "read_ms.py")
    assert path("idle_pct") == str(metrics / "idle_pct.py")  # not there
    shipped = harness.metric_path("host_particle_steps_per_s")
    assert os.path.basename(shipped) == "host_particle_steps_per_s.py"


def test_host_rate_reader_on_a_hand_made_context():
    mod = harness.load_module(
        harness.metric_path("host_particle_steps_per_s"), "host_rate")
    assert mod.read(dict(particles=1000, plain_steps=600,
                         plain_s=2.0)) == pytest.approx(3e5)
    assert mod.read(dict(particles=1000, plain_steps=0, plain_s=0.0)) is None


def test_a_device_rate_cell_on_the_cpu(tmp_path):
    """A throw-away cell whose end-to-end rate is the card's, added as
    files and entries: untraced on the CPU it reports the set-up alone
    (the card's rate reads nothing without a card); traced, the host's rate
    of the chunks nothing traced (episode 0 of three), and a split metric
    read by its quantity's reader."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cell_name = "dam3d-2m.tiny"
    manifest["workloads"].append(
        {"name": cell_name, "config": "dam3d-2m", "traffic": "tiny",
         "chips": 1, "why": "a throw-away cell"})
    for m in manifest["end_to_end"]:
        if m["name"] == "device_particle_steps_per_s":
            m["workloads"].append(cell_name)
    for name in ("host_particle_steps_per_s", "plain_steps",
                 "plain_steps.device_rate"):
        manifest["per_layer"].append(
            {"name": name, "unit": "steps", "better": "higher",
             "source": "host_clock", "layer": "entry",
             "moves": "device_particle_steps_per_s",
             "workloads": [cell_name]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = json.loads((bench / "workloads" /
                       "dam3d-2m.collapse.json").read_text())
    cell.update(name=cell_name, traffic="tiny")
    cell["traffic_params"].update(episode_steps=4, chunk_steps=2,
                                  trace_chunks=2)
    (bench / "workloads" / f"{cell_name}.json").write_text(json.dumps(cell))
    (bench / "metrics" / "plain_steps.py").write_text(
        "def read(ctx):\n    return ctx['plain_steps']\n")

    spec = harness.cell_spec(cell_name, root=str(root), bench_dir=str(bench))
    assert [m["name"] for m in spec["end_to_end"]] == [
        "device_particle_steps_per_s", "setup_s"]
    shrink_dam(spec["config"])
    spec["config"]["numerics"]["pallas_block"] = 32
    torch.set_num_threads(min(4, torch.get_num_threads()))
    run = lambda trace: harness.run_cell(spec, 7, 0.0, trace, "cpu",
                                         time.time(), log=lambda m: None)[0]
    r = run(False)
    assert r["correct"] and set(r["metrics"]) == {"setup_s"}
    r = run(True)
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert got["plain_steps"] == got["plain_steps.device_rate"] == 4
    assert got["host_particle_steps_per_s"] > 0
