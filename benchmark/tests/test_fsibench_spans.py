"""The entry layer's readers (``probe_ms``, ``upkeep_ms``, ``step_p95_ms``)
on a hand-made context and on a CPU recording of short chunks of the small
dam, marked as the traced run marks them; each reads nothing where nothing
was recorded."""

import math
import os

import pytest
import torch

from fsibench import harness, physics, traffic
from fsibench.program import Program, section_ms
from test_fsibench_reference import small_spec

NAMES = ("probe_ms", "upkeep_ms", "step_p95_ms")


def readers() -> dict:
    return {n: harness.load_module(
        os.path.join(harness.BENCH_DIR, "metrics", f"{n}.py"),
        f"fsibench_metric_{n}") for n in NAMES}


def test_readers_on_a_hand_made_context():
    r = readers()
    ctx = dict(steps=400, spans={"read": 600.0, "probe": 40.0,
                                 "guard read": 3.0, "ghost upkeep": 9.0})
    assert r["probe_ms"].read(ctx) == pytest.approx(0.1)
    assert r["upkeep_ms"].read(ctx) == pytest.approx(0.03)
    ctx["spans"] = {"ghost upkeep": 8.0}
    assert r["upkeep_ms"].read(ctx) == pytest.approx(0.02)
    assert r["probe_ms"].read(ctx) is None
    ctx["spans"] = {"read": 600.0, "frame": 100.0}  # marks of an older port
    assert r["probe_ms"].read(ctx) is None
    assert r["upkeep_ms"].read(ctx) is None
    ctx["spans"] = {}  # nothing marked
    for n in NAMES:
        assert r[n].read(ctx) is None, n


def test_readers_on_a_cpu_recording_of_the_small_dam():
    """Two guarded chunks of three steps, each with its upkeep, marked as
    the traced run's marked phase is (on, taken, off): the probe and the
    chunk edge as the marks sum them, the tail as the nearest rank of
    the recorded steps; off again, a later run of the readers with
    nothing marked reads nothing."""
    torch.set_num_threads(min(4, torch.get_num_threads()))
    spec = small_spec("dam3d-2m.collapse")
    cfg, mix = spec["config"], spec["cell"]["traffic_params"]
    scene = harness.build_scene(spec)
    phys = physics.physics(cfg, scene["domain_min"], scene["domain_max"])
    pos, vel = traffic.start_state(scene, mix, 2_200_000_003, phys.dim,
                                   phys.domain_width, "cpu")
    prog = Program(cfg, scene, "cpu")
    state = prog.chunk(prog.start(pos, vel), 2)[0]  # unmarked
    prog.spans_on(True)
    for _ in range(2):
        state, done, ok = prog.chunk(state, 3)
        assert done == 3 and ok
    events = prog.take_spans()
    prog.spans_on(False)
    prog.chunk(state, 2)  # unmarked

    spans = section_ms(events)
    ctx = dict(steps=6, spans=spans)
    r = readers()
    assert r["probe_ms"].read(ctx) == pytest.approx(spans["probe"] / 6)
    assert r["upkeep_ms"].read(ctx) == pytest.approx(
        (spans["guard read"] + spans["ghost upkeep"]) / 6)
    from particlemethod_fsi_tpu_torch.utils.trace import last_recording
    ms = sorted(last_recording().step_ms())
    assert len(ms) == 6 and all(math.isfinite(t) and t > 0 for t in ms)
    assert r["step_p95_ms"].read(ctx) == ms[5]
    # the steps' times cover the marked sections but the upkeep
    steps_ms = sum(ms)
    inside = sum(v for k, v in spans.items()
                 if k not in ("guard read", "ghost upkeep"))
    assert steps_ms == pytest.approx(inside, rel=0.05)
    assert r["step_p95_ms"].read(dict(steps=6, spans={})) is None
