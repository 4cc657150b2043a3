"""The port's section spans (``particlemethod_fsi_tpu_torch/utils/trace.py``)
on the CPU: the marks' names and order, the recording of the marked steps,
the profiler's ranges, and that tracing off costs no event, range or
record and tracing on changes no state.

The expected sections of a step are those the port marked before the
entry layer had spans, taken from that tree on these scenes; the guarded
chunk adds ``"probe"`` to each step and ``"guard read"`` after its last,
``refresh_ghosts`` adds ``"ghost upkeep"``."""

import pytest
import torch

from particlemethod_fsi_tpu_torch.config import NumericsConfig
from particlemethod_fsi_tpu_torch.generator import (
    BoidScene, Primitive, generate_grid)
from particlemethod_fsi_tpu_torch.models import cases
from particlemethod_fsi_tpu_torch.solver import Simulation
from particlemethod_fsi_tpu_torch.utils import trace

L0 = 1e-3
GHOST_STEP = ["begin", "read", "ghost rows", "frame", "phase1",
              "ghost fields", "phase2", "integrate"]
PLAIN_STEP = ["begin", "read", "frame", "phase1", "phase2", "integrate"]
# (scene, cached): one step's marks
STEP_MARKS = {
    ("ghosts2d", True): GHOST_STEP,
    ("ghosts2d", False): GHOST_STEP,
    ("planes3d", True): PLAIN_STEP,
    ("planes3d", False): GHOST_STEP,
    ("solid", True): GHOST_STEP + ["solid"],
    ("solid", False): GHOST_STEP + ["solid"],
}
DIAGNOSTICS_MARKS = ["begin", "frame", "phase1", "phase2", "virial",
                     "unsort", "solid and tail"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ghost_layer(nm):
    """A 2-D water layer over a floor, both as wide as the domain: ghost
    rows across the periodic x boundary."""
    grid = generate_grid(BoidScene(
        particle_distance=L0, lower_domain=(0.0, 0.0, 0.0),
        upper_domain=(24 * L0, 16 * L0, L0),
        primitives=[
            Primitive("Cuboid", spacing=L0, type=1, lower=(0, 3 * L0, 0),
                      upper=(24 * L0, 9 * L0, L0)),
            Primitive("Cuboid", spacing=L0, type=4, lower=(0, 0, 0),
                      upper=(24 * L0, 3 * L0, L0))]))
    cfg, _ = cases.dam_break(4, numerics=nm)
    return cfg, grid


def _sim(scene: str, cached: bool) -> Simulation:
    """``pallas_t`` in float64 on the CPU, with the C8 frame cache or
    without: the 2-D ghost layer, the 3-D plane-padded dam, or the dam
    on an elastic gate (a solid, ghost rows)."""
    nm = NumericsConfig(dtype="float64", pallas_block=32,
                        rebuild_margin=0.5 if cached else 0.0)
    build = {"ghosts2d": _ghost_layer,
             "planes3d": lambda nm: cases.dam_break_3d(n_side=4, numerics=nm),
             "solid": lambda nm: cases.dam_break_on_elastic_gate(
                 n_side=6, numerics=nm)}[scene]
    sim = Simulation(*build(nm), device="cpu")
    assert sim._margin_cached == cached
    assert (sim._ghosts is not None) == ("ghost rows" in STEP_MARKS[
        scene, cached])
    assert sim._pad_planes == (scene == "planes3d")
    assert sim.has_structure == (scene == "solid")
    return sim


def _chunk(sim, state, steps):
    """A chunk as the command line runs it: guarded, then the upkeep."""
    state, done, healthy = sim.run_chunk_guarded(state, steps)
    sim.refresh_ghosts(state)
    assert done == steps and healthy
    return state


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "uncached"])
@pytest.mark.parametrize("scene", ["ghosts2d", "planes3d", "solid"])
def test_marks_of_a_step_and_of_the_chunk_edge(scene, cached):
    """Each step's marks are the old ones; the guarded chunk adds the probe
    to each step and the guard read after the last, the upkeep its own;
    an unguarded chunk and a diagnostics call mark as before.  The
    recording holds the guarded chunk's steps and their rebuilds."""
    sim = _sim(scene, cached)
    step = STEP_MARKS[scene, cached]
    sim.profile_events = []
    state = _chunk(sim, sim.state0, 2)
    names = [n for n, _ in sim.profile_events]
    assert names == 2 * (step + ["probe"]) + ["guard read", "ghost upkeep"]
    rec = trace.last_recording()
    assert rec is sim.spans.recording
    assert [(s.chunk, s.step, s.rebuilt) for s in rec.steps] == [
        (0, 0, True), (0, 1, not cached)]
    ms = rec.step_ms()
    assert len(ms) == 2 and all(t > 0 for t in ms)

    sim.profile_events = []
    sim.run_chunk(state, 1)
    assert [n for n, _ in sim.profile_events] == step
    sim.profile_events = None
    assert [(s.chunk, s.step) for s in rec.steps] == [(0, 0), (0, 1), (1, 0)]

    if scene == "ghosts2d":
        sim.profile_events = []
        sim.diagnostics(state)
        assert [n for n, _ in sim.profile_events] == DIAGNOSTICS_MARKS
        sim.profile_events = None
        assert len(trace.last_recording().steps) == 0


def test_recording_under_the_benchmarks_switches():
    """The benchmark's pattern: a list, the marked chunks, the list taken
    and a new one set, then None.  The recording holds exactly the marked
    chunks' steps and stays readable until the next start; a step's time
    runs from its begin to the next one's, the chunk's last to its probe."""
    sim = _sim("solid", True)
    state = _chunk(sim, sim.state0, 2)  # unmarked
    sim.profile_events = []
    rec = trace.last_recording()
    for _ in range(2):
        state = _chunk(sim, state, 3)
    events = sim.profile_events
    sim.profile_events = []
    assert trace.last_recording() is rec  # a list after a list: no start
    sim.profile_events = None
    state = _chunk(sim, state, 2)  # unmarked again
    assert trace.last_recording() is rec
    assert [(s.chunk, s.step) for s in rec.steps] == [
        (c, k) for c in range(2) for k in range(3)]
    assert [n for n, _ in events].count("begin") == 6

    # the times the marks give: each step from its begin, the chunk's last
    # step to its probe
    begins = [ev for n, ev in events if n == "begin"]
    probes = [ev for n, ev in events if n == "probe"]
    want = [begins[i].elapsed_time(begins[i + 1]) for i in (0, 1)]
    want.append(begins[2].elapsed_time(probes[2]))
    want += [begins[i].elapsed_time(begins[i + 1]) for i in (3, 4)]
    want.append(begins[5].elapsed_time(probes[5]))
    assert rec.step_ms() == pytest.approx(want, rel=0, abs=0)

    sim.profile_events = []  # the next start
    assert trace.last_recording() is not rec
    assert trace.last_recording().steps == []
    sim.profile_events = None


def test_recording_under_chip_smokes_switches():
    """``chip_smoke``'s pattern: a list before the last chunk of
    ``run_chunk``, taken and set to None in one statement: the recording
    holds that chunk, each step to its last section."""
    sim = _sim("ghosts2d", True)
    state = sim.run_chunk(sim.state0, 2)
    sim.profile_events = []
    sim.run_chunk(state, 3)
    events, sim.profile_events = sim.profile_events, None
    rec = trace.last_recording()
    assert [(s.chunk, s.step) for s in rec.steps] == [(0, k) for k in range(3)]
    assert rec.steps[-1].end is events[-1][1]  # "integrate"
    assert len(rec.step_ms()) == 3
    ms = {}
    for (_, a), (name, b) in zip(events, events[1:]):
        if name != "begin":
            ms[name] = ms.get(name, 0.0) + a.elapsed_time(b)
    assert set(ms) == set(GHOST_STEP) - {"begin"}


def _tree(evt) -> list:
    names = []
    while evt is not None:
        names.append(evt.name)
        evt = evt.cpu_parent
    return names[::-1]


def test_profiler_ranges_nest_chunk_step_section_op():
    """Under ``torch.profiler`` every span is a host range: ``fsi.chunk`` >
    ``fsi.step`` > ``fsi.<section>`` > the section's aten ops, the solid's
    substeps a range each inside it, the guard read in the chunk, the
    upkeep after it; with the marks off nothing is recorded."""
    from torch.profiler import ProfilerActivity, profile

    sim = _sim("solid", True)
    state = _chunk(sim, sim.state0, 1)
    rec = trace.last_recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _chunk(sim, state, 2)
    assert trace.last_recording() is rec and sim.profile_events is None
    assert not sim.spans._open
    fsi = [e for e in prof.events() if e.name.startswith("fsi.")]
    trees = [_tree(e) for e in fsi]
    step = STEP_MARKS["solid", True][1:] + ["probe"]
    substeps = sim.cfg.substeps
    assert substeps >= 1
    want = [["fsi.chunk"]]
    for _ in range(2):
        want.append(["fsi.chunk", "fsi.step"])
        want += [["fsi.chunk", "fsi.step", "fsi." + n] for n in step]
        want += substeps * [["fsi.chunk", "fsi.step", "fsi.solid",
                             "fsi.solid substep"]]
    want += [["fsi.chunk", "fsi.guard read"], ["fsi.ghost upkeep"]]
    assert sorted(trees) == sorted(want)
    for e in fsi:
        if len(_tree(e)) >= 3:  # a section or a part: torch ops inside
            assert e.cpu_children, e.name
            assert all(c.name.startswith("aten::")
                       or c.name == "fsi.solid substep"
                       for c in e.cpu_children), e.name
    solid = [e for e in fsi if e.name == "fsi.solid"][0]
    assert solid.cpu_parent.cpu_parent.name == "fsi.chunk"


def test_tracing_off_makes_no_event_range_or_record(monkeypatch):
    """Marks off and no profiler: no stamp, no range, no record."""
    made = []

    class Counted:
        def __init__(self, *a, **k):
            made.append(type(self))
            raise AssertionError("made while tracing is off")

    sim = _sim("solid", True)
    sim.profile_events = []
    sim.profile_events = None
    rec = trace.last_recording()
    monkeypatch.setattr(trace, "HostStamp", Counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counted)
    monkeypatch.setattr(torch.cuda, "Event", Counted)
    state = _chunk(sim, sim.state0, 2)
    sim.run_chunk(state, 1)
    sim.step(state)
    sim.diagnostics(state)
    assert not made and not sim.spans._open
    assert trace.last_recording() is rec and rec.steps == []


def test_state_is_bit_equal_with_tracing_on_and_off():
    """A guarded chunk and its upkeep from one state: untraced, with the
    marks on, and under the profiler with the marks on."""
    from torch.profiler import ProfilerActivity, profile

    sim = _sim("solid", True)
    start = _chunk(sim, sim.state0, 1)
    off = _chunk(sim, start, 3)
    sim.profile_events = []
    marked = _chunk(sim, start, 3)
    with profile(activities=[ProfilerActivity.CPU]):
        both = _chunk(sim, start, 3)
    sim.profile_events = None
    for name, want in off._asdict().items():
        for got in (marked, both):
            assert torch.equal(getattr(got, name), want), name
