"""One run of one cell: set-up, the measured window, the traced readings
and the comparison with the plain reference.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names the
cell, its configuration's file and its metrics; ``workloads/<cell>.json``
holds the traffic parameters and the comparison's limits;
``scenes/<scene>.py`` builds the configuration's particles;
``references/<name>.py`` is the plain reference of a configuration that
names one (:func:`reference_for`); ``metrics/<metric>.py`` reads one
per-layer metric (:func:`metric_path`).  Adding a configuration, a cell or
a metric adds files and entries and edits none.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import random
import re
import time

import torch

from fsibench import physics as frozen_physics
from fsibench import reference as frozen_reference
from fsibench import traffic
from fsibench import trace as trace_lib
from fsibench.pairs import count_pairs, min_image

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# a name of BENCHMARK.json's format: a file under ``references/`` is named so
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def reference_for(cfg: dict, bench_dir: str = BENCH_DIR) -> tuple:
    """The plain reference of configuration ``cfg``: ``(physics,
    Reference)``.  A configuration whose file says ``"reference": "<name>"``
    gets ``references/<name>.py`` under ``bench_dir``, loaded by path, which
    defines both with the frozen modules' interface; any other the frozen
    :func:`fsibench.physics.physics` and :class:`fsibench.reference.Reference`.
    The comparison, the control and ``readings.py`` all take it from here."""
    name = cfg.get("reference")
    if name is None:
        return frozen_physics.physics, frozen_reference.Reference
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"reference {name!r} is not a name")
    mod = load_module(os.path.join(bench_dir, "references", f"{name}.py"),
                      "fsibench_reference_" + re.sub(r"\W", "_", name))
    return mod.physics, mod.Reference


def metric_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``.  A
    quantity split by the end-to-end metric it moves, ``<quantity>.<part>``
    (``step_mfu.device_rate`` beside ``step_mfu``), is read by its own file
    where it has one, else by the quantity's."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    if not os.path.isfile(path) and "." in name:
        path = os.path.join(bench_dir, "metrics",
                            name.rsplit(".", 1)[0] + ".py")
    return path


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR,
              manifest: dict | None = None) -> dict:
    """Everything one cell is made of, found by its name."""
    manifest = manifest or _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in manifest["workloads"]}[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    cfg = _load_json(os.path.join(root, cfg_entry["file"]))
    cell = _load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise ValueError(f"{name}: the cell file names another config or "
                         "traffic than BENCHMARK.json")
    return dict(
        name=name, chips=entry["chips"], config=cfg, cell=cell,
        bench_dir=bench_dir,
        end_to_end=[m for m in manifest["end_to_end"] if _for_cell(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _for_cell(m, name)])


def build_scene(spec: dict) -> dict:
    cfg = spec["config"]
    mod = load_module(os.path.join(spec["bench_dir"], "scenes",
                                   f"{cfg['scene']}.py"),
                      f"fsibench_scene_{cfg['scene']}")
    return mod.build(cfg)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_busy_s(prof) -> float:
    """Seconds in which an activity ran on the card in a finished profile:
    the union of its device activities, as :func:`fsibench.trace.read`
    takes it, but from the profiler's raw events, which give a chunk's
    ~10^5 activities in under a second where its event tree takes several."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    spans = sorted((e.start_ns(), e.end_ns()) for e in events
                   if e.device_type() == cuda and not e.is_user_annotation()
                   and not e.name().startswith("fsibench."))
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy * 1e-9


@contextlib.contextmanager
def _device_traced(on: bool):
    """The card's activity trace (CUPTI alone) over the block, or
    nothing."""
    if not on:
        yield None
        return
    with trace_lib.profiled(True) as prof:
        yield prof


QUANTILE = 0.999


def gaps(start, end, ref, time0: float, steps: int, n: int,
         spacing: float, prop=None, log=None) -> dict:
    """The reference over one chunk from ``start`` (positions, velocities),
    against the program's chunk-end state ``end``, over the scene's
    particles: the widest position gap in spacings (``pos_gap``) and the
    widest velocity gap over the reference's top speed (``vel_gap``), and
    each gap's 99.9th percentile over the particles (``*_q``), which a
    handful of particles cannot move.  ``log`` gets the particle that sets
    each widest gap, with its type and both sides' numbers."""
    pos0, vel0 = start
    rp, rv = ref.run(pos0[:n], vel0[:n], time0, steps)
    pp, pv = (t[:n].to(rp.dtype) for t in (end.pos, end.vel))
    d = ref.p.dim
    dx = min_image(pp[:, :d] - rp[:, :d], ref.width)
    dx = torch.cat([dx, pp[:, d:] - rp[:, d:]], dim=1).norm(dim=1)
    dv = (pv - rv).norm(dim=1)
    top = max(float(rv.norm(dim=1).max()), 1e-30)
    k = max(1, min(n, int(round(QUANTILE * n))))
    out = {}
    for key, g, scale in (("pos_gap", dx, spacing), ("vel_gap", dv, top)):
        g = torch.where(torch.isfinite(g), g, torch.full_like(g, math.inf))
        i = int(torch.argmax(g))
        out[key] = float(g[i]) / scale
        out[key + "_q"] = float(torch.kthvalue(g.cpu(), k).values) / scale
        if log is not None:
            log(f"  {key} {out[key]!r} (99.9th percentile {out[key + '_q']!r})"
                f" at particle {i} (type "
                f"{int(prop[i]) if prop is not None else '?'}): reference "
                f"pos {rp[i].tolist()} vel {rv[i].tolist()}, program pos "
                f"{pp[i].tolist()} vel {pv[i].tolist()}")
    return out


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, make_program=None, precision=None,
             log=print) -> tuple:
    """One run: ``(result, readings)``, the result line's fields with
    ``checks`` last, and every gap of both compared chunks, those without a
    limit too."""
    if make_program is None:
        from fsibench.program import Program as make_program
    device = torch.device(device)
    cfg, cell = spec["config"], spec["cell"]
    mix = cell["traffic_params"]
    steps = mix["chunk_steps"]
    n_chunks = traffic.chunks_per_episode(mix)
    marks = [("imports", time.time())]
    scene = build_scene(spec)
    physics, Reference = reference_for(cfg, spec["bench_dir"])
    phys = physics(cfg, scene["domain_min"], scene["domain_max"])
    pos64, vel64 = traffic.start_state(scene, mix, seed, phys.dim,
                                       phys.domain_width, device)
    marks.append(("scene and start state", time.time()))
    prog = make_program(cfg, scene, device)
    s0 = prog.start(pos64, vel64)
    marks.append(("program set-up", time.time()))
    n = prog.n
    # the later chunk the comparison takes, drawn from the seed
    k_late = random.Random(seed).randrange(1, n_chunks) if n_chunks > 1 else 0
    trace_chunks = min(n_chunks, mix.get("trace_chunks", n_chunks))
    # a cell whose end-to-end rate is the card's runs every chunk of an
    # untraced window under the card's activity trace, and divides its
    # particle-steps by the seconds in which the card was busy.  The trace
    # costs only the host's time, which that rate does not read: its first
    # start (~11 s on an H100's host) and a chunk's ~2x host time and ~3 s
    # of reading fall in the window, and set-up stays the program's own
    trace_busy = not trace and device.type == "cuda" and any(
        m["source"] == "device_trace" for m in spec["end_to_end"])

    # warm-up: one chunk of the cell's own shapes, from a fresh copy
    prog.chunk(prog.fresh(s0), steps)
    _sync(device)
    marks.append(("warm chunk", time.time()))
    setup_s = time.time() - t_start
    log(f"{spec['name']}: set-up (s) " + ", ".join(
        f"{name} {t - t_prev:.3f}" for (name, t), (_, t_prev)
        in zip(marks, [("start", t_start)] + marks)))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    held, chunk_ms = {}, []
    tracer = _Tracer(prog, device, trace_chunks, steps, n) if trace else None
    chunks = steps_done = failed = episode = 0
    busy_s = 0.0
    plain = [0.0, 0]  # host seconds and steps of the chunks nothing traced
    t0 = time.perf_counter()
    stop = False
    while not stop:
        state = prog.fresh(s0)
        for k in range(n_chunks):
            if tracer:
                tracer.before(episode, k, state)
            start = ((pos64, vel64) if (episode, k) == (0, 0)
                     else (state.pos, state.vel))
            t_chunk = time.perf_counter()
            with _device_traced(trace_busy) as prof:
                with torch.profiler.record_function("fsibench.chunk"):
                    state, done, ok = prog.chunk(state, steps)
                if prof is not None:
                    _sync(device)
            t_chunk = time.perf_counter() - t_chunk
            if prof is not None:
                busy_s += device_busy_s(prof)
            chunk_ms.append(t_chunk * 1e3 / steps)
            if tracer:
                tracer.after(episode, k, t_chunk, done)
            if tracer is None or tracer.untraced(episode, k):
                plain[0] += t_chunk
                plain[1] += done
            chunks += 1
            steps_done += done
            if (episode, k) == (0, 0):
                held["start"] = (start, state, 0)
            if k == k_late:
                held["later"] = (start, state, k)
            if not ok:
                failed += 1
            elapsed = time.perf_counter() - t0
            stop = elapsed >= seconds and (failed > 0 or (
                "later" in held and (tracer is None or tracer.done)))
            if stop or not ok:
                break
        episode += 1
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if tracer:
        tracer.close()
        if not failed:
            tracer.name_gaps(state)
    result = dict(correct=False, attempted=chunks, failed=failed)
    rate = n * steps_done / window_s
    device_rate = n * steps_done / busy_s if busy_s > 0 else None
    log(f"{spec['name']}: seed {seed}, {n} particles, set-up {setup_s:.3f} s, "
        f"window {window_s:.3f} s, {chunks} chunks ({episode} episodes "
        f"begun), {steps_done} steps, {rate:.6g} particle-steps/s, "
        + (f"card busy {busy_s:.6g} s, {device_rate:.6g} particle-steps a "
           "busy second, " if device_rate else "") +
        f"rebuilds {prog.rebuilds}, peak device memory {peak} bytes; "
        f"ms/step by chunk (host clock) {[round(m, 3) for m in chunk_ms]}; "
        + prog.describe(state))

    metrics, extra = {}, {}
    if trace and not failed:
        metrics, extra = _per_layer(spec, prog, tracer, phys, n, plain, log)
        tracer = None
    elif not trace:
        # the card's rate reads nothing without a card
        e2e = {"particle_steps_per_s": rate, "setup_s": setup_s,
               "device_particle_steps_per_s": device_rate}
        for m in spec["end_to_end"]:
            if e2e[m["name"]] is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    # the program's state is freed before the reference runs
    del prog, state, s0, tracer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = Reference(phys, scene["prop"], scene["pos"], device,
                    precision=precision or cfg["numerics"]["dtype"])
    limits = cell["check"]
    checks = {"failed_chunks": {"value": failed, "limit": 0}}
    readings = {}
    correct = failed == 0
    t_ref = time.perf_counter()
    for tag in ("start", "later"):
        start, end, k = held[tag]
        log(f"{spec['name']}: chunk {k} ({tag}) against the reference")
        g = gaps(start, end, ref, k * steps * phys.dt, steps, n,
                 phys.spacing, scene["prop"], log)
        readings[tag] = g
        for key, limit in limits.items():
            checks[f"{key}.{tag}"] = {"value": g[key], "limit": limit}
            correct = correct and g[key] <= limit
    log(f"{spec['name']}: reference over 2 chunks of {steps} steps in "
        f"{time.perf_counter() - t_ref:.3f} s ({ref.rebuilds} neighbour "
        f"list builds)")
    result.update(correct=bool(correct), metrics=metrics)
    result["device"] = dict(
        platform="gpu" if device.type == "cuda" else device.type,
        kind=(torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"),
        count=1, memory_peak_bytes=int(peak), **extra.get("device", {}))
    if "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    result["checks"] = checks
    return result, readings



# steps of the short chunk, after the window, that runs under a trace of
# the host's ops as well, to name the idle gaps
NAMING_STEPS = 20


class _Tracer:
    """The traced run's readings.  Each comes from chunks of its own, all of
    the first ``chunks`` chunks of an episode, so that each covers the same
    work, in this order:

    - ``clean``, episode 0: nothing on: the step time that the step's share
      of the peak and the idle share divide by.
    - ``marked``, episode 1: the program's section marks (CUDA events at
      the step's section ends) on, no profiler: the spans.
    - ``profiled``, episode 2: under the card's activity trace (CUPTI)
      alone: kernel times, busy time, rebuilds, and each chunk's start state
      for the pair count.  The trace adds host time to every launch, so
      these chunks run slower than the others; the profiler comes last, as
      it may leave some of that cost behind in the process.

    Each phase's host time a step is logged beside the clean one: what the
    marks and the trace cost.  After the window, a short chunk runs under a
    trace of the host's ops too, which only names what the host did while
    the card was idle (a full chunk of such a trace takes minutes to
    read)."""

    PHASES = ("clean", "marked", "profiled")

    def __init__(self, prog, device, chunks: int, steps: int, n: int):
        self.prog, self.device, self.chunks, self.n = prog, device, chunks, n
        self.steps = chunks * steps
        self.starts, self.events = [], []
        self.timed = {}  # phase: [host seconds, steps]
        self.prof = self.naming = self._cm = None
        self.cuda = device.type == "cuda"

    def _phase(self, episode: int, k: int):
        if k >= self.chunks or episode >= len(self.PHASES):
            return None
        return self.PHASES[episode]

    def _open(self, device_only: bool):
        self._cm = trace_lib.profiled(device_only and self.cuda)
        return self._cm.__enter__()

    def _close(self):
        self._cm.__exit__(None, None, None)
        self._cm = None

    def before(self, episode: int, k: int, state):
        phase = self._phase(episode, k)
        if phase == "profiled":
            if k == 0:
                _sync(self.device)
                self._rebuilds0 = self.prog.rebuilds
                self._prof = self._open(True)
                self._t0 = time.perf_counter()
            self.starts.append(state.pos[:self.n].clone())
        elif phase == "marked" and k == 0 and self.cuda:
            self.prog.spans_on(True)

    def after(self, episode: int, k: int, seconds: float, steps: int):
        phase = self._phase(episode, k)
        if phase is None:
            return
        t = self.timed.setdefault(phase, [0.0, 0])
        t[0] += seconds
        t[1] += steps
        if k < self.chunks - 1:
            return
        if phase == "profiled":
            _sync(self.device)
            self.window_s = time.perf_counter() - self._t0
            self._close()
            self.rebuilds = self.prog.rebuilds - self._rebuilds0
            self.prof = self._prof
        elif phase == "marked" and self.cuda:
            self.events = self.prog.take_spans()
            self.prog.spans_on(False)

    def untraced(self, episode: int, k: int) -> bool:
        """Whether chunk ``k`` of ``episode`` ran with nothing on."""
        return self._phase(episode, k) in (None, "clean")

    @property
    def done(self) -> bool:
        return self.prof is not None

    def step_s(self, phase: str) -> float:
        seconds, steps = self.timed[phase]
        return seconds / steps

    def name_gaps(self, state):
        prof = self._open(False)
        self.prog.chunk(state, NAMING_STEPS)
        _sync(self.device)
        self._close()
        self.naming = trace_lib.read(prof)

    def close(self):
        if self._cm is not None:
            self._close()


def _per_layer(spec, prog, tracer, phys, n, plain, log):
    """The traced window's readings, then each per-layer metric's reader."""
    from fsibench.program import section_ms

    got = trace_lib.read(tracer.prof)
    pairs = [count_pairs(p[:, :phys.dim].double(), phys.domain_min,
                         phys.domain_width, phys.radius)
             for p in tracer.starts]
    ctx = dict(
        steps=tracer.steps, rebuilds=tracer.rebuilds,
        window_s=tracer.window_s, busy_s=got["busy_s"],
        step_s=tracer.step_s("clean"),
        kernels=got["kernels"], spans=section_ms(tracer.events),
        pairs=sum(pairs) / len(pairs), particles=n,
        three_d=phys.dim == 3, ghost_rows=prog.ghost_rows,
        plain_s=plain[0], plain_steps=plain[1])
    clean = ctx["step_s"]
    log(f"{spec['name']}: traced {tracer.steps} steps in "
        f"{tracer.window_s:.3f} s, busy {got['busy_s']:.4f} s in "
        f"{got['device_events']} device activities, pairs in range per "
        f"particle {ctx['pairs'] / n:.3f}, sections (ms, summed) "
        + json.dumps({k: round(v, 3) for k, v in ctx["spans"].items()}))
    log(f"{spec['name']}: host ms/step of the first {tracer.chunks} chunks "
        "of an episode: " + ", ".join(
            f"{phase} {1e3 * tracer.step_s(phase):.4f} "
            f"({tracer.step_s(phase) / clean:.4f} of clean, "
            f"{tracer.timed[phase][1]} steps)"
            for phase in _Tracer.PHASES))
    metrics = {}
    for m in spec["per_layer"]:
        mod = load_module(metric_path(m["name"], spec["bench_dir"]),
                          "fsibench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    extra = {
        "device": {"busy_s": got["busy_s"], "window_s": tracer.window_s},
        "breakdown": {"device_ops": trace_lib.top(got["kernels"]),
                      "idle_gaps": trace_lib.top(tracer.naming["gaps"])
                      if tracer.naming else []},
    }
    return metrics, extra
