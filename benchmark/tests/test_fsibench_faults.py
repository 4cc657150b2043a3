"""A run driven to its end on the CPU with the timed path broken underneath
comes out not correct, once for each fault a cell of this benchmark can
have; the sound path comes out correct.  And a cell, a configuration's
use and a per-layer metric added as files only are found and run.

(One card a cell: no exchange between chips to leave out.)"""

import json
import os
import shutil
import time

import pytest
import torch

from fsibench import harness
from fsibench.program import Program
from test_fsibench_reference import shrink_dam, small_spec


class Unchanged(Program):
    """Every chunk returns the state it was given."""

    def chunk(self, state, steps):
        return self.fresh(state), steps, True


class HalfLeftOut(Program):
    """Every other particle is left where the chunk found it."""

    def chunk(self, state, steps):
        out, done, ok = super().chunk(state, steps)
        keep = torch.arange(out.pos.shape[0]) % 2 == 1
        return out.replace(
            pos=torch.where(keep[:, None], state.pos, out.pos),
            vel=torch.where(keep[:, None], state.vel, out.vel)), done, ok


class AnswerAltered(Program):
    """One fluid particle's position moved by half a spacing where the
    chunk produces it."""

    def chunk(self, state, steps):
        out, done, ok = super().chunk(state, steps)
        pos = out.pos.clone()
        i = int(torch.nonzero(out.prop == 1)[0])
        pos[i, 0] += 0.5 * self.sim.spacing
        return out.replace(pos=pos), done, ok


def _run(spec, make):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return harness.run_cell(spec, 2_300_000_003, 0.0, False, "cpu",
                            time.time(), make_program=make,
                            log=lambda m: None)[0]


@pytest.mark.parametrize("cell", ["dam3d-2m.collapse", "turek-1m.channel"])
@pytest.mark.parametrize("fault", [None, Unchanged, HalfLeftOut,
                                   AnswerAltered])
def test_fault_comes_out_not_correct(cell, fault):
    spec = small_spec(cell)
    r = _run(spec, fault or Program)
    assert r["correct"] is (fault is None), r["checks"]
    assert list(r)[-1] == "checks"


def test_added_cell_and_metric_are_found(tmp_path):
    """A throw-away cell on an existing configuration, with its own traffic
    and a per-layer metric, added as files and entries only."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["workloads"].append(
        {"name": "dam3d-2m.tiny", "config": "dam3d-2m", "traffic": "tiny",
         "chips": 1, "why": "a throw-away cell"})
    manifest["per_layer"].append(
        {"name": "chunk_steps", "unit": "steps", "better": "lower",
         "source": "program_counter", "layer": "step",
         "moves": "particle_steps_per_s", "workloads": ["dam3d-2m.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = json.loads((bench / "workloads" /
                       "dam3d-2m.collapse.json").read_text())
    cell.update(name="dam3d-2m.tiny", traffic="tiny")
    cell["traffic_params"].update(episode_steps=4, chunk_steps=2,
                                  trace_chunks=2)
    (bench / "workloads" / "dam3d-2m.tiny.json").write_text(json.dumps(cell))
    (bench / "metrics" / "chunk_steps.py").write_text(
        "def read(ctx):\n    return ctx['steps']\n")

    spec = harness.cell_spec("dam3d-2m.tiny", root=str(root),
                             bench_dir=str(bench))
    assert [m["name"] for m in spec["per_layer"]] == ["chunk_steps"]
    shrink_dam(spec["config"])
    spec["config"]["numerics"]["pallas_block"] = 32
    r, _ = harness.run_cell(spec, 5, 0.0, True, "cpu", time.time(),
                            log=lambda m: None)
    assert r["correct"]
    assert r["metrics"] == {"chunk_steps": {"value": 4, "unit": "steps"}}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
