"""BENCHMARK.json against the rules of its format (names, units, keys,
bounds, sizes), and every file a cell is made of found by its name."""

import json
import math
import os
import re

import pytest

from fsibench import harness

ROOT, BENCH = harness.ROOT, harness.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    # 24 cells, 14 runs each at this length, fit a 12-hour check
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_have_just_their_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_units_and_text(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    for group in ("configs", "workloads"):
        got = [e["name"] for e in manifest[group]]
        assert len(got) == len(set(got))
    metrics = [e["name"] for g in ("end_to_end", "per_layer")
               for e in manifest[g]]
    assert len(metrics) == len(set(metrics))
    for c in manifest["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["reduced"] == [] or all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] == 1
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in manifest["per_layer"]:
        assert TEXT.match(m["layer"])


def test_bounds_and_sources(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    for cell in cells:
        spec = harness.cell_spec(cell)
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
    for m in manifest["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
        # each cell it lists reports the end-to-end metric it moves
        for cell in m.get("workloads", cells):
            assert m["moves"] in {e["name"] for e in
                                  harness.cell_spec(cell)["end_to_end"]}


def test_files_found_by_name(manifest):
    for c in manifest["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("benchmark/configs/")
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(BENCH, "scenes",
                                           cfg["scene"] + ".py"))
    for w in manifest["workloads"]:
        spec = harness.cell_spec(w["name"])
        assert spec["cell"]["why"] == w["why"]
        mix = spec["cell"]["traffic_params"]
        assert mix["episode_steps"] % mix["chunk_steps"] == 0
        assert set(spec["cell"]["check"]) <= {"pos_gap", "pos_gap_q",
                                              "vel_gap", "vel_gap_q"}
        assert all(math.isfinite(v) and v > 0
                   for v in spec["cell"]["check"].values())
    for m in manifest["per_layer"]:
        path = harness.metric_path(m["name"])
        assert os.path.isfile(path)
        assert os.path.basename(path) in (m["name"] + ".py", m["name"].rsplit(
            ".", 1)[0] + ".py")


def test_configs_cover_each_cell_and_are_distinct(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
